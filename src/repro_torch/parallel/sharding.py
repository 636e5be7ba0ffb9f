"""Axis roles of a run (port of the reference ``parallel/sharding.py``'s
``make_parallel_config``).

On the port's process-group mesh (``launch/mesh.py``): the batch shards
over as many of ``pod`` and ``data`` as divide it (the production
multi-pod mesh has a ``pod`` axis), and the sequence
over ``model`` (the paper's P workers), or over the ``(seq, head)`` pair of
a 2D mesh (``make_seq2d_mesh``); a decode shape that leaves ``data`` idle
shards its KV cache over ``data`` too.  An MoE model's
routed experts (``wg`` / ``wu`` / ``wd`` of each MoE layer) shard over
``model``, as the reference's ``moe_apply`` declares them; every other
parameter is replicated (the reference's FSDP layout is not ported):
:func:`param_shapes` gives each leaf's shape on a rank, the counterpart of
the reference's ``param_shardings``.
"""
from __future__ import annotations

from repro_torch.core.config import ParallelConfig, ShapeSpec
from repro_torch.launch.mesh import mesh_axis_size


def make_parallel_config(mesh, shape: ShapeSpec,
                         schedule: str = "balanced",
                         remat: str = "remat_aware") -> ParallelConfig:
    """Resolve axis roles for ``shape`` on ``mesh`` (None: one process).
    For a ``decode`` shape whose batch does not divide over ``data``
    (``long_500k``: batch 1), the idle ``data`` axis is folded into the
    cache's sequence sharding (``extra_seq_axes``)."""
    names = ("data", "model") if mesh is None else mesh.axis_names
    batch_axes, extra_seq = [], []
    b = shape.global_batch
    for ax in ("pod", "data"):
        if ax not in names:
            continue
        n = mesh_axis_size(mesh, ax)
        if b % n == 0 and b >= n:
            batch_axes.append(ax)
            b //= n
        elif shape.kind == "decode" and ax == "data":
            extra_seq.append(ax)
    # a 2D (seq × head) mesh names its sequence sub-axis "seq" and
    # exposes "head" for the head scatter; the 1D mesh has "model"
    return ParallelConfig(batch_axes=tuple(batch_axes),
                          seq_axis="seq" if "seq" in names else "model",
                          extra_seq_axes=tuple(extra_seq),
                          fsdp_axes=tuple(a for a in ("data",)
                                          if a in names),
                          schedule=schedule, remat=remat,
                          head_axis="head" if "head" in names else None)


def batch_group(mesh, par: ParallelConfig):
    """The Comm over the axes the batch shards over (``par.batch_axes``,
    in mesh order), or None when it has one rank or there is no mesh; its
    rank is the rank's batch shard index."""
    if mesh is None or not par.batch_axes:
        return None
    axes = tuple(a for a in mesh.axis_names if a in par.batch_axes)
    g = mesh.comm(axes)
    return g if g.size > 1 else None


def seq_group(mesh, par: ParallelConfig):
    """The Comm over the ranks a sequence shards over: ``seq_axis``, and a
    2D mesh's ``head_axis`` (seq major); its rank is the rank's shard
    index.  None without a mesh."""
    if mesh is None:
        return None
    return mesh.comm((par.seq_axis,) + ((par.head_axis,) if par.head_axis
                                        else ()))


def param_shapes(model, par: ParallelConfig, mesh) -> dict:
    """Each parameter's shape on one rank of ``mesh``, in ``model``'s tree
    (``model.init``'s, made on the ``meta`` device): the routed experts'
    rows ``E / S`` of the sequence group's ``S`` ranks (``models/moe.py``),
    every other leaf whole."""
    from repro_torch.core.tree import tree_map
    meta = type(model)(model.cfg, "meta", par=par, impl=model.impl,
                       mesh=mesh)
    return tree_map(lambda t: tuple(t.shape), meta.init())
