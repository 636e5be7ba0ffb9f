"""Axis roles of a run and the FSDP parameter layout (port of the
reference ``parallel/sharding.py``: ``make_parallel_config``,
``_largest_divisible_dim``, ``param_spec``; :func:`fsdp_layout` and
:func:`param_shapes` stand for its ``param_shardings``).

On the port's process-group mesh (``launch/mesh.py``): the batch shards
over as many of ``pod`` and ``data`` as divide it (the production
multi-pod mesh has a ``pod`` axis), and the sequence
over ``model`` (the paper's P workers), or over the ``(seq, head)`` pair of
a 2D mesh (``make_seq2d_mesh``); a decode shape that leaves ``data`` idle
shards its KV cache over ``data`` too.  An MoE model's
routed experts (``wg`` / ``wu`` / ``wd`` of each MoE layer) shard their
rows over ``model``, as the reference's ``moe_apply`` declares them.

**FSDP** (ZeRO-3: parameters and optimizer moments sharded, each weight
gathered when it is used): ``pod`` and ``data`` are the FSDP axes
(``ParallelConfig.fsdp_axes``), and :func:`param_spec` is the reference's
rule — a routed-expert stack puts its expert dim on the sequence axis,
then every ≥2-D leaf splits its largest dim that the FSDP group's size
divides; 1-D leaves and leaves with no such dim stay whole.  The rule
reads the reference's tree: each leaf of a layer group stacked on a
leading layer axis (``models/transformer.to_reference_params``), so a
per-layer norm weight is 2-D there and shards, and where the rule picks
the stacked axis itself each rank owns whole layers of that leaf.
:func:`fsdp_layout` carries the rule onto the port's tree of per-layer
dicts (:class:`Shard` a leaf); ``parallel/fsdp.py`` slices, gathers and
reduces by it.  A model built with ``fsdp=True`` trains on that layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.config import ParallelConfig, ShapeSpec
from repro_torch.launch.mesh import mesh_axis_size

MOE_EXPERT_KEYS = ("wg", "wu", "wd")


def make_parallel_config(mesh, shape: ShapeSpec,
                         schedule: str = "balanced",
                         remat: str = "remat_aware") -> ParallelConfig:
    """Resolve axis roles for ``shape`` on ``mesh`` (None: one process).
    For a ``decode`` shape whose batch does not divide over ``data``
    (``long_500k``: batch 1), the idle ``data`` axis is folded into the
    cache's sequence sharding (``extra_seq_axes``).  The FSDP axes are
    ``pod`` and ``data``, those the mesh has, whether the batch shards
    over them or not."""
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
                          fsdp_axes=tuple(a for a in ("pod", "data")
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


# ---------------------------------------------------------------- FSDP

def fsdp_axes(mesh, par: ParallelConfig) -> Tuple[str, ...]:
    """``par.fsdp_axes`` that ``mesh`` has, in mesh order."""
    if mesh is None:
        return ()
    return tuple(a for a in mesh.axis_names if a in par.fsdp_axes)


def comm_over(mesh, axes):
    """The Comm over the mesh axes ``axes`` (any order: mesh order is
    used), or None when they hold one rank or there is no mesh."""
    if mesh is None:
        return None
    axes = tuple(a for a in mesh.axis_names if a in axes)
    if not axes:
        return None
    g = mesh.comm(axes)
    return g if g.size > 1 else None


def _largest_divisible_dim(shape, skip, n):
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if i in skip:
            continue
        if s % n == 0 and s > best_size:
            best, best_size = i, s
    return best


def param_spec(path: str, shape: Tuple[int, ...], par: ParallelConfig,
               fsdp_size: int) -> tuple:
    """The reference's FSDP ``PartitionSpec`` of one ≥2-D parameter, as a
    tuple: per dim None, an axis name, or a tuple of axis names.  ``path``
    is the leaf's path in the reference's tree (keys joined by ``/``) and
    ``shape`` its shape there (layer groups stacked)."""
    spec = [None] * len(shape)
    skip = set()
    if "moe" in path and path.split("/")[-1] in MOE_EXPERT_KEYS:
        # (L?, E, d, de): expert dim → seq axis
        e_dim = len(shape) - 3
        spec[e_dim] = par.seq_axis
        skip.add(e_dim)
    if fsdp_size > 1:
        i = _largest_divisible_dim(shape, skip | {j for j, s in
                                                  enumerate(shape) if
                                                  spec[j] is not None},
                                   fsdp_size)
        if i is not None and len(shape) >= 2:
            spec[i] = tuple(par.fsdp_axes) if len(par.fsdp_axes) > 1 \
                else par.fsdp_axes[0]
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one leaf of the port's tree lies over the FSDP group of ``size``
    ranks (``axes``): split into ``size`` equal blocks along ``dim`` (group
    rank r holds block r), or — ``dim`` None, where the rule picked the
    stacked layer axis — held whole by group rank ``owner`` and by no
    other (an empty tensor there).  ``shape`` is the leaf's shape when
    gathered on this rank (an expert leaf: this rank's rows)."""
    dim: Optional[int]
    axes: Tuple[str, ...]
    size: int
    shape: Tuple[int, ...]
    owner: Optional[int] = None

    def local_shape(self, rank: int) -> Tuple[int, ...]:
        """The leaf's shape on group rank ``rank``."""
        if self.dim is None:
            return self.shape if rank == self.owner else \
                (0,) + tuple(self.shape[1:])
        s = list(self.shape)
        s[self.dim] //= self.size
        return tuple(s)


# the reference tree's stacked layer groups, and its subtrees held once
LAYER_KEYS = ("layers", "dense_layers", "moe_layers", "enc_layers",
              "dec_layers")
ONCE_KEYS = ("shared", "mtp")


def _named_leaves(tree, prefix=""):
    """(path, leaf) of nested dicts, keys joined by ``/``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _unflatten(pairs):
    out = {}
    for path, x in pairs:
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def fsdp_layout(model, mesh, par: ParallelConfig) -> Optional[dict]:
    """Each leaf of ``model``'s parameter tree (its per-layer lists) as it
    lies over the FSDP axes of ``mesh``: a :class:`Shard`, or None for a
    leaf every rank holds whole.  The rule (:func:`param_spec`) reads each
    leaf's path and shape in the reference's tree, layer groups stacked.
    None when the FSDP group has one rank."""
    axes = fsdp_axes(mesh, par)
    n = 1
    for a in axes:
        n *= mesh.size(a)
    if n == 1:
        return None
    names = tuple(par.fsdp_axes)
    fsdp_value = names if len(names) > 1 else names[0]
    whole = type(model)(model.cfg, "meta", par=par).init()
    experts = getattr(model, "expert_group", None)
    e_local = 1 if experts is None else experts.size

    def local_rows(path, shape):
        # an expert leaf's rows on this rank (its sequence shard's)
        if "moe" in path and path.split("/")[-1] in MOE_EXPERT_KEYS:
            e = len(shape) - 3
            shape = shape[:e] + (shape[e] // e_local,) + shape[e + 1:]
        return shape

    def one(path, shape, stacked=None):
        """The Shard of one port leaf of ``shape``; ``stacked`` (i, L): its
        layer index and the group's layer count."""
        ref = shape if stacked is None else (stacked[1],) + shape
        if len(ref) <= 1:
            return None
        spec = param_spec(path, ref, par, n)
        if fsdp_value not in spec:
            return None
        d = spec.index(fsdp_value)
        full = local_rows(path, shape)
        if stacked is None:
            return Shard(d, axes, n, full)
        if d > 0:
            return Shard(d - 1, axes, n, full)
        i, nl = stacked
        return Shard(None, axes, n, full, owner=i // (nl // n))

    out = {}
    for key, sub in whole.items():
        if key in LAYER_KEYS:
            nl = len(sub)
            out[key] = [_unflatten(
                (path, one(f"{key}/{path}", tuple(x.shape), (i, nl)))
                for path, x in _named_leaves(lp)) for i, lp in
                enumerate(sub)]
        elif key in ONCE_KEYS:
            out[key] = _unflatten(
                (path, one(f"{key}/{path}", tuple(x.shape)))
                for path, x in _named_leaves(sub))
        else:
            out[key] = one(key, tuple(sub.shape))
    return out


def param_shapes(model, par: ParallelConfig, mesh) -> dict:
    """Each parameter's shape on one rank of ``mesh``, in ``model``'s tree
    (``model.init``'s, made on the ``meta`` device): the routed experts'
    rows ``E / S`` of the sequence group's ``S`` ranks (``models/moe.py``),
    and, for a model built with ``fsdp=True``, each leaf's FSDP shard
    (:func:`fsdp_layout`; an owned-layers leaf empty off its owner);
    every other leaf whole."""
    from repro_torch.core.tree import tree_map
    meta = type(model)(model.cfg, "meta", par=par, impl=model.impl,
                       mesh=mesh, fsdp=getattr(model, "fsdp", None)
                       is not None)
    return tree_map(lambda t: tuple(t.shape), meta.init())
