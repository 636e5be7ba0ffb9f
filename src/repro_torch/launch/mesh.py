"""Process-group meshes (port of the reference ``launch/mesh.py``).

The reference lays devices out as a grid of a ``jax.sharding.Mesh``; here
each rank is one ``torch.distributed`` process and the same grid is built
over the running world, the last axis minor, as ``jax.make_mesh`` orders
devices.  :func:`make_local_mesh` is the ``(data, model)`` grid: global
rank ``r`` sits at ``(r // seq, r % seq)``; ``model`` is the
sequence-parallel axis (the paper's P workers), ``data`` the batch axis.
:func:`make_seq2d_mesh` is the factored ``(data, seq, head)`` grid of the
2D sequence × head plans: global rank ``(d·r + s)·u + h``.  Each axis gets
a :class:`~repro_torch.parallel.comm.Comm` over the ranks that differ only
along it, and every other set of two or more axes, in mesh order, a Comm
over the ranks that differ only along those (:meth:`Mesh.comm`:
``("seq", "head")`` is the sequence group of a 2D mesh, every axis the
world; ranks in the reference's linearized order).  The groups are built
when the mesh is, in the same order on every rank (``dist.new_group`` is
collective).  Without a world (one process) every axis has size 1 and the
transport is ``local``.

:func:`make_production_mesh` is the reference's production grid, (data 16,
model 16) or (pod 2, data 16, model 16), as one rank's view over the
``meta`` transport (:func:`make_meta_mesh`): the same fields, Comms of the
production sizes that move no data and count what they would move
(``parallel.comm.MetaComm``), for the dry-run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.parallel import comm as cm


@dataclasses.dataclass
class Mesh:
    """This rank's view of the grid: axis names and sizes, its coordinate
    on each axis, a :class:`~repro_torch.parallel.comm.Comm` per axis (keyed
    by name) and per larger set of axes in mesh order (keyed by the tuple),
    one over the whole world, and the world's transport."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    comms: Dict[object, cm.Comm]
    world: cm.Comm
    transport: str

    def size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coord(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def comm(self, axes) -> cm.Comm:
        """The Comm over mesh axes ``axes`` (a name, or a tuple of names in
        mesh order, major first): its rank is the rank's linearized index
        over them, as the reference's ``idx = idx * size(ax) +
        axis_index(ax)``.  Every axis is the world."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == tuple(self.axis_names):
            return self.world
        if len(axes) == 1:
            return self.comms[axes[0]]
        if axes not in self.comms:
            raise ValueError(f"no group over axes {axes} of a mesh "
                             f"{self.axis_names}: name mesh axes in mesh "
                             f"order")
        return self.comms[axes]


# the CLIs' ``--mesh``: ``local`` puts ``--seq-shards`` ranks on ``model``
# and the rest of the world on ``data``; ``production`` is the reference's
# 16 × 16 grid
MESHES = {"local": None, "production": (16, 16)}


def named_mesh(name: str, seq: int = 1, device="cuda") -> "Mesh":
    """The mesh ``--mesh name`` selects (``seq``: ``local``'s model axis)."""
    if MESHES[name] is None:
        return make_local_mesh(seq=seq, device=device)
    data, seq = MESHES[name]
    return make_local_mesh(seq=seq, data=data, device=device)


def mesh_axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh.size(name)


def _comm(ranks, transport, device):
    """A Comm over ``ranks``; every rank of the world must call this for
    every group, in the same order (``dist.new_group`` is collective)."""
    if len(ranks) == 1:
        me = dist.get_rank() if dist.is_initialized() else 0
        return cm.Comm([me], transport, device) if me in ranks else None
    group = dist.new_group(ranks)
    p2p = dist.new_group(ranks)
    if dist.get_rank() not in ranks:
        return None
    return cm.Comm(ranks, transport, device, group=group, p2p_group=p2p)


def _make_mesh(names, shape, device, transport=None) -> Mesh:
    """The grid ``shape`` of axes ``names`` (last minor) over the running
    world, with a Comm for each axis and each larger set of axes in mesh
    order (the world last).  ``transport`` None: the world's
    (:func:`~repro_torch.parallel.comm.transport_of`); ``"gloo-staged"``
    may be named for CUDA tensors of ranks that share a GPU."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{int(np.prod(shape))} ranks, the world has {n}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    transport = "local" if n == 1 else _transport(device, transport)
    grid = np.arange(n).reshape(shape)
    comms = {}
    for sub in _subsets(len(names)):
        rest = [i for i in range(len(names)) if i not in sub]
        groups = np.transpose(grid, rest + list(sub)).reshape(
            -1, int(np.prod([shape[i] for i in sub])))
        key = names[sub[0]] if len(sub) == 1 else tuple(names[i]
                                                         for i in sub)
        comms[key] = None
        for ranks in groups:
            c = _comm([int(r) for r in ranks], transport, device)
            comms[key] = comms[key] or c
    world = _comm(list(range(n)), transport, device)
    coords = tuple(int(x) for x in np.unravel_index(rank, shape))
    return Mesh(axis_names=tuple(names), shape=tuple(shape), coords=coords,
                comms=comms, world=world, transport=transport)


def _transport(device, named):
    auto = cm.transport_of(device)
    if named is None or named == auto:
        return auto
    if named == "gloo-staged" and auto == "cuda-ipc":
        return named
    raise ValueError(f"transport {named!r} does not carry {device} tensors "
                     f"in this world (its transport is {auto!r})")


def _subsets(n: int):
    """The axis sets a mesh has a Comm for, by index: one axis at a time,
    minor first, then the sets of two or more axes short of the world."""
    subsets = [(i,) for i in reversed(range(n))]
    return subsets + [c for k in range(2, n)
                      for c in itertools.combinations(range(n), k)]


def make_meta_mesh(names, shape, *, rank: int = 0, device="meta") -> Mesh:
    """Global rank ``rank``'s view of the grid ``shape`` of axes ``names``
    (last minor) with no world behind it: a :class:`~repro_torch.parallel.
    comm.MetaComm` for each axis and each larger set of axes, as
    :func:`_make_mesh` builds them, all counting into one
    :class:`~repro_torch.parallel.comm.CommCounts` (``mesh.world.counts``);
    transport ``meta``."""
    shape = tuple(int(x) for x in shape)
    n = int(np.prod(shape))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not in a mesh of {n} ranks")
    grid = np.arange(n).reshape(shape)
    coords = tuple(int(x) for x in np.unravel_index(rank, shape))
    counts = cm.CommCounts()
    comms = {}
    for sub in _subsets(len(names)):
        idx = tuple(slice(None) if i in sub else coords[i]
                    for i in range(len(names)))
        ranks = [int(r) for r in grid[idx].reshape(-1)]
        key = names[sub[0]] if len(sub) == 1 else tuple(names[i]
                                                         for i in sub)
        comms[key] = cm.MetaComm(ranks, rank, counts, device)
    world = cm.MetaComm(list(range(n)), rank, counts, device)
    return Mesh(axis_names=tuple(names), shape=shape, coords=coords,
                comms=comms, world=world, transport="meta")


def make_production_mesh(multi_pod: bool = False, *, rank: int = 0,
                         device="meta") -> Mesh:
    """The reference's production mesh as rank ``rank``'s meta view:
    (data 16, model 16) = 256 ranks, or (pod 2, data 16, model 16) = 512
    with ``multi_pod``; ``model`` is the sequence-parallel axis."""
    if multi_pod:
        return make_meta_mesh(("pod", "data", "model"), (2, 16, 16),
                              rank=rank, device=device)
    return make_meta_mesh(("data", "model"), (16, 16), rank=rank,
                          device=device)


def make_local_mesh(seq: int = 1, data: int | None = None,
                    device="cuda", transport=None) -> Mesh:
    """A ``(data, model)`` mesh of ``data × seq`` ranks over the running
    world (``data`` defaults to world size // seq).  Tensors on
    ``device`` travel by the transport :func:`~repro_torch.parallel.comm.
    transport_of` decides once here, or by ``transport`` where a caller
    names ``"gloo-staged"`` for ranks that share a GPU."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // seq
    if data * seq != n:
        raise ValueError(f"mesh (data={data}, model={seq}) needs "
                         f"{data * seq} ranks, the world has {n}")
    return _make_mesh(("data", "model"), (data, seq), device, transport)


def make_seq2d_mesh(r: int, u: int, data: int = 1, *, device,
                    transport=None) -> Mesh:
    """The factored sequence × head mesh of the 2D plans: ``r·u``
    sequence-parallel ranks as a (``seq`` = r) × (``head`` = u) grid, head
    minor (the head all-to-all stays inside a group of neighbours), times
    ``data``.  Activations shard the sequence over the ``("seq",
    "head")`` pair; ``parallel.sharding.make_parallel_config`` picks the
    axes up by name.  ``transport`` as :func:`make_local_mesh`'s."""
    return _make_mesh(("data", "seq", "head"), (data, r, u), device,
                      transport)
