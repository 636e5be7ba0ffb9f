"""Process-group meshes (port of the reference ``launch/mesh.py``).

The reference lays devices out as a ``(data, model)`` grid of a
``jax.sharding.Mesh``; here each rank is one ``torch.distributed`` process
and :func:`make_local_mesh` builds the same grid over the running world:
global rank ``r`` sits at ``(r // seq, r % seq)`` (model minor, as
``jax.make_mesh`` orders devices), and each axis gets a
:class:`~repro_torch.parallel.comm.Comm` over the ranks that differ only
along it.  ``model`` is the sequence-parallel axis (the paper's P
workers), ``data`` the batch axis.  Without a world (one process) every
axis has size 1 and the transport is ``local``.  :meth:`Mesh.comm` names
the group of several axes (``("data", "model")``: the world, ranks in
the reference's linearized order).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch.distributed as dist

from repro_torch.parallel import comm as cm


@dataclasses.dataclass
class Mesh:
    """This rank's view of the grid: axis names and sizes, its coordinate
    on each axis, one :class:`~repro_torch.parallel.comm.Comm` per axis and
    one over the whole world, and the world's transport."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    comms: Dict[str, cm.Comm]
    world: cm.Comm
    transport: str

    def size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coord(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def comm(self, axes) -> cm.Comm:
        """The Comm over mesh axes ``axes`` (a name or a tuple of names,
        major first): its rank is the rank's linearized index over them,
        as the reference's ``idx = idx * size(ax) + axis_index(ax)``.
        One axis is ``comms[axis]``; every axis in mesh order is the
        world."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.comms[axes[0]]
        if axes == tuple(self.axis_names):
            return self.world
        raise ValueError(f"no group over axes {axes} of a mesh "
                         f"{self.axis_names}")


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


def make_local_mesh(seq: int = 1, data: int | None = None,
                    device="cuda") -> Mesh:
    """A ``(data, model)`` mesh of ``data × seq`` ranks over the running
    world (``data`` defaults to world size // seq).  Tensors on
    ``device`` travel by the transport :func:`~repro_torch.parallel.comm.
    transport_of` decides once here."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // seq
    if data * seq != n:
        raise ValueError(f"mesh (data={data}, model={seq}) needs "
                         f"{data * seq} ranks, the world has {n}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    transport = cm.transport_of(device) if n > 1 else "local"
    comms = {"model": None, "data": None}
    for d in range(data):
        c = _comm([d * seq + s for s in range(seq)], transport, device)
        comms["model"] = comms["model"] or c
    for s in range(seq):
        c = _comm([d * seq + s for d in range(data)], transport, device)
        comms["data"] = comms["data"] or c
    world = _comm(list(range(n)), transport, device)
    return Mesh(axis_names=("data", "model"), shape=(data, seq),
                coords=divmod(rank, seq), comms=comms, world=world,
                transport=transport)
