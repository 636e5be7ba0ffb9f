"""FSDP (ZeRO-3) over the ``pod`` × ``data`` axes: each rank holds its
shard of every parameter the layout shards (``parallel/sharding.
fsdp_layout``, the reference's ``param_spec`` rule) and AdamW moments
shaped like those shards; a layer's whole weights exist only while that
layer runs forward or backward, and gradients arrive at the shards summed
over the ranks that hold distinct tokens.  The reference gets the same
from GSPMD (``param_shardings`` as jit's in/out shardings); here the
gathers and reduce-scatters are explicit.

A leaf's :class:`~repro_torch.parallel.sharding.Shard` says how it lies:

  * split along ``dim`` — gathered by ``all_gather`` (differentiably:
    ``comm.gather_param``, whose backward reduce-scatters the cotangent);
  * whole layers (``dim`` None: the rule picked the stacked layer axis) —
    held by its owner alone, fetched by a broadcast from it at use, and
    its gradient all-reduced and kept by the owner.

Gradient scale: when the batch does not shard over an FSDP axis, its ranks
hold the same tokens, and the reduce-scatter's sum would count each token
once a replica; :attr:`FSDP.scale` (1 / replicas) takes that back.

:func:`shard_tree` slices a whole tree into this rank's shards and
:func:`full_tree` gathers them back (export, checkpoints, serving: the
engines run on whole weights, as the reference's do).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tree import flatten
from repro_torch.parallel.comm import gather_param
from repro_torch.parallel.sharding import comm_over


class _Fetch(torch.autograd.Function):
    """A whole-layers leaf at use: the owner's tensor broadcast to every
    rank of the group; backward: the cotangent summed over the group,
    kept (times ``scale``) by the owner, an empty one elsewhere."""

    @staticmethod
    def forward(ctx, x, comm, shard, scale):
        ctx.comm, ctx.shard, ctx.scale = comm, shard, scale
        return _fetch(x, shard, comm)

    @staticmethod
    def backward(ctx, g):
        return (_return(g, ctx.shard, ctx.comm, ctx.scale), None, None,
                None)


def _fetch(x, shard, comm):
    out = x.detach().clone() if comm.rank == shard.owner else \
        x.new_empty(shard.shape)
    comm.broadcast_([out], shard.owner)
    return out


def _return(g, shard, comm, scale):
    t = g.detach().contiguous().clone()
    comm.all_reduce_([t])
    if comm.rank != shard.owner:
        return g.new_zeros(shard.local_shape(comm.rank))
    return t * scale if scale != 1.0 else t


def _slice(x, shard, rank):
    """This rank's part of the whole leaf ``x`` (a view, or a new empty
    tensor off a whole-layers leaf's owner)."""
    if shard is None:
        return x
    if shard.dim is None:
        return x if rank == shard.owner else \
            x.new_empty(shard.local_shape(rank))
    n = x.shape[shard.dim] // shard.size
    return x.narrow(shard.dim, rank * n, n)


def gather_leaf(x, shard, comm, scale=1.0):
    """One leaf gathered on use, differentiably (module docstring)."""
    if shard is None:
        return x
    if shard.dim is None:
        return _Fetch.apply(x, comm, shard, float(scale))
    return gather_param(comm, x, shard.dim, scale)


class Gather:
    """The gathers of one subtree's leaves over ``comm`` (one layer's, in
    ``core.tree.flatten``'s order of its layout ``lay``): :meth:`full`
    and :meth:`reduce` outside autograd (``core/remat.remat_aware`` calls
    them inside its checkpointed region, so the whole weights are
    dropped after each use), :meth:`tree` inside it."""

    def __init__(self, comm, lay, scale=1.0):
        self.comm, self.lay, self.scale = comm, lay, scale
        self.shards = flatten(lay)[0]

    def sub(self, lay) -> "Gather":
        """The Gather of a part of this subtree (its layout ``lay``)."""
        return Gather(self.comm, lay, self.scale)

    @torch.no_grad()
    def full(self, shards):
        """The whole leaves of this rank's ``shards`` (no gradient)."""
        out = []
        for x, s in zip(shards, self.shards):
            x = x.detach()
            if s is None:
                out.append(x)
            elif s.dim is None:
                out.append(_fetch(x, s, self.comm))
            else:
                out.append(self.comm.all_gather(x.contiguous(), s.dim))
        return out

    @torch.no_grad()
    def reduce(self, grads):
        """The whole leaves' gradients ``grads`` (None where a leaf has
        none: every rank alike) summed over the group onto the shards."""
        out = []
        for g, s in zip(grads, self.shards):
            if g is None or s is None:
                out.append(g)
            elif s.dim is None:
                out.append(_return(g, s, self.comm, self.scale))
            else:
                r = self.comm.reduce_scatter(g.contiguous(), s.dim)
                out.append(r * self.scale if self.scale != 1.0 else r)
        return out

    def tree(self, p):
        """The subtree ``p`` gathered inside autograd (the gradients
        reach the shards through :func:`~repro_torch.parallel.comm.
        gather_param` / the owner's fetch)."""
        xs, rebuild = flatten(p)
        return rebuild([gather_leaf(x, s, self.comm, self.scale)
                        for x, s in zip(xs, self.shards)])


def _comm(mesh, layout):
    """The Comm over the FSDP axes a layout's shards name."""
    axes = next((s.axes for s in flatten(layout)[0] if s is not None), ())
    return comm_over(mesh, axes)


def shard_tree(params, layout, mesh):
    """This rank's shards (views; off a whole-layers leaf's owner, empty
    tensors) of the whole tree ``params`` under ``layout``
    (:func:`~repro_torch.parallel.sharding.fsdp_layout`, or a subtree of
    it) on ``mesh``; ``layout`` None: ``params`` itself."""
    if layout is None:
        return params
    comm = _comm(mesh, layout)
    rank = 0 if comm is None else comm.rank
    xs, rebuild = flatten(params)
    return rebuild([_slice(x, s, rank)
                    for x, s in zip(xs, flatten(layout)[0])])


def full_tree(shards, layout, mesh):
    """The whole tree of this rank's ``shards``, gathered over the FSDP
    group (every rank of it must call); leaves ``layout`` leaves whole
    are returned as they are."""
    if layout is None:
        return shards
    xs, rebuild = flatten(shards)
    return rebuild(Gather(_comm(mesh, layout), layout).full(xs))


class FSDP:
    """A model's FSDP state on this rank: ``layout`` (the parameter tree's
    :class:`~repro_torch.parallel.sharding.Shard` or None per leaf),
    ``group`` (the Comm over the FSDP axes; its rank is this rank's shard
    index) and ``scale`` (1 / the number of replicas among them that hold
    the same tokens: the FSDP axes the batch does not shard over)."""

    def __init__(self, layout, mesh, par):
        self.layout, self.mesh = layout, mesh
        self.group = comm_over(mesh, par.fsdp_axes)
        reps = math.prod(mesh.size(a) for a in mesh.axis_names
                         if a in par.fsdp_axes and a not in par.batch_axes)
        self.scale = 1.0 / reps

    @property
    def rank(self) -> int:
        return self.group.rank

    def at(self, *path):
        """The layout of the subtree at ``path``."""
        lay = self.layout
        for k in path:
            lay = lay[k]
        return lay

    def gather(self, lay) -> Gather:
        """The :class:`Gather` of the subtree whose layout is ``lay``."""
        return Gather(self.group, lay, self.scale)

    def shard(self, tree, *path):
        """This rank's shards of the whole subtree ``tree`` at ``path``:
        copies, so the whole leaves can be freed."""
        lay = self.at(*path)
        xs, rebuild = flatten(shard_tree(tree, lay, self.mesh))
        return rebuild([x.clone() if s is not None and s.dim is not None
                        else x for x, s in zip(xs, flatten(lay)[0])])

    def full(self, tree):
        """:func:`full_tree` of this rank's shards ``tree`` (the whole
        parameter tree)."""
        return full_tree(tree, self.layout, self.mesh)
