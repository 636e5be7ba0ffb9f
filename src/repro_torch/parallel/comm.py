"""Collectives over a group of ranks: the port's counterpart of the
reference's ``lax.ppermute`` (:meth:`Comm.shift`), ``lax.all_to_all``
(:meth:`Comm.all_to_all`), ``lax.all_gather`` (:meth:`Comm.all_gather`) and
``lax.psum`` / ``lax.pmax`` (:meth:`Comm.all_reduce_`) over one mesh axis or
several (a group whose ranks are ordered by the axes' linearized index),
and a broadcast from one rank (:meth:`Comm.broadcast_`).  Inside an
autograd graph, :func:`all_to_all` (backward: the inverse ``all_to_all``)
and :func:`all_reduce` (``lax.psum`` / ``lax.pmean``; backward: the
cotangent passed through, each rank keeping its own share, which the
train step's gradient sum adds up) are their differentiable forms.

Each rank is one ``torch.distributed`` process.  How tensors travel — the
transport — is decided once, from the world's backend and the device, when
the world is started (:func:`init_world`) or a group is built
(:func:`transport_of`), and printed:

  * ``nccl``        — CUDA tensors where every rank has a GPU of its own;
  * ``gloo``        — CPU tensors;
  * ``gloo-staged`` — CUDA tensors on ranks that share a GPU (NCCL refuses
                      two ranks on one device): every transfer is staged
                      through pinned host buffers and sent with gloo.

No transport is ever reached by catching another's failure.  A single
process (no world) has the transport ``local``: its groups have one rank
and move nothing.

A shift is asynchronous: :meth:`Comm.shift` issues it and returns a handle
whose ``wait()`` gives the received tensors, so a caller issues the next
step's transfer before launching this step's kernels (the paper's overlap
of KV communication with compute).  Under ``gloo`` the transfer runs on
gloo's threads; under ``nccl`` on NCCL's stream; under ``gloo-staged`` a
worker thread copies to pinned buffers on a side CUDA stream, sends and
receives with gloo, and copies back on that stream, and ``wait()`` makes
the caller's stream wait for the copy.  Shifts use a process group of
their own, so their message tags never meet the collectives'.
"""
from __future__ import annotations

import concurrent.futures
import os
import time

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo", "gloo-staged")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def choose_transport(device, world_size: int) -> str:
    """The transport a world of ``world_size`` ranks on ``device`` needs."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no transport for {device}")
    if torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo-staged"


def transport_of(device) -> str:
    """The transport of the running world for tensors on ``device``: its
    backend (``nccl`` or ``gloo``) and, under gloo, whether the tensors
    live on a GPU."""
    device = torch.device(device)
    backend = dist.get_backend()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an nccl world carries CUDA tensors, not "
                             f"{device}")
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    return "gloo" if device.type == "cpu" else "gloo-staged"


def init_world(device, *, rank=None, world_size=None,
               init_method=None) -> str:
    """Start this process's ``torch.distributed`` world with the backend its
    transport needs (see the module docstring), print the transport on rank
    0 and return it.  ``rank`` / ``world_size`` / ``init_method`` default
    to torchrun's environment.  Under ``nccl`` each rank takes GPU
    ``LOCAL_RANK``."""
    ws = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    transport = choose_transport(device, ws)
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    if rank is not None:
        kw.update(rank=int(rank), world_size=ws)
    if transport == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank or 0)))
    dist.init_process_group("nccl" if transport == "nccl" else "gloo",
                            **kw)
    if dist.get_rank() == 0:
        how = {"nccl": "one GPU each", "gloo": "on the CPU",
               "gloo-staged": f"share {torch.cuda.device_count()} GPU(s); "
                              f"transfers staged through pinned host "
                              f"buffers"}[transport]
        print(f"transport {transport}: {ws} ranks {how}", flush=True)
    return transport


class _Done:
    def __init__(self, tensors):
        self.tensors = tensors

    def wait(self):
        return self.tensors


class _Works:
    """A gloo or nccl batch of point-to-point works and its receive
    buffers."""

    def __init__(self, comm, works, outs):
        self.comm, self.works, self.outs = comm, works, outs

    def wait(self):
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.comm.shift_wait_s += time.perf_counter() - t0
        return self.outs


class _Staged:
    """A host-staged shift running on the group's worker thread."""

    def __init__(self, comm, future):
        self.comm, self.future = comm, future

    def wait(self):
        t0 = time.perf_counter()
        outs, done = self.future.result()
        self.comm.shift_wait_s += time.perf_counter() - t0
        stream = torch.cuda.current_stream(outs[0].device)
        stream.wait_event(done)
        for t in outs:
            t.record_stream(stream)
        return outs


class Comm:
    """One group of ranks (a mesh axis): ``rank`` / ``size`` inside the
    group and the collectives over it.  ``ranks`` lists the group's global
    ranks in axis order; ``group`` / ``p2p_group`` are its process groups
    for collectives and for shifts (None: the world).  ``shift_wait_s``,
    ``reduce_s`` and ``gather_s`` add up the host seconds spent blocked
    waiting for shifts, in :meth:`all_reduce_` / :meth:`broadcast_`, in
    :meth:`all_gather` and in :meth:`all_to_all` (``a2a_s``)."""

    def __init__(self, ranks, transport: str, device, group=None,
                 p2p_group=None):
        if transport not in TRANSPORTS + ("local",):
            raise ValueError(f"unknown transport {transport!r}")
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        if transport == "local" and self.size != 1:
            raise ValueError("the local transport serves one rank")
        self.rank = self.ranks.index(dist.get_rank()) if self.size > 1 \
            else 0
        self.transport = transport
        self.device = torch.device(device)
        self.group, self.p2p_group = group, p2p_group
        self._tag = 0
        self.shift_wait_s = self.reduce_s = self.gather_s = 0.0
        self.a2a_s = 0.0
        self._pool = self._side = None
        if transport == "gloo-staged":
            self._pool = concurrent.futures.ThreadPoolExecutor(1)
            self._side = torch.cuda.Stream(self.device)

    # ---------------------------------------------------------- shifts
    def shift(self, tensors, hops: int):
        """Issue a shift: rank p receives the tensors of rank
        (p − hops) mod size.  Returns a handle; its ``wait()`` returns the
        received tensors (the inputs themselves when hops ≡ 0)."""
        tensors = [t.contiguous() for t in tensors]
        h = hops % self.size
        if h == 0:
            return _Done(tensors)
        dst = self.ranks[(self.rank + h) % self.size]
        src = self.ranks[(self.rank - h) % self.size]
        self._tag += 1
        if self.transport == "gloo-staged":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            return _Staged(self, self._pool.submit(
                self._staged, tensors, ready, src, dst, self._tag))
        outs = [torch.empty_like(t) for t in tensors]
        return _Works(self, self._p2p(tensors, outs, src, dst, self._tag),
                      outs)

    def _p2p(self, sends, recvs, src, dst, tag):
        ops = [dist.P2POp(dist.isend, t, dst, self.p2p_group, tag)
               for t in sends]
        ops += [dist.P2POp(dist.irecv, t, src, self.p2p_group, tag)
                for t in recvs]
        return dist.batch_isend_irecv(ops)

    def _staged(self, tensors, ready, src, dst, tag):
        """Worker thread: device → pinned host → gloo → device, on the side
        stream.  Returns the received tensors and an event after their
        copy."""
        with torch.cuda.stream(self._side):
            self._side.wait_event(ready)
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
            for hb, t in zip(host, tensors):
                hb.copy_(t, non_blocking=True)
            self._side.synchronize()
            recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
            for w in self._p2p(host, recv, src, dst, tag):
                w.wait()
            outs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                    for t in tensors]
            for o, hb in zip(outs, recv):
                o.copy_(hb, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
            self._side.synchronize()
        return outs, done

    # ----------------------------------------------------- collectives
    def _host(self, x):
        return x.cpu() if self.transport == "gloo-staged" else x

    def _back(self, x):
        return x.to(self.device) if self.transport == "gloo-staged" else x

    def all_to_all(self, x, split_dim: int, concat_dim: int):
        """Split ``x`` into ``size`` parts along ``split_dim``, send part j
        to rank j, and concatenate the parts received along
        ``concat_dim`` in rank order (``lax.all_to_all(..., tiled=True)``)."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        # one buffer of the parts, for all_to_all_single (gloo has no
        # list form)
        parts = self._host(torch.stack(x.chunk(self.size, dim=split_dim)))
        outs = torch.empty_like(parts)
        dist.all_to_all_single(outs, parts, group=self.group)
        out = self._back(torch.cat(outs.unbind(0), dim=concat_dim))
        self.a2a_s += time.perf_counter() - t0
        return out

    def all_gather(self, x, dim: int):
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        xs = self._host(x).contiguous()
        outs = [torch.empty_like(xs) for _ in range(self.size)]
        dist.all_gather(outs, xs, group=self.group)
        out = self._back(torch.cat(outs, dim=dim))
        self.gather_s += time.perf_counter() - t0
        return out

    def all_reduce_(self, tensors, op: str = "sum"):
        """Reduce each tensor over the group in place: ``op`` ``"sum"``
        (``lax.psum``) or ``"max"`` (``lax.pmax``)."""
        if self.size == 1:
            return tensors
        rop = _OPS[op]
        t0 = time.perf_counter()
        works = []
        staged = []
        for t in tensors:
            h = self._host(t)
            staged.append(h)
            works.append(dist.all_reduce(h, op=rop, group=self.group,
                                         async_op=True))
        for w in works:
            w.wait()
        if self.transport == "gloo-staged":
            for t, h in zip(tensors, staged):
                t.copy_(h)
        self.reduce_s += time.perf_counter() - t0
        return tensors

    def broadcast_(self, tensors, root: int):
        """Copy each tensor of group rank ``root`` to every rank, in
        place."""
        if self.size == 1:
            return tensors
        t0 = time.perf_counter()
        for t in tensors:
            h = self._host(t)
            dist.broadcast(h, self.ranks[root], group=self.group)
            if h is not t:
                t.copy_(h)
        self.reduce_s += time.perf_counter() - t0
        return tensors


# ------------------------------------------------- differentiable forms

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.comm, ctx.dims = comm, (split_dim, concat_dim)
        return comm.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.comm.all_to_all(g.contiguous(), concat_dim, split_dim),
                None, None, None)


def all_to_all(comm, x, split_dim: int, concat_dim: int):
    """:meth:`Comm.all_to_all` inside an autograd graph: its backward is
    the inverse ``all_to_all`` (split and concat dims swapped).  ``comm``
    None or of one rank: ``x`` itself."""
    if comm is None or comm.size == 1:
        return x
    return _AllToAll.apply(x, comm, split_dim, concat_dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, mean):
        ctx.scale = 1.0 / comm.size if mean else 1.0
        y = x.detach().clone()
        comm.all_reduce_([y])
        return y * ctx.scale if mean else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


def all_reduce(comm, x, op: str = "sum"):
    """``lax.psum`` (``op="sum"``) or ``lax.pmean`` (``"mean"``) of ``x``
    over ``comm`` inside an autograd graph.  Every rank computes the same
    value from it; its backward passes the cotangent through (scaled by
    1/size for the mean) without reducing it again, so each rank's
    gradient is its own share of the global one, and the train step's sum
    of gradients over the ranks adds the shares up (a backward that
    all-reduced would count them ``size`` times).  ``comm`` None or of one
    rank: ``x`` itself."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown op {op!r}")
    if comm is None or comm.size == 1:
        return x
    return _AllReduce.apply(x, comm, op == "mean")
