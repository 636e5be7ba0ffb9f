"""Collectives over a group of ranks: the port's counterpart of the
reference's ``lax.ppermute`` (:meth:`Comm.shift`), ``lax.all_to_all``
(:meth:`Comm.all_to_all`), ``lax.all_gather`` (:meth:`Comm.all_gather`) and
``lax.psum`` / ``lax.pmax`` (:meth:`Comm.all_reduce_`) over one mesh axis or
several (a group whose ranks are ordered by the axes' linearized index),
a broadcast from one rank (:meth:`Comm.broadcast_`) and a reduce-scatter
(:meth:`Comm.reduce_scatter`, ``lax.psum_scatter``: summed in rank order,
in float32 for 16-bit tensors, then each rank keeps its block).  Inside an
autograd graph, :func:`all_to_all` (backward: the inverse ``all_to_all``),
:func:`all_reduce` (``lax.psum`` / ``lax.pmean``; backward: the
cotangent passed through, each rank keeping its own share, which the
train step's gradient sum adds up), :func:`gather_rows` (an all-gather
whose backward keeps this rank's piece), :func:`shift` (``lax.ppermute``
by a fixed hop; backward: the opposite shift) and :func:`gather_param`
(FSDP's gather of a parameter's shards; backward: the cotangent
reduce-scattered back to the shards) are their differentiable forms;
:func:`gather_param_ref` is the gather's plain version.

Each rank is one ``torch.distributed`` process.  How tensors travel — the
transport — is decided once, from the world's backend and the device, when
the world is started (:func:`init_world`) or a group is built
(:func:`transport_of`), and printed:

  * ``nccl``        — CUDA tensors where every rank has a GPU of its own;
  * ``gloo``        — CPU tensors;
  * ``cuda-ipc``    — CUDA tensors on ranks that share a GPU (NCCL refuses
                      two ranks on one device): every transfer moves
                      device to device through mailboxes the ranks export
                      to each other with CUDA IPC, and a doorbell in
                      shared host memory says when a mailbox is full and
                      when it is free again;
  * ``gloo-staged`` — the same ranks, every transfer staged through pinned
                      host buffers and sent with gloo.  Only a caller that
                      names it gets it (``make_local_mesh(...,
                      transport="gloo-staged")``).

No transport is ever reached by catching another's failure: a mailbox
that cannot be exported or opened raises.  The dry-run's meshes
(``launch/mesh.make_production_mesh``) carry :class:`MetaComm` instead:
one rank's view of a group with no process behind it, whose collectives
return tensors of the right shape, move nothing and count the bytes they
would have moved (:class:`CommCounts`).

**The mailboxes** (``cuda-ipc``).  Each :class:`Comm` has two, made at
first use: one for its collectives (main thread) and one for its shifts
(worker thread).  A mailbox is a device buffer of two slots of up to
:data:`MAILBOX_CAP` bytes each; it grows (never shrinks) to the largest
message it has carried, the new handles exchanged with
``all_gather_object`` over the Comm's process group, and a larger message
goes in pieces of a slot each.  One piece is one round: the sender copies
into its slot, synchronises its stream and rings its doorbell (a counter
in a page of host memory the group's ranks share); each peer, once the
senders it reads have rung the round, copies what it needs out of their
slots.  Rounds alternate between the two slots, so a slot is written
again only two rounds later: a collective's slot once every reader has
rung the next round (it rings only after its stream has finished the
reads), a shift's once its reader has rung that it is done.  The
doorbells replace gloo tokens, whose round trip between four ranks
sharing one card's host is milliseconds (``PERF.md`` §5).  Shifts,
all-to-alls, all-gathers and broadcasts are bitwise the transfers
``gloo-staged`` makes; :meth:`Comm.all_reduce_` sums the ranks' slots in
rank order, in float32 (float64 for float64 tensors, int64 for
integers), on every rank, so the ranks hold bitwise equal results.

A shift is asynchronous: :meth:`Comm.shift` issues it and returns a handle
whose ``wait()`` gives the received tensors, so a caller issues the next
step's transfer before launching this step's kernels (the paper's overlap
of KV communication with compute).  Under ``gloo`` the transfer runs on
gloo's threads; under ``nccl`` on NCCL's stream; under ``gloo-staged`` a
worker thread copies to pinned buffers on a side CUDA stream, sends and
receives with gloo, and copies back on that stream, and ``wait()`` makes
the caller's stream wait for the copy; under ``cuda-ipc`` the same worker
thread and side stream carry it through the shift mailbox.  Shifts use a
process group of their own, so their message tags never meet the
collectives'.
"""
from __future__ import annotations

import concurrent.futures
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo", "cuda-ipc", "gloo-staged")
# the bytes a mailbox slot holds at most.  Phase 16 of chip_smoke.py (four
# ranks serving deepseek-v2-lite-16b on one card) all-to-alls 126 MB a
# rank and has little memory to spare: at 32 MiB a slot such a message
# goes in 4 pieces, and a Comm's two mailboxes hold at most 128 MiB
MAILBOX_CAP = 32 << 20
_ALIGN = 256            # bytes: every piece and segment starts aligned
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
    return "cuda-ipc"


def transport_of(device) -> str:
    """The transport of the running world for tensors on ``device``: its
    backend (``nccl`` or ``gloo``) and, under gloo, whether the tensors
    live on a GPU (``cuda-ipc``: the ranks share it)."""
    device = torch.device(device)
    backend = dist.get_backend()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an nccl world carries CUDA tensors, not "
                             f"{device}")
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    return "gloo" if device.type == "cpu" else "cuda-ipc"


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
               "cuda-ipc": f"share {torch.cuda.device_count()} GPU(s); "
                           f"transfers device to device through CUDA IPC "
                           f"mailboxes"}[transport]
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
    """A shift running on the group's worker thread (``gloo-staged`` or
    ``cuda-ipc``)."""

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


def _bytes(t):
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _rounds(sizes, cap):
    """Pack messages of ``sizes`` bytes into rounds of at most ``cap``
    bytes: a list of rounds, each a list of (message, byte lo, byte hi,
    offset in the slot); a message larger than ``cap`` is cut into pieces
    (aligned cuts), each piece its own round."""
    out, cur, used = [], [], 0
    for i, n in enumerate(sizes):
        lo = 0
        while lo < n:
            take = min(n - lo, cap)
            if cur and used + _up(take) > cap:
                out.append(cur)
                cur, used = [], 0
            cur.append((i, lo, lo + take, used))
            used += _up(take)
            lo += take
    if cur:
        out.append(cur)
    return out


class _Mailbox:
    """This rank's exported device buffer of two slots, every group rank's
    slots opened through CUDA IPC (its own for itself), and the group's
    doorbell: a row of host memory per rank, shared by the ranks (a file
    mapped by each, unlinked once mapped), holding its round counter
    (``READY``), the bytes of its last two rounds (``SIZE`` + parity) and,
    for shifts, how many pieces it has finished reading (``DONE``).
    ``ensure(n)`` grows the slots to hold ``n`` bytes — a collective over
    ``group``: every rank grows at the same round, since every rank
    carries the same sizes."""

    READY, SIZE, DONE = 0, 1, 3

    def __init__(self, comm, group):
        self.comm, self.group = comm, group
        self.slot_bytes = 0
        self.slots = None          # per group rank: uint8 (2, slot_bytes)
        self.bell = None           # int64 (size, 8): a row per group rank
        self.n = 0                 # rounds so far: slot n % 2 is next

    def ensure(self, nbytes: int):
        if nbytes <= self.slot_bytes:
            return
        from torch.multiprocessing.reductions import reduce_tensor
        c = self.comm
        size = min(MAILBOX_CAP, max(1 << 20, 1 << (nbytes - 1).bit_length()))
        # the old slots are read by nobody once every rank is here
        torch.cuda.current_stream(c.device).synchronize()
        mine = torch.empty((2, size), dtype=torch.uint8, device=c.device)
        path = None
        if self.bell is None and c.rank == 0:
            fd, path = tempfile.mkstemp(prefix="doorbell-")
            os.write(fd, bytes(8 * 8 * c.size))
            os.close(fd)
        got = [None] * c.size
        dist.all_gather_object(got, (reduce_tensor(mine), path),
                               group=self.group)
        slots = []
        for i, ((rebuild, args), _) in enumerate(got):
            if i == c.rank:
                slots.append(mine)
                continue
            t = rebuild(*args)
            if t.device != mine.device or t.numel() != mine.numel():
                raise RuntimeError(f"rank {c.ranks[i]}'s mailbox opened as "
                                   f"{tuple(t.shape)} on {t.device}")
            slots.append(t)
        self.slots, self.slot_bytes = slots, size
        if self.bell is None:
            self.bell = np.memmap(got[0][1], dtype=np.int64, mode="r+",
                                  shape=(c.size, 8))
            dist.barrier(group=self.group)      # every rank has mapped it
            if path is not None:
                os.unlink(path)

    def slot(self, i: int, s: int):
        """Group rank ``i``'s slot ``s`` (bytes)."""
        return self.slots[i][s]

    def ring(self, n: int, nbytes: int):
        """This rank's round ``n`` (counted from 1) of ``nbytes`` is in its
        slot."""
        row = self.bell[self.comm.rank]
        row[self.SIZE + n % 2] = nbytes
        row[self.READY] = n

    def wait(self, ranks, n: int, nbytes: int, col=READY):
        """Until every group rank of ``ranks`` has rung round ``n``
        (``col=DONE``: has read piece ``n``); a rung round must carry this
        rank's ``nbytes``."""
        b = self.bell
        _spin(lambda: all(b[i, col] >= n for i in ranks),
              f"rank {self.comm.ranks[self.comm.rank]} waited for group "
              f"ranks {list(ranks)} at round {n}")
        if col == self.READY:
            got = [int(b[i, self.SIZE + n % 2]) for i in ranks]
            if any(x != nbytes for x in got):
                raise RuntimeError(f"round {n} of {nbytes} bytes: the "
                                   f"ranks {list(ranks)} sent {got}")


WAIT_LIMIT_S = 600.0     # a peer that never rings is a fault, not a wait


def _spin(ready, what):
    """Poll ``ready()``: a few quick tries, then yielding the GIL (the
    shift worker and the main thread both wait here), then 50 µs naps."""
    i, t0 = 0, None
    while not ready():
        i += 1
        if i < 64:
            continue
        if t0 is None:
            t0 = time.perf_counter()
        time.sleep(0 if i < 4096 else 5e-5)
        if i % 1024 == 0 and time.perf_counter() - t0 > WAIT_LIMIT_S:
            raise RuntimeError(f"{what}: no answer in {WAIT_LIMIT_S:.0f} s")


class Comm:
    """One group of ranks (a mesh axis): ``rank`` / ``size`` inside the
    group and the collectives over it.  ``ranks`` lists the group's global
    ranks in axis order; ``group`` / ``p2p_group`` are its process groups
    for collectives and for shifts (None: the world).  ``shift_wait_s``,
    ``reduce_s`` and ``gather_s`` add up the host seconds spent blocked
    waiting for shifts, in :meth:`all_reduce_` / :meth:`broadcast_`, in
    :meth:`all_gather`, in :meth:`all_to_all` (``a2a_s``) and in
    :meth:`reduce_scatter` (``scatter_s``)."""

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
        self.a2a_s = self.scatter_s = 0.0
        self._pool = self._side = None
        if transport in ("gloo-staged", "cuda-ipc"):
            self._pool = concurrent.futures.ThreadPoolExecutor(1)
            self._side = torch.cuda.Stream(self.device)
        self._box = self._p2p_box = None
        self._readers = [None, None]       # a shift slot's last reader
        if transport == "cuda-ipc" and self.size > 1:
            self._box = _Mailbox(self, group)
            self._p2p_box = _Mailbox(self, p2p_group)

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
        if self._pool is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            work = self._ipc_shift if self._box else self._staged
            return _Staged(self, self._pool.submit(
                work, tensors, ready, src, dst, self._tag))
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

    def _ipc_shift(self, tensors, ready, src, dst, tag):
        """Worker thread: a shift through the shift mailbox, on the side
        stream, piece by piece: once slot m % 2's last reader has rung
        that it is done, copy in and ring; once ``src`` has rung piece m,
        copy out of its slot and ring that this rank is done.  Returns the
        received tensors and an event after their copy."""
        box = self._p2p_box
        i_src, i_dst = self.ranks.index(src), self.ranks.index(dst)
        with torch.cuda.stream(self._side):
            self._side.wait_event(ready)
            outs = [torch.empty_like(t) for t in tensors]
            ins = [_bytes(t) for t in tensors]
            got = [_bytes(t) for t in outs]
            for rnd in _rounds([b.numel() for b in ins], MAILBOX_CAP):
                need = rnd[-1][3] + rnd[-1][2] - rnd[-1][1]
                box.ensure(need)
                s = box.n % 2
                box.n += 1
                m = box.n
                if m > 2:                # slot s's reader of piece m - 2
                    box.wait([self._readers[s]], m - 2, 0, col=box.DONE)
                self._readers[s] = i_dst
                mine = box.slot(self.rank, s)
                for i, lo, hi, off in rnd:
                    mine[off:off + hi - lo].copy_(ins[i][lo:hi])
                self._side.synchronize()
                box.ring(m, need)
                box.wait([i_src], m, need)
                theirs = self._peer_slot(box, i_src, s)
                for i, lo, hi, off in rnd:
                    got[i][lo:hi].copy_(theirs[off:off + hi - lo])
                self._side.synchronize()
                box.bell[self.rank, box.DONE] = m
            done = torch.cuda.Event()
            done.record(self._side)
        return outs, done

    def _peer_slot(self, box, i, s):
        """Group rank ``i``'s slot ``s`` of ``box``, as this rank reads
        it."""
        return box.slot(i, s)

    # ----------------------------------------------------- collectives
    def _round(self, need: int, write, read):
        """One round through the collective mailbox: ``write(slot)``
        enqueues this rank's bytes into its slot; once every rank has rung
        the round, ``read(slots)`` enqueues the reads from the group ranks'
        slots (rank order).  The stream sync before the ring also covers
        this rank's reads of the round before, which frees that round's
        slot for its writer."""
        box = self._box
        box.ensure(need)
        s = box.n % 2
        box.n += 1
        write(box.slot(self.rank, s))
        torch.cuda.current_stream(self.device).synchronize()
        box.ring(box.n, need)
        box.wait(range(self.size), box.n, need)
        read([self._peer_slot(box, i, s) for i in range(self.size)])

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
        if self._box is None:
            dist.all_to_all_single(outs, parts, group=self.group)
        else:
            self._ipc_all_to_all(parts, outs)
        out = self._back(torch.cat(outs.unbind(0), dim=concat_dim))
        self.a2a_s += time.perf_counter() - t0
        return out

    def _ipc_all_to_all(self, parts, outs):
        S, me = self.size, self.rank
        pb, ob = parts.view(S, -1).view(torch.uint8), \
            outs.view(S, -1).view(torch.uint8)
        L = pb.shape[1]
        step = max(_ALIGN, MAILBOX_CAP // S // _ALIGN * _ALIGN)
        for lo in range(0, L, step):
            n = min(step, L - lo)
            w = _up(n)

            def write(slot, lo=lo, n=n, w=w):
                slot[:S * w].view(S, w)[:, :n].copy_(pb[:, lo:lo + n])

            def read(slots, lo=lo, n=n, w=w):
                for i, sl in enumerate(slots):
                    ob[i, lo:lo + n].copy_(sl[me * w:me * w + n])
            self._round(S * w, write, read)

    def all_gather(self, x, dim: int):
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        if self._box is None:
            xs = self._host(x).contiguous()
            outs = [torch.empty_like(xs) for _ in range(self.size)]
            dist.all_gather(outs, xs, group=self.group)
        else:
            xs = x.contiguous()
            outs = torch.empty((self.size,) + xs.shape, dtype=xs.dtype,
                               device=xs.device)
            xb, ob = _bytes(xs), outs.view(self.size, -1).view(torch.uint8)
            for rnd in _rounds([xb.numel()], MAILBOX_CAP):
                (_, lo, hi, _), = rnd

                def write(slot, lo=lo, hi=hi):
                    slot[:hi - lo].copy_(xb[lo:hi])

                def read(slots, lo=lo, hi=hi):
                    for i, sl in enumerate(slots):
                        ob[i, lo:hi].copy_(sl[:hi - lo])
                self._round(hi - lo, write, read)
            outs = outs.unbind(0)
        out = self._back(torch.cat(outs, dim=dim))
        self.gather_s += time.perf_counter() - t0
        return out

    def reduce_scatter(self, x, dim: int):
        """The sum of every rank's ``x`` over the group, cut into ``size``
        equal blocks along ``dim``: rank r returns block r
        (``lax.psum_scatter(..., tiled=True)``).  The sum runs over the
        ranks in rank order, accumulated in float32 (float64 for float64,
        int64 for integers) and cast back, so every transport gives the
        same bits; ``nccl`` uses ``reduce_scatter_tensor`` (its own
        order)."""
        if self.size == 1:
            return x
        S = self.size
        if x.shape[dim] % S:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)}"
                             f" does not split over {S} ranks")
        t0 = time.perf_counter()
        if self.transport == "nccl":
            parts = torch.stack(x.chunk(S, dim=dim)).contiguous()
            out = torch.empty_like(parts[0])
            dist.reduce_scatter_tensor(out, parts, group=self.group)
            self.scatter_s += time.perf_counter() - t0
            return out
        # every rank's block r reaches rank r (an all_to_all), then the
        # blocks are summed in rank order
        parts = self._host(torch.stack(x.chunk(S, dim=dim)).contiguous())
        outs = torch.empty_like(parts)
        if self._box is None:
            dist.all_to_all_single(outs, parts, group=self.group)
        else:
            self._ipc_all_to_all(parts, outs)
        acc = outs[0].to(_acc_dtype(outs.dtype), copy=True)
        for o in outs[1:]:
            acc += o
        out = self._back(acc.to(x.dtype))
        self.scatter_s += time.perf_counter() - t0
        return out

    def all_reduce_(self, tensors, op: str = "sum"):
        """Reduce each tensor over the group in place: ``op`` ``"sum"``
        (``lax.psum``) or ``"max"`` (``lax.pmax``)."""
        if self.size == 1:
            return tensors
        rop = _OPS[op]
        t0 = time.perf_counter()
        if self._box is not None:
            self._ipc_reduce(tensors, op)
            self.reduce_s += time.perf_counter() - t0
            return tensors
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

    def _ipc_reduce(self, tensors, op):
        """Every rank's tensors through the mailbox; each rank reduces the
        ranks' slots in rank order (sums in float32, float64 for float64
        tensors, integers in int64) and writes the result in place."""
        flats = [t if t.is_contiguous() else t.contiguous() for t in tensors]
        bs = [_bytes(f) for f in flats]
        for rnd in _rounds([b.numel() for b in bs], MAILBOX_CAP):
            need = rnd[-1][3] + rnd[-1][2] - rnd[-1][1]

            def write(slot, rnd=rnd):
                for i, lo, hi, off in rnd:
                    slot[off:off + hi - lo].copy_(bs[i][lo:hi])

            def read(slots, rnd=rnd):
                # one reduction over each run of segments of one dtype
                runs = []
                for seg in rnd:
                    dt = flats[seg[0]].dtype
                    if runs and runs[-1][0] == dt:
                        runs[-1][1].append(seg)
                    else:
                        runs.append((dt, [seg]))
                for dt, segs in runs:
                    a, b = segs[0][3], segs[-1][3] + segs[-1][2] - segs[-1][1]
                    xs = [sl[a:b].view(dt) for sl in slots]
                    if op == "max":
                        acc = xs[0].clone()
                        for x in xs[1:]:
                            torch.maximum(acc, x, out=acc)
                    else:
                        acc = xs[0].to(_acc_dtype(dt), copy=True)
                        for x in xs[1:]:
                            acc += x
                    acc = _bytes(acc.to(dt))
                    for i, lo, hi, off in segs:
                        bs[i][lo:hi].copy_(acc[off - a:off - a + hi - lo])
            self._round(need, write, read)
        for t, f in zip(tensors, flats):
            if f is not t:
                t.copy_(f)

    def broadcast_(self, tensors, root: int):
        """Copy each tensor of group rank ``root`` to every rank, in
        place."""
        if self.size == 1:
            return tensors
        t0 = time.perf_counter()
        if self._box is not None:
            flats = [t if t.is_contiguous() else t.contiguous()
                     for t in tensors]
            bs = [_bytes(f) for f in flats]
            for rnd in _rounds([b.numel() for b in bs], MAILBOX_CAP):
                need = rnd[-1][3] + rnd[-1][2] - rnd[-1][1]

                def write(slot, rnd=rnd):
                    if self.rank == root:
                        for i, lo, hi, off in rnd:
                            slot[off:off + hi - lo].copy_(bs[i][lo:hi])

                def read(slots, rnd=rnd):
                    if self.rank != root:
                        for i, lo, hi, off in rnd:
                            bs[i][lo:hi].copy_(slots[root][off:off + hi
                                                           - lo])
                self._round(need, write, read)
            for t, f in zip(tensors, flats):
                if f is not t:
                    t.copy_(f)
            self.reduce_s += time.perf_counter() - t0
            return tensors
        for t in tensors:
            h = self._host(t)
            dist.broadcast(h, self.ranks[root], group=self.group)
            if h is not t:
                t.copy_(h)
        self.reduce_s += time.perf_counter() - t0
        return tensors


def _acc_dtype(dt):
    """The dtype the mailbox sum accumulates a ``dt`` tensor in."""
    if dt == torch.float64:
        return torch.float64
    if dt.is_floating_point:
        return torch.float32
    return torch.int64


class CommCounts:
    """What a :class:`MetaComm` was asked to move, by kind of collective:
    ``bytes`` — per-rank link bytes (the ring-algorithm estimates of the
    reference's ``analysis/roofline.collective_stats``: a shift R, an
    all-gather R·(n − 1)/n of the gathered result R, an all-reduce
    2·R·(n − 1)/n, an all-to-all R·(n − 1)/n, a broadcast R, a
    reduce-scatter R·(n − 1)/n of its input R), ``ops`` —
    calls, ``hop_bytes`` — the same bytes with a shift of h hops weighed
    |h| (the distance its caller names; every other kind weighs 1).  The
    Comms of one mesh share one instance; :meth:`reset` zeroes it."""

    KINDS = ("shift", "all_to_all", "all_gather", "all_reduce", "broadcast",
             "reduce_scatter")

    def __init__(self):
        self.reset()

    def reset(self):
        self.bytes = dict.fromkeys(self.KINDS, 0.0)
        self.ops = dict.fromkeys(self.KINDS, 0)
        self.hop_bytes = 0.0

    def add(self, kind: str, nbytes: float, hops: int = 1):
        self.bytes[kind] += nbytes
        self.ops[kind] += 1
        self.hop_bytes += nbytes * abs(hops)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    def as_dict(self) -> dict:
        return {"total_bytes": self.total_bytes,
                "hop_weighted_bytes": self.hop_bytes,
                "bytes_by_kind": {k: v for k, v in self.bytes.items() if v},
                "op_counts": {k: v for k, v in self.ops.items() if v}}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class MetaComm:
    """A :class:`Comm` over no process group: one rank's view of a group of
    ``len(ranks)`` ranks (``me`` its global rank) for the dry-run
    (``launch/mesh.make_production_mesh``).  Every collective returns
    tensors of the shape and dtype the real one would, moves no data
    (received tensors are new and uninitialised; reductions and broadcasts
    leave their tensors as they are) and records what it would have moved
    in ``counts`` (:class:`CommCounts`).  The autograd forms below
    (:func:`all_to_all`, :func:`all_reduce`, :func:`gather_rows`,
    :func:`shift`, :func:`gather_param`) call these methods, so a
    backward's collectives are counted too."""

    def __init__(self, ranks, me: int, counts: CommCounts, device="meta"):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(me)
        self.transport = "meta"
        self.device = torch.device(device)
        self.group = self.p2p_group = None
        self.counts = counts
        self.shift_wait_s = self.reduce_s = self.gather_s = 0.0
        self.a2a_s = self.scatter_s = 0.0

    @staticmethod
    def _like(t, shape=None):
        return torch.empty(t.shape if shape is None else shape,
                           dtype=t.dtype, device=t.device)

    def shift(self, tensors, hops: int):
        tensors = [t.contiguous() for t in tensors]
        if hops % self.size == 0:
            return _Done(tensors)
        self.counts.add("shift", sum(_nbytes(t) for t in tensors), hops)
        return _Done([self._like(t) for t in tensors])

    def all_to_all(self, x, split_dim: int, concat_dim: int):
        if self.size == 1:
            return x
        n = self.size
        self.counts.add("all_to_all", _nbytes(x) * (n - 1) / n)
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[concat_dim] *= n
        return self._like(x, shape)

    def all_gather(self, x, dim: int):
        if self.size == 1:
            return x
        n = self.size
        self.counts.add("all_gather", _nbytes(x) * (n - 1))
        shape = list(x.shape)
        shape[dim] *= n
        return self._like(x, shape)

    def all_reduce_(self, tensors, op: str = "sum"):
        if self.size == 1:
            return tensors
        n = self.size
        for t in tensors:
            self.counts.add("all_reduce", 2.0 * _nbytes(t) * (n - 1) / n)
        return tensors

    def broadcast_(self, tensors, root: int):
        if self.size == 1:
            return tensors
        for t in tensors:
            self.counts.add("broadcast", _nbytes(t))
        return tensors

    def reduce_scatter(self, x, dim: int):
        if self.size == 1:
            return x
        n = self.size
        self.counts.add("reduce_scatter", _nbytes(x) * (n - 1) / n)
        shape = list(x.shape)
        shape[dim] //= n
        return self._like(x, shape)


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


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        return g.narrow(ctx.dim, c.rank * ctx.n, ctx.n), None, None


def gather_rows(comm, x, dim: int):
    """:meth:`Comm.all_gather` inside an autograd graph where each rank
    goes on to use only its own piece of the gathered rows' results: the
    backward keeps this rank's piece of the cotangent and sends nothing,
    so each rank's gradient is its own share (as :func:`all_reduce`'s).
    ``comm`` None or of one rank: ``x`` itself."""
    if comm is None or comm.size == 1:
        return x
    return _GatherRows.apply(x, comm, dim)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, hops):
        ctx.comm, ctx.hops = comm, hops
        return comm.shift([x], hops).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.shift([g.contiguous()], -ctx.hops).wait()[0], None, \
            None


def shift(comm, x, hops: int):
    """:meth:`Comm.shift` of one tensor inside an autograd graph: rank p
    receives rank (p − hops)'s ``x``; the backward shifts the cotangent by
    −hops, back to the rank that sent it.  Every rank of ``comm`` must
    call it, and must keep its result in the graph (masking it by
    arithmetic, not dropping it), so that every rank runs the backward's
    shift too.  ``comm`` None or of one rank: ``x`` itself."""
    if comm is None or comm.size == 1:
        return x
    return _Shift.apply(x, comm, int(hops))


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, scale):
        ctx.comm, ctx.dim, ctx.scale = comm, dim, scale
        return comm.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        gs = ctx.comm.reduce_scatter(g.contiguous(), ctx.dim)
        return (gs * ctx.scale if ctx.scale != 1.0 else gs), None, None, None


def gather_param(comm, shard, dim: int, scale: float = 1.0):
    """FSDP's gather on use: every rank's ``shard`` of a parameter
    concatenated along ``dim`` in rank order (:meth:`Comm.all_gather`),
    inside an autograd graph.  Its backward reduce-scatters the
    cotangent over ``comm`` (:meth:`Comm.reduce_scatter`), so each rank's
    shard receives the sum over the ranks of that block of their
    gradients, times ``scale`` (``1 / r`` when the group's ranks come in
    ``r`` replicas holding the same tokens, whose sum would count each
    token ``r`` times).  ``comm`` None or of one rank: ``shard``
    itself."""
    if comm is None or comm.size == 1:
        return shard
    return _GatherParam.apply(shard, comm, int(dim), float(scale))


def gather_param_ref(shards, dim: int):
    """:func:`gather_param`'s plain version: the shards (group rank order)
    concatenated along ``dim``.  Its gradient with respect to shard r is
    block r of the cotangent; :func:`gather_param`'s is the sum of the
    ranks' blocks r."""
    return torch.cat(list(shards), dim=dim)
