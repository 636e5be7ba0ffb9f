"""Run a function on every rank of a fresh ``torch.distributed`` world of
processes on this host, with a time limit.

    results = spawn(fn, nprocs, args, device="cpu", timeout=180)

``device`` has no default: a world says where its ranks run (``"cpu"``:
``gloo``; ``"cuda"``: the card's transport).

Each child starts its world with :func:`~repro_torch.parallel.comm.
init_world` (a ``file://`` store in a temporary directory), calls
``fn(rank, *args)`` and saves its return value with ``torch.save``; the
parent returns the values in rank order.  Any child that fails, or a world
still running at ``timeout`` seconds, is fatal: every child is killed and
the parent raises, so a deadlocked world cannot outlive its caller.  ``fn``
must be importable by name (``spawn`` start method).
"""
from __future__ import annotations

import gc
import os
import tempfile
import time

import torch
import torch.multiprocessing as mp


def _child(rank, nprocs, store, device, fn, args, outdir, threads):
    import torch.distributed as dist
    from repro_torch.parallel.comm import init_world
    torch.set_num_threads(threads)
    init_world(device, rank=rank, world_size=nprocs,
               init_method=f"file://{store}")
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        # under cuda-ipc a peer may still read this rank's mailboxes, and
        # this rank holds its peers' open until its Comms are collected
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def spawn(fn, nprocs: int, args=(), *, device,
          timeout: float | None = 180.0, threads: int = 1):
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, each on its own rank
    (see the module docstring)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child,
                             args=(r, nprocs, store, str(device), fn,
                                   tuple(args), tmp, threads))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {nprocs} exited with code "
                        f"{procs[bad[0]].exitcode}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"world of {nprocs} ranks still "
                                       f"running after {timeout:.0f} s")
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"rank {bad[0]} of {nprocs} exited with "
                                   f"code {procs[bad[0]].exitcode}")
        finally:
            _kill(procs)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
