"""What it costs 4 ranks sharing one card to tell each other that data is
ready: the token a transport waits on, timed in isolation.

The ``cuda-ipc`` transport (``src/repro_torch/parallel/comm.py``) announces
each round through a doorbell in shared host memory instead of a gloo
message; this script gives the figures behind that choice.  A 4-rank world
on the card times, per call (mean of ``--reps``, slowest rank):

  * gloo over the group: ``all_gather`` and ``all_reduce`` of two int64s,
    ``barrier``, and a point-to-point round trip to the next rank;
  * a doorbell: each rank bumps its counter in a shared page and waits
    (``comm._spin``, the transport's own wait) until every rank has;
  * ``synchronize`` with nothing queued, and after one tiny kernel (the
    stream sync each ``cuda-ipc`` round makes);
  * a ``cuda-ipc`` all-reduce of two int64s (``Comm.all_reduce_``): the
    whole round.

    python tools/time_tokens.py [--reps 200]

Needs one CUDA card; prints the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.world import spawn  # noqa: E402
from repro_torch.parallel import comm as cm  # noqa: E402

RANKS = 4


def _rank(rank, path, reps):
    import torch.distributed as dist
    mesh = make_local_mesh(seq=RANKS, device="cuda")
    c = mesh.comms["model"]
    g = c.group
    tok = torch.tensor([1, 2], dtype=torch.int64)
    toks = [torch.empty_like(tok) for _ in range(RANKS)]
    back = torch.empty_like(tok)
    dst, src = (rank + 1) % RANKS, (rank - 1) % RANKS

    def timed(fn):
        fn()
        dist.barrier(group=g)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    def p2p():
        w = dist.isend(tok, c.ranks[dst], g, 7)
        dist.irecv(back, c.ranks[src], g, 7).wait()
        w.wait()

    bell = np.memmap(path, dtype=np.int64, mode="r+", shape=(RANKS, 8))
    n = [0]

    def doorbell():
        n[0] += 1
        bell[rank, 0] = n[0]
        cm._spin(lambda: all(bell[i, 0] >= n[0] for i in range(RANKS)),
                 "doorbell")

    x = torch.zeros(1, device="cuda")
    red = torch.zeros(2, dtype=torch.int64, device="cuda")
    out = dict(
        all_gather=timed(lambda: dist.all_gather(toks, tok, group=g)),
        all_reduce=timed(lambda: dist.all_reduce(tok, group=g)),
        barrier=timed(lambda: dist.barrier(group=g)),
        p2p_round_trip=timed(p2p),
        doorbell=timed(doorbell),
        sync_idle=timed(lambda: torch.cuda.current_stream().synchronize()),
        kernel_and_sync=timed(lambda: (
            x.add_(1), torch.cuda.current_stream().synchronize())),
        cuda_ipc_all_reduce=timed(lambda: c.all_reduce_([red])))
    del bell
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_tokens: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    fd, path = tempfile.mkstemp(prefix="doorbell-")
    try:
        os.write(fd, bytes(8 * 8 * RANKS))
        os.close(fd)
        res = spawn(_rank, RANKS, (path, args.reps), device="cuda",
                    timeout=300)
    finally:
        os.unlink(path)
    for k in res[0]:
        print(f"  {k}: {max(r[k] for r in res):.1f} µs a call (slowest of "
              f"{RANKS} ranks, mean of {args.reps})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
