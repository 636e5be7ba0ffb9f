"""Does chip_smoke.py's phase 15 fit on one card at a given sequence length?

Phase 15 trains deepseek-v2-lite-16b at full width, 3 of its 27 layers,
across 4 ranks that share one card, and holds them to one process (P = 1)
that runs the same weights and tokens first.  This script runs that phase's
own two parts with the sequence set to ``--tokens`` (the per-expert capacity
follows from it): the one process, then, if it fits, the 4-rank world.  It
prints each part's peak memory, or the out-of-memory error of the part that
does not fit, beside the card's name and power limit.

    python tools/fit_moe_ranks.py --tokens 32768

Needs one CUDA card; builds the kernels from the checkout first.
"""
import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402

GIB = 2 ** 30


def _resize(tokens):
    """Set phase 15's sequence to ``tokens`` and its capacity to match."""
    cs.P15_T = tokens
    cs.P15_CAP = capacity(cs._p15_cfg(), tokens // cs.P15_RANKS)


def _rank(rank, tmp, tokens):
    """One rank of phase 15's world at ``tokens``; its peaks, or its
    out-of-memory error printed before it is raised again."""
    _resize(tokens)
    try:
        out = cs._p15_rank(rank, tmp)
    except torch.OutOfMemoryError as e:
        print(f"rank {rank}: out of memory at peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB allocated, "
              f"{torch.cuda.max_memory_reserved() / GIB:.2f} reserved: {e}",
              flush=True)
        raise
    return dict(rank=rank, peak=out["peak"], reserved=out["peak_reserved"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=32768)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fit_moe_ranks: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build.build_all()
    _resize(args.tokens)
    cfg = cs._p15_cfg()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase 15 at {args.tokens} tokens ({args.tokens // cs.P15_RANKS}"
          f" a rank), {cfg.n_layers} layers, capacity {cs.P15_CAP}; card "
          f"{total / GIB:.2f} GiB", flush=True)
    shape = cs.ShapeSpec("chip15", args.tokens, 1, "train")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        try:
            cs._p15_one(cfg, shape, tmp)
        except torch.OutOfMemoryError as e:
            print(f"P = 1: out of memory after {time.perf_counter() - t0:.1f}"
                  f" s at peak {torch.cuda.max_memory_allocated() / GIB:.2f} "
                  f"GiB allocated, {torch.cuda.max_memory_reserved() / GIB:.2f}"
                  f" reserved: {e}", flush=True)
            return 0
        print(f"P = 1: fits, {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB allocated, "
              f"{torch.cuda.max_memory_reserved() / GIB:.2f} reserved",
              flush=True)
        cs._free()
        t0 = time.perf_counter()
        try:
            res = cs.spawn(_rank, cs.P15_RANKS, (tmp, args.tokens),
                           device=cs.DEV, timeout=cs.P15_TIMEOUT, threads=2)
        except RuntimeError as e:
            print(f"{cs.P15_RANKS} ranks failed ({e}); the rank's error "
                  f"is above", flush=True)
            return 0
    for r in sorted(res, key=lambda r: r["rank"]):
        print(f"rank {r['rank']}: fits, peak {r['peak'] / GIB:.2f} GiB "
              f"allocated, {r['reserved'] / GIB:.2f} reserved", flush=True)
    print(f"{cs.P15_RANKS} ranks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
