#!/usr/bin/env python3
"""Replay every rank's plan steps on one card and time their kernels: the
paper's load-balance argument in the card's own numbers.

    PYTHONPATH=src python3 tools/replay_plans.py [--tl 8192] [--ranks 4]

For ``balanced``, ``ring`` and ``zigzag`` under a causal mask at P ranks of
Tl tokens (llama-7b's attention: 32 heads × 128, bf16, B 1), each rank's
kernel calls of each step, as the executors launch them
(``schedule.rank_calls``), run in one process on the rank's operand
chunks: kernel A (the forward's calls), and kernels C + D (the
backward's, from the saved lse with the executor's inputs, o = 0 and
delta passed in), each timed
with CUDA events (median of ``--reps`` after a warm-up).  A step of a
multi-rank run lasts as long as its slowest rank, so the script prints,
per schedule, the sum over steps of the slowest rank's kernel time beside
the perfectly balanced time (all ranks' kernel time / P).  Communication
is not part of it: on one card the ranks' transfers cannot be measured.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.core import mask as mk
from repro_torch.core import schedule as sp
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd

HEADS, HEAD_DIM = 32, 128


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def replay(sched, P, Tl, reps, dev):
    """Per (step, rank): (forward ms, backward ms) of the rank's active
    items."""
    plan = sp.build_plan(sched, mk.causal(), P, Tl)
    c = plan.chunk_len
    gen = torch.Generator(device=dev).manual_seed(0)
    G = P * plan.n_chunks

    def rnd():
        return torch.randn((1, G * c, HEADS, HEAD_DIM), generator=gen,
                           device=dev).to(torch.bfloat16)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()

    def cut(x, g):
        return x[:, g * c:(g + 1) * c]

    fwd_calls, bwd_calls = {}, {}
    for calls, backward in ((fwd_calls, False), (bwd_calls, True)):
        for si, p, qg, kg, m in sp.rank_calls(plan, backward):
            calls.setdefault((si, p), []).append(
                (cut(q, qg), cut(k, kg), cut(v, kg), cut(do, qg), m))

    def fwd_ms(items):
        def run():
            for qc, kc, vc, _, m in items:
                flash_fwd(qc, kc, vc, mask=m)
        return _ms(run, reps)

    def bwd_ms(items):
        ops = []
        for qc, kc, vc, dc, m in items:
            o, lse = flash_fwd(qc, kc, vc, mask=m)
            delta = (o.float() * dc.float()).sum(-1)
            ops.append((qc, kc, vc, dc, m, lse, delta, torch.zeros_like(qc)))

        def run():
            for qc, kc, vc, dc, m, lse, delta, zero in ops:
                flash_bwd(qc, kc, vc, zero, lse, dc, mask=m, delta=delta)
        return _ms(run, reps)

    rows = [[(fwd_ms(fwd_calls[si, p]) if (si, p) in fwd_calls else 0.0,
              bwd_ms(bwd_calls[si, p]) if (si, p) in bwd_calls else 0.0)
             for p in range(P)] for si in range(len(plan.steps))]
    return plan, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tl", type=int, default=8192)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    build.build_all()
    P, Tl = args.ranks, args.tl
    print(f"P {P}, Tl {Tl}, {HEADS} heads × {HEAD_DIM}, bf16, causal; ms "
          f"per (step, rank), forward A / backward C+D")
    summary = {}
    for sched in ("balanced", "ring", "zigzag"):
        plan, rows = replay(sched, P, Tl, args.reps, dev)
        print(f"{sched}: {plan.exec_steps} ring steps, "
              f"{plan.kernel_calls} work items")
        for si, row in enumerate(rows):
            print(f"  step {si}: " + "  ".join(
                f"r{p} {f:.3f}/{b:.3f}" for p, (f, b) in enumerate(row)))
        s = {}
        for i, name in ((0, "fwd"), (1, "bwd")):
            slowest = sum(max(r[i] for r in row) for row in rows)
            balanced = sum(r[i] for row in rows for r in row) / P
            s[f"{name}_slowest_ms"] = slowest
            s[f"{name}_balanced_ms"] = balanced
        s["total_slowest_ms"] = s["fwd_slowest_ms"] + s["bwd_slowest_ms"]
        s["per_rank_step_ms"] = [[list(r) for r in row] for row in rows]
        summary[sched] = s
        print(f"  sum over steps of the slowest rank: forward "
              f"{s['fwd_slowest_ms']:.3f} ms (balanced share "
              f"{s['fwd_balanced_ms']:.3f}), backward "
              f"{s['bwd_slowest_ms']:.3f} ms (balanced share "
              f"{s['bwd_balanced_ms']:.3f})")
    ratio = summary["balanced"]["total_slowest_ms"] / \
        summary["ring"]["total_slowest_ms"]
    print(f"balanced / ring, sum of the slowest rank's kernel time: "
          f"{ratio:.4f}")
    print(json.dumps({"replay": {k: {kk: vv for kk, vv in v.items()
                                     if kk != "per_rank_step_ms"}
                                 for k, v in summary.items()},
                      "balanced_over_ring": ratio, "card": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
