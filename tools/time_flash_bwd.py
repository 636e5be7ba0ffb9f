#!/usr/bin/env python3
"""Times kernels C and D of the PyTorch/CUDA port (the flash backward pair)
for whichever checkout's ``repro_torch`` is first on the path, so that two
checkouts can be compared in one run on one card:

    PYTHONPATH=<checkout>/src python3 tools/time_flash_bwd.py [--pair]

Inputs: seeded random bf16 tensors, causal, with (o, lse) from kernel A.
By default q, k, v, do of shape (1, 8192, 32, 128) (the llama-7b width);
with ``--pair`` deepseek-v2-lite-16b's training shape: q, k (1, 8192, 16,
192), v the strided last 128 columns of a (1, 8192, 16, 256) tensor, do
(1, 8192, 16, 128), scale 1/√192.  Each kernel's time is the median of 10
launches after 2 warm-ups (CUDA events).  Prints one JSON line with the
card, its power limit, the checkout, both times and a SHA-256 digest of
each output's bytes (dq, dk, dv), which tells two checkouts' bits apart.
"""
import argparse
import hashlib
import json
import subprocess
import sys

import torch

from repro_torch.core import mask as mk
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_BwdPlan, _launch_dkv,
                                                 _launch_dq, flash_fwd)

B, T = 1, 8192


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def inputs(pair):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    if pair:
        H = 16
        q, k = randn(B, T, H, 192), randn(B, T, H, 192)
        v = randn(B, T, H, 256)[..., 128:]
        return q, k, v, randn(B, T, H, 128), 192 ** -0.5
    q, k, v, do = (randn(B, T, 32, 128) for _ in range(4))
    return q, k, v, do, 128 ** -0.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", action="store_true",
                    help="q/k 192, v 128 at 16 heads (phase 14's shape)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    q, k, v, do, scale = inputs(args.pair)
    m = mk.causal()
    o, lse = flash_fwd(q, k, v, mask=m, scale=scale)
    pl = _BwdPlan(q, k, v, o, lse, do, m, None, None, None, True)
    dq = _launch_dq(pl, scale)
    dk, dv = _launch_dkv(pl, scale)
    dq_ms = cuda_ms(lambda: _launch_dq(pl, scale))
    dkv_ms = cuda_ms(lambda: _launch_dkv(pl, scale))
    print(json.dumps({"card": smi, "checkout": str(build.CSRC.parents[3]),
                      "shape": "pair 192/128" if args.pair else "D 128",
                      "flash_bwd_dq_ms": dq_ms, "flash_bwd_dkv_ms": dkv_ms,
                      "sha256": {"dq": digest(dq), "dk": digest(dk),
                                 "dv": digest(dv)}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
