#!/usr/bin/env python3
"""Times kernel A of the PyTorch/CUDA port (the flash forward) at its two
main-path shapes, for whichever checkout's ``repro_torch`` is first on the
path, so that two checkouts can be compared in one run on one card:

    PYTHONPATH=<checkout>/src python3 tools/time_flash_fwd.py

Shapes (seeded random bf16 inputs, the llama-7b width of 32 heads × 128):
training, B 1, T 8192, causal; serving, one prefill chunk of Tq 256 at
q_offset 768 against Tk 1024.  Each time is the median of 10 launches
after 2 warm-ups (CUDA events).  Prints one JSON line with the card, its
power limit, the checkout, both times and each output's largest absolute
difference from the plain version (at the training shape on the first 8
heads).
"""
import json
import subprocess
import sys

import torch

from repro_torch.core import mask as mk
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.ref import chunk_attn_ref

H, D = 32, 128
SHAPES = {"train": (8192, 8192, 0), "serve": (256, 1024, 768)}


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


def main():
    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "checkout": str(build.CSRC.parents[3])}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (Tq, Tk, off) in SHAPES.items():
        q = torch.randn((1, Tq, H, D), generator=gen, device="cuda")
        k, v = (torch.randn((1, Tk, H, D), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        m = mk.causal(rel_offset=off)
        out[f"flash_fwd_{name}_ms"] = cuda_ms(lambda: flash_fwd(q, k, v,
                                                                mask=m))
        o, _ = flash_fwd(q, k, v, mask=m)
        o_r, _ = chunk_attn_ref(q[:, :, :8], k[:, :, :8], v[:, :, :8],
                                mask=m)
        out[f"{name}_max_abs_err"] = float((o[:, :, :8].float()
                                            - o_r.float()).abs().max())
        del q, k, v, o, o_r
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
