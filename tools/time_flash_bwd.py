#!/usr/bin/env python3
"""Times kernels C and D of the PyTorch/CUDA port (the flash backward pair)
at the training shape, for whichever checkout's ``repro_torch`` is first on
the path, so that two checkouts can be compared in one run on one card:

    PYTHONPATH=<checkout>/src python3 tools/time_flash_bwd.py

Inputs: seeded random bf16 q, k, v, do of shape (1, 8192, 32, 128) (the
llama-7b width), causal, with (o, lse) from kernel A.  Each kernel's time is
the median of 10 launches after 2 warm-ups (CUDA events).  Prints one JSON
line with the card, its power limit, the checkout and both times.
"""
import json
import subprocess
import sys

import torch

from repro_torch.core import mask as mk
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_BwdPlan, _launch_dkv,
                                                 _launch_dq, flash_fwd)

B, T, H, D = 1, 8192, 32, 128


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
        print("time_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    m = mk.causal()
    o, lse = flash_fwd(q, k, v, mask=m)
    pl = _BwdPlan(q, k, v, o, lse, do, m, None, None, None, True)
    scale = D ** -0.5
    dq_ms = cuda_ms(lambda: _launch_dq(pl, scale))
    dkv_ms = cuda_ms(lambda: _launch_dkv(pl, scale))
    print(json.dumps({"card": smi, "checkout": str(build.CSRC.parents[3]),
                      "flash_bwd_dq_ms": dq_ms, "flash_bwd_dkv_ms": dkv_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
