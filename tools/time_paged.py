#!/usr/bin/env python3
"""Times kernel B of the PyTorch/CUDA port (the paged decode) with a cold
L2, for whichever checkout's ``repro_torch`` is first on the path, so that
two checkouts can be compared in one run on one card:

    PYTHONPATH=<checkout>/src python3 tools/time_paged.py

Shapes (seeded random bf16 inputs, llama-7b's 32 heads × 128, bs 16,
fragmented block tables):
  serve  B 4, Tq 1, lengths 1016/716/529/80 (a decode step of the serving
         run);
  long   B 1, Tq 1, one 32768-token request;
  gqa    B 4, Tq 4, 32 query heads over 8 kv heads, the serving lengths.

Each shape gets four distinct pairs of pools (together 285 MB at ``serve``,
far above the 50 MB L2), and successive launches rotate over them, as the
engine's 32 layers do, so every launch reads its K and V from device
memory.  Three times per shape, in milliseconds:
  device_ms   the kernels' own time per call: torch.profiler's device time
              of every kernel whose name holds ``paged_decode``, over 40
              calls, divided by 40;
  wrapper_ms  CUDA events around one ``paged_attn`` call (median of 20 after
              4 warm-ups): the device time plus what the host adds between
              the events;
  host_ms     a host clock around 1000 ``paged_attn`` calls with no sync in
              the loop, over 1000: the host's cost of a call, or the
              device's where that is larger (the launch queue fills).
Also the bound (each K/V byte read once, q and o once, the table and the
lengths; over 3.35 TB/s) and the largest absolute difference from the
plain version.  Prints one JSON line with the card, its power limit and
the checkout.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import mask as mk
from repro_torch.kernels import build
from repro_torch.kernels.paged import paged_attn, paged_attn_ref

PEAK_BYTES = 3.35e12
SERVE_LENS = [1016, 716, 529, 80]
SHAPES = {  # B, Tq, Hq, Hkv, D, bs, lengths
    "serve": (4, 1, 32, 32, 128, 16, SERVE_LENS),
    "long": (1, 1, 32, 32, 128, 16, [32768]),
    "gqa": (4, 4, 32, 8, 128, 16, SERVE_LENS),
}
PAIRS = 4


def inputs(gen, B, Tq, Hq, Hkv, D, bs, lengths, dtype=torch.bfloat16):
    """q, PAIRS (k_pool, v_pool) pairs, one fragmented table, lengths."""
    dev = torch.device("cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    nb = -(-max(lengths) // bs) + 2
    N = B * nb + 8
    q = torch.randn((B, Tq, Hq, D), generator=gen, device=dev).to(dtype)
    pools = [tuple(torch.randn((N, bs, Hkv, D), generator=gen, device=dev)
                   .to(dtype) for _ in range(2)) for _ in range(PAIRS)]
    perm = torch.randperm(N - 1, generator=gen, device=dev)[:B * nb] + 1
    table = perm.reshape(B, nb).to(torch.int32)
    for b in range(B):
        table[b, -(-lengths[b] // bs):] = 0
    return q, pools, table.contiguous(), lens


def device_ms(call, n=40):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(4):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and "paged_decode" in ev.key)
    return us / 1e3 / n


def wrapper_ms(call, reps=20, warmup=4):
    for i in range(warmup):
        call(i)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call(i)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def host_ms(call, n=1000):
    call(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        call(i)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / n


def time_shape(gen, B, Tq, Hq, Hkv, D, bs, lengths):
    q, pools, bt, lens = inputs(gen, B, Tq, Hq, Hkv, D, bs, lengths)
    m = mk.causal()

    def call(i):
        kp, vp = pools[i % PAIRS]
        return paged_attn(q, kp, vp, bt, lens, mask=m)
    o = call(0)
    o_r = paged_attn_ref(q, *pools[0], bt, lens, mask=m)
    err = float((o.float() - o_r.float()).abs().max())
    plain = wrapper_ms(lambda i: paged_attn_ref(q, *pools[i % PAIRS], bt,
                                                lens, mask=m), reps=5,
                       warmup=1)
    ctx = sum(lengths)
    nbytes = 2 * (2 * ctx * Hkv * D + 2 * B * Tq * Hq * D) \
        + 4 * (B + bt.numel())
    out = {"device_ms": device_ms(call), "wrapper_ms": wrapper_ms(call),
           "host_ms": host_ms(call), "plain_ms": plain,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bytes": nbytes,
           "max_abs_err": err}
    del q, pools, bt, lens, o, o_r
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        print("time_paged: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "checkout": str(build.CSRC.parents[3])}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in SHAPES.items():
        out[name] = time_shape(gen, *shape)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
