#!/usr/bin/env python3
"""Times kernel A's latent route (MLA's q/k 576, v 512; deepseek-v2-lite-16b's
16 query heads over one latent kv head, v the latent rows' 512-column view,
scale 1/√192) for whichever checkout's ``repro_torch`` is first on the path,
so that two checkouts can be compared in one run on one card:

    PYTHONPATH=<checkout>/src python3 tools/time_latent_fwd.py

Shapes (seeded random inputs, causal): phase 12's serving chunk, Tq 256 at
q_offset 768 against Tk 1024 gathered latent rows; and a first chunk, Tq
256 at q_offset 0 against Tk 256 (short sweeps).  For each, in bf16 (the
route the serving path runs) and float32: the wrapper's time (median of 20
calls after 3 warm-ups, CUDA events: host work the card waits for
included), the wall time a call over 200 back-to-back calls
(``host_us``), the device time a call of 20 calls captured in a CUDA
graph (``graph_ms``: replays timed with events), the kernel's own device
time (torch.profiler over 20 calls, after every event timing), each again with each tile's kv sweep cut into
1, 2 and 4 parts (bf16; the wrapper's own choice is ``latent_splits``);
SDPA's (events, wall) with an explicit mask and ``enable_gqa`` on the same
inputs; the least time the card could take
(operations at the bf16 tensor rate, or bytes at 3.35 TB/s), and the
largest absolute and element-wise relative difference from the plain
version.  Prints one JSON line with the card and its power limit.
"""
import json
import subprocess
import sys
import time

import torch

from repro_torch.core import mask as mk
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.ref import chunk_attn_ref

H, DK, DV, SCALE = 16, 576, 512, 192 ** -0.5
SHAPES = {"serve": (256, 1024, 768), "first": (256, 256, 0)}
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def cuda_ms(fn, reps=20, warmup=3):
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


def device_ms(fn, n=20):
    """Device time a call of the kernels whose name holds
    ``flash_fwd_latent`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and "flash_fwd_latent" in ev.key)
    return us / 1e3 / n


def graph_ms(fn, n=20, reps=5):
    """Device milliseconds a call: n calls captured in one CUDA graph, its
    replays timed with CUDA events (no host work between launches)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(g, stream=s):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(s)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[reps // 2]


def rel_err(a, r, floor=1e-3):
    a, r = a.float(), r.float()
    return float(((a - r).abs() / (r.abs() + floor * r.abs().max())).max())


def host_us(fn, n=200):
    """Wall microseconds a call over n back-to-back calls: the larger of the
    host's work and the card's a call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def main():
    if not torch.cuda.is_available():
        print("time_latent_fwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": smi, "checkout": str(build.CSRC.parents[3])}
    gen = torch.Generator(device="cuda").manual_seed(0)
    chosen = fa.latent_splits
    runs = []          # (key, call, parts or None) timed below
    for name, (Tq, Tk, off) in SHAPES.items():
        q32 = torch.randn((1, Tq, H, DK), generator=gen, device="cuda")
        k32 = torch.randn((1, Tk, 1, DK), generator=gen, device="cuda")
        m = mk.causal(rel_offset=off)
        pairs = sum(min(Tk, off + t + 1) for t in range(Tq))
        flops = 2.0 * H * pairs * (DK + DV)
        nbytes = 2 * (Tq * H * (DK + DV) + Tk * DK) + 4 * Tq * H
        out[f"{name}_bound_ms"] = 1e3 * max(flops / PEAK_FLOPS,
                                            nbytes / PEAK_BYTES)
        out[f"{name}_gflop"] = flops / 1e9
        allow = (torch.arange(Tk, device="cuda")[None, :]
                 <= off + torch.arange(Tq, device="cuda")[:, None])
        for dt, short in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            tag = f"{name}_{short}"
            q, k = q32.to(dt), k32.to(dt)
            v = k[..., :DV]
            o, lse = flash_fwd(q, k, v, mask=m, scale=SCALE)
            o_r, lse_r = chunk_attn_ref(q, k, v, mask=m, scale=SCALE)
            out[f"{tag}_max_abs_err"] = float((o.float()
                                               - o_r.float()).abs().max())
            out[f"{tag}_rel_err"] = rel_err(o, o_r)
            out[f"{tag}_lse_err"] = float((lse - lse_r).abs().max())

            def call(q=q, k=k, v=v, m=m):
                return flash_fwd(q, k, v, mask=m, scale=SCALE)
            runs.append((tag, call, None))
            if dt == torch.bfloat16:      # each tile's sweep in n parts
                runs += [(f"{tag}_split{n}", call, n) for n in (1, 2, 4)]
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            runs.append((f"{tag}_sdpa", lambda qt=qt, kt=kt, vt=vt,
                         allow=allow: torch.nn.functional
                         .scaled_dot_product_attention(
                             qt, kt, vt, attn_mask=allow, scale=SCALE,
                             enable_gqa=True), None))
    # events and host clocks first: a profiler run slows later launches
    for timer, suffix in ((cuda_ms, "ms"), (host_us, "host_us"),
                          (graph_ms, "graph_ms"), (device_ms, "device_ms")):
        for key, call, n in runs:
            if key.endswith("sdpa") and timer is device_ms:
                continue
            fa.latent_splits = chosen if n is None else (lambda *a, n=n: n)
            out[f"{key}_{suffix}"] = timer(call)
    fa.latent_splits = chosen
    for name in SHAPES:
        out[f"{name}_bf16_device_tflops"] = (
            out[f"{name}_gflop"] / out[f"{name}_bf16_device_ms"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
