#!/usr/bin/env python3
"""Where kernel A's bf16 route spends its time.  Builds
``csrc/flash_fwd_sm90.cu`` as it is and with parts of each pass cut out,
and times every build at the training shape (B 1, T 8192, 32 heads × 128,
bf16, causal) and at the serving chunk (Tq 256 at q_offset 768, Tk 1024),
in turns (builds in order, then in reverse), on one card:

    PYTHONPATH=src python3 tools/ablate_flash_fwd.py

Builds (text substitutions on the source, each asserted to match):
  full         the kernel as it is;
  one_term     p fed to o += p·v as one bf16 term (hi only);
  no_products  s = q·kᵀ and o += p·v left out: loads, mask, softmax and the
               p split remain;
  loads_only   each pass only waits for its kv tile and releases it.
Only ``full`` computes attention; the others are timing probes, wrong by
design.  Each time is the median of 10 launches after 2 warm-ups (CUDA
events).  Prints one JSON line: the card, its power limit, and per build
its two times at each shape and its largest error against the plain
version (first 8 heads).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core import mask as mk
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import FWD_ROUTES, _device_bounds
from repro_torch.kernels.ref import chunk_attn_ref

H, D = 32, 128
SHAPES = {"train": (8192, 8192, 0), "serve": (256, 1024, 768)}

S_PRODUCT = """    for (int ks = 0; ks < KS; ++ks)
      mma_ss_n128("""
PV_HI = "        mma_rs_n128(acc[0], acc[NC - 1], ph[kk], dv);\n"
PV_LO = "        mma_rs_n128(acc[0], acc[NC - 1], pl[kk], dv);\n"
FULL_WAIT = "    mbar_wait(full + s, (n / kStages) & 1);\n"
LOADS_ONLY = FULL_WAIT + """    if (ntiles > 0) {
      mbar_arrive(empty + s);
      if (tid == 0 && n + kStages - 1 < ntiles) {
        if (n >= 1)
          mbar_wait(empty + (n - 1) % kStages, ((n - 1) / kStages) & 1);
        load_kv(n + kStages - 1);
      }
      continue;
    }
"""
CUTS = {
    "full": [],
    "one_term": [(PV_LO, "")],
    "no_products": [(S_PRODUCT, S_PRODUCT.replace("ks < KS", "ks < 0")),
                    (PV_HI, ""), (PV_LO, "")],
    "loads_only": [(FULL_WAIT, LOADS_ONLY)],
}


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


def build_cuts(out: Path):
    """nvcc every cut in parallel; {name: loaded entry point}."""
    src = (build.CSRC / "flash_fwd_sm90.cu").read_text()
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"cut {name}: the source no longer holds "
                                   f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in build.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "k.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "k.so"),
             str(d / "k.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        f = getattr(ctypes.CDLL(str(out / name / "k.so")),
                    FWD_ROUTES[torch.bfloat16][1])
        f.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_void_p]
        fns[name] = f
    return fns


def launch(f, q, k, v, m, o, lse, bounds):
    B, Tq, Hq, _ = q.shape
    ia = build.int64_args(
        B, Tq, k.shape[1], Hq, k.shape[2], D, 1, bounds.shape[0],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        m.causal, m.window, m.prefix_len, m.q_offset, m.kv_offset,
        m.document, 0, 0, m.needs_mask)
    err = f(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
            build.ptr(lse), build.ptr(bounds), None, None, ia, D ** -0.5,
            build.stream_ptr(q.device))
    if err:
        raise RuntimeError(f"launch failed: {err}")


def main():
    if not torch.cuda.is_available():
        print("ablate_flash_fwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fns = build_cuts(build.build_dir() / "ablate")
    res = {name: {} for name in fns}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (Tq, Tk, off) in SHAPES.items():
        q = torch.randn((1, Tq, H, D), generator=gen, device="cuda")
        k, v = (torch.randn((1, Tk, H, D), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        m = mk.causal(rel_offset=off)
        bounds, _ = _device_bounds(m, Tq, Tk, True, str(q.device),
                                   FWD_ROUTES[torch.bfloat16][2])
        o = torch.empty_like(q)
        lse = torch.empty((1, Tq, H), device="cuda")
        o_r, _ = chunk_attn_ref(q[:, :, :8], k[:, :, :8], v[:, :, :8],
                                mask=m)
        for name, f in fns.items():
            launch(f, q, k, v, m, o, lse, bounds)
            torch.cuda.synchronize()
            res[name][f"{shape}_max_abs_err"] = float(
                (o[:, :, :8].float() - o_r.float()).abs().max())
        for name in [*fns, *reversed(list(fns))]:
            f = fns[name]
            res[name].setdefault(f"{shape}_ms", []).append(cuda_ms(
                lambda: launch(f, q, k, v, m, o, lse, bounds)))
        del q, k, v, o, lse, o_r
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "builds": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
