"""Where a training step's time goes on the card: one step of a port model
under torch.profiler, its device time by kernel family and the device's
idle share, in a fresh process (late in a long run the profiler drops
kernels, so ``chip_smoke.py``'s phases 22-24 read none).

The model is the architecture's config at full width (``--layers`` cuts
the depth; an MoE model's ``--dense-layers``, ``--experts`` and
``--capacity`` set its leading dense layers, routed experts and capacity
factor), bf16, seed-0 weights, ``remat_aware``, one batch of
``SyntheticTokens`` (a VLM's image rows and an encoder-decoder's frames
included); two untimed steps warm it up, then one is traced.

    PYTHONPATH=src python3 tools/trace_step.py --arch internvl2-2b \
        --seq 8192 --batch 1
    PYTHONPATH=src python3 tools/trace_step.py --arch whisper-tiny \
        --seq 4096 --batch 2
    # chip_smoke.py phase 25's training cell (deepseek-v3 with MTP)
    PYTHONPATH=src python3 tools/trace_step.py --arch deepseek-v3-671b \
        --layers 2 --dense-layers 1 --experts 16 --capacity 2 --seq 4096
    # a CPU check of the script (no device kernels: idle not measured)
    PYTHONPATH=src python3 tools/trace_step.py --arch whisper-tiny --smoke \
        --device cpu --seq 64 --batch 2

Prints the card's name and power limit (nvidia-smi) when it runs on one.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.core.config import (ShapeSpec, TrainConfig,  # noqa: E402
                                     get_config, smoke_config)
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.transformer import (build_model,  # noqa: E402
                                            trainable)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

FAMILIES = (("kernel A flash_fwd", ("flash_fwd",)),
            ("kernel C flash_bwd_dq", ("flash_bwd_dq",)),
            ("kernel D flash_bwd_dkv", ("flash_bwd_dkv",)),
            ("matmul (cuBLAS)", ("gemm", "gemv", "xmma", "cutlass",
                                 "splitk", "nvjet")))


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other (elementwise, reductions, copies)"


def device_kernels(prof):
    """{kernel name: (launches, ms)} from the trace's raw device events."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    out = {}
    for ev in res.events() if res is not None else ():
        if ev.device_type() == DeviceType.CUDA:
            n, ms = out.get(ev.name(), (0, 0.0))
            out[ev.name()] = (n + 1, ms + (ev.end_ns() - ev.start_ns()) / 1e6)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-2b")
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--dense-layers", type=int, default=0)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--capacity", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        build.build_all()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    moe = {k: v for k, v in (("n_dense_layers", args.dense_layers),
                             ("n_routed", args.experts),
                             ("capacity_factor", args.capacity)) if v}
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    model = build_model(cfg, dev)
    params = trainable(model.init(seed=0))
    opt = adamw.init(params)
    step = make_train_step(model, TrainConfig(lr=1e-4, warmup_steps=1))
    batch = SyntheticTokens(cfg, ShapeSpec("trace", args.seq, args.batch,
                                           "train"), device=dev).batch(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    for _ in range(2):
        step(params, opt, batch)
    sync()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = step(params, opt, batch)
        sync()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    fams = {}
    for name, (n, ms) in kernels.items():
        f, (c, t) = family(name), fams.get(family(name), (0, 0.0))
        fams[f] = (c + n, t + ms)
    busy = sum(t for _, t in fams.values())
    print(f"{cfg.name} layers {cfg.n_layers} B {args.batch} T {args.seq} "
          f"{cfg.dtype} remat_aware: loss {m['loss']:.4f}; one step "
          f"{wall:.1f} ms under the profiler, "
          + (f"device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}"
             if kernels else "no device kernel: idle share not measured"))
    for f, (n, t) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        print(f"  {f:<40} {t:9.2f} ms {n:6d} launches {t / wall:.3f} of "
              "wall")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"    {t:9.2f} ms {n:6d} launches  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
