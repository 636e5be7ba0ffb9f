"""Training CLI: a dense decoder trained on the synthetic token stream,
on one process or across ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-gqa \
        --smoke --steps 50 --seq 256 --batch 4 [--remat remat_aware] \
        [--device cpu]

    # P sequence-parallel ranks under torchrun (one GPU each: nccl)
    PYTHONPATH=src torchrun --nproc-per-node P -m repro_torch.launch.train \
        --seq-shards P --schedule balanced

    # or a world this command spawns itself (gloo on the CPU; on one GPU
    # the ranks share it through host-staged transfers)
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 \
        --seq-shards 4 --schedule balanced --smoke --device cpu

The ranks form a ``(data, model)`` mesh with ``--seq-shards`` ranks on
the sequence-parallel ``model`` axis (``--mesh local``; ``production`` is
the reference's 16 × 16 grid).  Weights come from seed 0 and batches
from ``SyntheticTokens`` (seed 0), each rank taking its shard.  Runs on
``cuda`` unless ``--device cpu`` is given.  The checkpoint flags come with
the checkpoint module.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.config import (ShapeSpec, TrainConfig, get_config,
                                     smoke_config)
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import DecoderLM, trainable
from repro_torch.optim import adamw
from repro_torch.parallel.comm import init_world
from repro_torch.parallel.sharding import make_parallel_config
from repro_torch.train.step import make_train_step

SEED = 0
MESHES = {"local": None, "production": (16, 16)}


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="balanced",
                    choices=("balanced", "ring", "zigzag", "ulysses"))
    ap.add_argument("--remat", default="remat_aware",
                    choices=("remat_aware", "hf", "none"))
    ap.add_argument("--mesh", default="local", choices=tuple(MESHES))
    ap.add_argument("--seq-shards", type=int, default=1)
    ap.add_argument("--nproc", type=int, default=1,
                    help="spawn this many ranks (not under torchrun)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.nproc > 1 and not dist.is_initialized():
        if torch.device(args.device).type == "cuda":
            build.build_all()            # once, before the ranks start
        spawn(_rank_main, args.nproc, (argv,), device=args.device,
              timeout=None)
        return 0
    if "RANK" in os.environ and not dist.is_initialized():
        init_world(args.device)          # torchrun's environment
    return run(args)


def _rank_main(rank, argv):
    return run(_parser().parse_args(argv))


def run(args) -> int:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if MESHES[args.mesh] is None:
        mesh = make_local_mesh(seq=args.seq_shards, device=args.device)
    else:
        data, seq = MESHES[args.mesh]
        mesh = make_local_mesh(seq=seq, data=data, device=args.device)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    par = make_parallel_config(mesh, shape, schedule=args.schedule,
                               remat=args.remat)
    model = DecoderLM(cfg, device=args.device, par=par, mesh=mesh)
    lead = mesh.world.rank == 0
    if lead:
        axes = dict(zip(mesh.axis_names, mesh.shape))
        print(f"arch={cfg.name} params≈{cfg.param_count() / 1e6:.1f}M "
              f"device={model.device} mesh={axes} schedule={args.schedule} "
              f"remat={args.remat} transport={mesh.transport}", flush=True)
    if model.device.type == "cuda":        # nvcc at first use, not timed
        build.build_all()

    params = trainable(model.init(SEED))
    opt = adamw.init(params)
    tc = TrainConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)
    step = make_train_step(model, tc)
    ds = SyntheticTokens(cfg, shape, device=args.device, seed=SEED,
                         mesh=mesh, par=par)

    t0 = time.time()
    n_skipped = 0
    for i in range(args.steps):
        m = step(params, opt, ds.batch(i))
        if m["skipped_nonfinite"]:
            if n_skipped == 0 and lead:
                print(f"step {i:5d} non-finite loss/grads — optimizer "
                      f"update skipped (params untouched); further skips "
                      f"counted silently", flush=True)
            n_skipped += 1
        if (i % args.log_every == 0 or i == args.steps - 1) and lead:
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            dt = time.time() - t0
            tok_s = (i + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {i:5d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
                  f"gnorm {m['gnorm']:.2f} tok/s {tok_s:.0f}"
                  + (f" skipped {n_skipped}" if n_skipped else ""),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
