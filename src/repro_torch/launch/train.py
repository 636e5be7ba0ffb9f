"""Training CLI: a dense decoder trained on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-gqa \
        --smoke --steps 50 --seq 256 --batch 4 [--remat remat_aware] \
        [--device cpu]

Weights come from seed 0 and batches from ``SyntheticTokens`` (seed 0).
The run takes one card, with no sequence-parallel axis: the reference's
``--schedule``, ``--mesh`` and ``--seq-shards`` come with the multi-rank
schedules slice.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.config import (ParallelConfig, ShapeSpec, TrainConfig,
                                     get_config, smoke_config)
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import build
from repro_torch.models.transformer import DecoderLM, trainable
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="remat_aware",
                    choices=("remat_aware", "hf", "none"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    model = DecoderLM(cfg, device=args.device,
                      par=ParallelConfig(remat=args.remat))
    print(f"arch={cfg.name} params≈{cfg.param_count() / 1e6:.1f}M "
          f"device={model.device} remat={args.remat}")
    if model.device.type == "cuda":        # nvcc at first use, not timed
        build.build_all()

    params = trainable(model.init(SEED))
    opt = adamw.init(params)
    tc = TrainConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps)
    step = make_train_step(model, tc)
    ds = SyntheticTokens(cfg, shape, device=args.device, seed=SEED)

    t0 = time.time()
    n_skipped = 0
    for i in range(args.steps):
        m = step(params, opt, ds.batch(i))
        if m["skipped_nonfinite"]:
            if n_skipped == 0:
                print(f"step {i:5d} non-finite loss/grads — optimizer "
                      f"update skipped (params untouched); further skips "
                      f"counted silently", flush=True)
            n_skipped += 1
        if i % args.log_every == 0 or i == args.steps - 1:
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
