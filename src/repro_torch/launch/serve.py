"""Serving CLI: continuous-batching paged-KV serving of seeded random
prompts with seeded random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \
        [--prompt-len 128 --gen 16 --batch 4] [--window 64] \
        [--block-size 16 --n-blocks 0] [--temperature 0.8] \
        [--smoke --device cpu]

Weights and prompts come from seed 0; prefill runs in chunks of
``PREFILL_CHUNK`` tokens.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.config import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve.engine import Engine

PREFILL_CHUNK = 256
SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged pool size (0 = sized to the workload)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.window:
        cfg = cfg.replace(attn=dataclasses.replace(cfg.attn,
                                                   window=args.window))
    model = DecoderLM(cfg, device=args.device)
    params = model.init(SEED)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
    blocks_per_req = -(-(args.prompt_len + args.gen) // args.block_size)
    n_blocks = args.n_blocks or args.batch * (blocks_per_req + 4) + 2
    eng = Engine(model, params, max_batch=args.batch,
                 block_size=args.block_size, n_blocks=n_blocks,
                 prefill_chunk_tokens=PREFILL_CHUNK)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    if model.device.type == "cuda":        # nvcc at first use, not timed
        t0 = time.perf_counter()
        build.build_all()
        print(f"kernels built in {time.perf_counter() - t0:.1f}s")
    sync()
    t0 = time.perf_counter()
    toks = eng.generate({"tokens": prompts}, args.gen,
                        temperature=args.temperature)
    sync()
    dt = time.perf_counter() - t0
    s = eng.stats()
    print(f"arch={cfg.name} layers={cfg.n_layers} device={model.device} "
          f"batch={args.batch} prompt={args.prompt_len} generated="
          f"{args.gen} tokens in {dt:.3f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s) "
          f"[paged bs={args.block_size} pool={n_blocks} steps={s['steps']} "
          f"preempt={s['n_preemptions']} "
          f"prefill_chunks={s['prefill_chunks']}]")
    print("sampled token ids (first request):",
          [int(t) for t in toks[0][:16]])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
