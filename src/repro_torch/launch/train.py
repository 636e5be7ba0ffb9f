"""Training CLI: a decoder trained on the synthetic token stream, on one
process or across ranks — a dense model, an MLA + MoE one
(``--arch deepseek-v2-lite-16b``, whose loss adds the MoE load-balance
``aux`` to ``ce``; both are printed), its routed experts sharded over the
sequence ranks, DeepSeek-V3 (``--arch deepseek-v3-671b``, whose loss adds
0.3 · ``mtp_ce``, its multi-token prediction block's cross-entropy, printed
beside them; zigzag falls back to balanced), or an SSM or hybrid one (``--arch mamba2-2.7b`` /
``zamba2-2.7b``: each rank scans its contiguous shard and the ranks relay
the recurrent state; zigzag falls back to balanced), the vision-language
``internvl2-2b`` (``--seq`` counts its 256 image positions, 16 at
``--smoke``) or the encoder–decoder ``whisper-tiny`` (``--seq`` decoder
tokens beside each clip's 1,536 frames, 64 at ``--smoke``; the encoder
runs whole on every rank).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-gqa \
        --smoke --steps 50 --seq 256 --batch 4 [--remat remat_aware] \
        [--ckpt-dir ckpts/run0 --ckpt-every 10] [--device cpu]

    # P sequence-parallel ranks under torchrun (one GPU each: nccl)
    PYTHONPATH=src torchrun --nproc-per-node P -m repro_torch.launch.train \
        --seq-shards P --schedule balanced

    # or a world this command spawns itself (gloo on the CPU; on one GPU
    # the ranks share it through host-staged transfers)
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 \
        --seq-shards 4 --schedule balanced --smoke --device cpu

    # DeepSeek-V2-Lite (MLA + MoE), one rank or 4 (experts 16 a rank)
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --device cpu --steps 4 \
        [--nproc 4 --seq-shards 4]

    # DeepSeek-V3 with MTP (the t + 2 rows cross the shard edges)
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v3-671b --smoke --device cpu --steps 4 --seq 64 \
        --batch 2 [--nproc 4 --seq-shards 4]

    # Mamba2 / Zamba2 (the SSD state relayed across the ranks)
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
        --smoke --device cpu --steps 4 --seq 64 --batch 2 \
        [--nproc 4 --seq-shards 4]

    # InternVL2-2B (image rows before the text) / Whisper-tiny
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \
        --smoke --device cpu --steps 4 --seq 64 --batch 2 \
        [--nproc 4 --seq-shards 4 --schedule zigzag]
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --smoke --device cpu --steps 4 --seq 64 --batch 2 \
        [--nproc 4 --seq-shards 4]

The ranks form a ``(data, model)`` mesh with ``--seq-shards`` ranks on
the sequence-parallel ``model`` axis (``--mesh local``; ``production`` is
the reference's 16 × 16 grid).  Weights come from seed 0 and batches
from ``SyntheticTokens`` (seed 0), each rank taking its shard.  Runs on
``cuda`` unless ``--device cpu`` is given.

The parameters and AdamW moments shard over ``data`` (FSDP, ZeRO-3:
``parallel/fsdp.py``, the reference's ``param_shardings``), each weight
gathered when its layer runs; rank 0 prints each rank's parameter and
moment bytes.  ``--nproc 4 --seq-shards 2`` trains on (data 2, model 2):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-gqa \
        --smoke --device cpu --steps 4 --seq 64 --batch 2 --nproc 4 \
        --seq-shards 2

With ``--ckpt-dir``, ``{"params": ...}`` is saved there in the reference's
tree layout and checkpoint format (``io/checkpoint.py``; layers stacked on
a leading axis, ``models.transformer.to_reference_params``) every
``--ckpt-every`` steps and after the last step; on a mesh the routed
experts' shards are gathered first (the global tree: the bytes of a
one-rank checkpoint of the same parameters: the FSDP shards are
gathered too, ``parallel/fsdp.full_tree``) and rank 0 writes.  There is
no resume, as in the reference.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.config import (ShapeSpec, TrainConfig, get_config,
                                     smoke_config)
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.io import checkpoint as ckpt_io
from repro_torch.kernels import build
from repro_torch.launch.mesh import MESHES, named_mesh
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import (build_model, to_reference_params,
                                            trainable)
from repro_torch.optim import adamw
from repro_torch.parallel.comm import init_world
from repro_torch.parallel.sharding import make_parallel_config
from repro_torch.train.step import make_train_step

SEED = 0


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
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
    mesh = named_mesh(args.mesh, args.seq_shards, args.device)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    par = make_parallel_config(mesh, shape, schedule=args.schedule,
                               remat=args.remat)
    model = build_model(cfg, device=args.device, par=par, mesh=mesh,
                        fsdp=True)
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
    _say_bytes(mesh, model, params, opt, lead)
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
            mtp = f" mtp_ce {m['mtp_ce']:.4f}" if "mtp_ce" in m else ""
            print(f"step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} aux "
                  f"{m['aux']:.6f}{mtp} lr {m['lr']:.2e} "
                  f"gnorm {m['gnorm']:.2f} "
                  f"tok/s {tok_s:.0f}"
                  + (f" skipped {n_skipped}" if n_skipped else ""),
                  flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, model, params, i + 1, lead)
    if args.ckpt_dir:
        _save(args.ckpt_dir, model, params, args.steps, lead)
        if lead:
            print(f"saved checkpoint to {args.ckpt_dir}", flush=True)
    return 0


def _say_bytes(mesh, model, params, opt, lead):
    """Print each rank's parameter and moment bytes (its shards under
    FSDP), gathered to rank 0."""
    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))
    mine = torch.tensor([float(nbytes(params)),
                         float(nbytes(opt.m) + nbytes(opt.v))])
    got = mesh.world.all_gather(mine.to(model.device)[None], 0).cpu()
    if lead:
        fs = model.fsdp
        how = "replicated" if fs is None else (
            f"FSDP shards over {'/'.join(model.par.fsdp_axes)} "
            f"({fs.group.size} ranks)")
        print(f"parameters {how}; bytes a rank (parameters / moments): "
              + ", ".join(f"{int(p)}/{int(m)}" for p, m in got.tolist()),
              flush=True)
        if fs is not None and model.par.remat == "none":
            print("remat none: autograd keeps each layer's gathered "
                  "weights until its backward (only the checkpointing "
                  "policies drop them after use)", flush=True)


def _save(path, model, params, step, lead):
    """The global parameter tree, written by rank 0 (every rank of the
    expert group and of the FSDP group takes part in gathering the
    shards)."""
    if not lead and model.expert_group is None and model.fsdp is None:
        return
    tree = {"params": to_reference_params(params,
                                          experts=model.expert_group,
                                          fsdp=model.fsdp)}
    if lead:
        ckpt_io.save(path, tree, step=step)


if __name__ == "__main__":
    raise SystemExit(main())
