"""Serving CLI: seeded random prompts served with seeded random weights,
by the paged continuous-batching engine or, with ``--fixed-slot``, by the
fixed-slot engine over a dense cache that can shard along the sequence.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-7b \
        [--prompt-len 128 --gen 16 --batch 4] [--window 64] \
        [--block-size 16 --n-blocks 0] [--temperature 0.8] \
        [--spec-depth 4 [--self-spec | --draft-config smollm-360m]] \
        [--smoke --device cpu]

    # the paged engine across P sequence ranks: every rank runs the same
    # engine over a pool sharded on the sequence axis (head-parallel when
    # the kv heads divide P, else block-sharded), the model replicated
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --smoke --device cpu --nproc 8 --seq-shards 8 [--spec-depth 4 \
        --self-spec]

    # long context: the prompt prefilled across P sequence ranks (the
    # balanced schedule), the cache sharded along the sequence, decode reduced
    # over the shards; a world this command spawns itself (gloo on the
    # CPU; on one GPU the ranks share it through host-staged transfers)
    PYTHONPATH=src python -m repro_torch.launch.serve --fixed-slot \
        --seq-shards 4 --nproc 4 --smoke --device cpu

    # or under torchrun, one GPU a rank (nccl)
    PYTHONPATH=src torchrun --nproc-per-node P -m repro_torch.launch.serve \
        --fixed-slot --seq-shards P

    # an MLA / MoE model through the fixed-slot engine: the whole-prompt
    # prefill with MLA materialised, a dense latent cache; across P ranks
    # the routed experts shard over the sequence ranks
    PYTHONPATH=src python -m repro_torch.launch.serve --fixed-slot \
        --arch deepseek-v2-lite-16b --smoke --device cpu \
        [--nproc 4 --seq-shards 4]

    # DeepSeek-V3 serves as a deepseek model, through either engine: its
    # multi-token prediction block is loaded and unused
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --smoke --device cpu [--fixed-slot] \
        [--nproc 4 --seq-shards 4]

    # the vision-language model (256 image rows before each prompt) and
    # the encoder-decoder (a clip of 1,536 frames beside it) serve through
    # the fixed-slot engine alone (the paged engine refuses them)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \
        --smoke --device cpu [--nproc 4 --seq-shards 4]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --smoke --device cpu [--nproc 4 --seq-shards 4]

    # and through the paged engine across P ranks: the latent pool
    # block-sharded, each chunk's MoE rows split over the ranks, decode
    # summing the ranks' experts
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu \
        --nproc 4 --seq-shards 4 [--spec-depth 3 --self-spec]

The ranks form a ``(data, model)`` mesh with ``--seq-shards`` ranks on
the sequence-parallel ``model`` axis (``--mesh local``; ``production`` is
the reference's 16 × 16 grid).  With ``--fixed-slot``, a batch that
divides over ``data`` is split between the data replicas; one that does
not folds ``data`` into the cache's sequence sharding, as the reference's
``long_500k``.  The paged engine runs batch-replicated over the ranks.
Every rank prints the same tokens; rank 0 reports.  Weights and prompts come
from seed 0; the paged engine prefills in chunks of ``PREFILL_CHUNK``
tokens, and a pool sized to the workload rounds up to a multiple of
``--seq-shards`` blocks, so that it shards by blocks where it cannot by
heads.  ``--spec-depth K`` serves speculatively, K draft tokens verified a
step: ``--self-spec`` drafts by n-gram prompt lookup, otherwise a draft
model (``--draft-config``, default the pairing of ``configs/spec_pairs.py``)
with weights from seed ``DRAFT_SEED``.  A VLM's image rows and an
encoder–decoder's frames are standard normals from seed 0 (``--prompt-len``
counts the text tokens).  Runs on ``cuda`` unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.spec_pairs import draft_arch_for
from repro_torch.core.config import ShapeSpec, get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.launch.mesh import MESHES, named_mesh
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import DecoderLM, build_model
from repro_torch.parallel.comm import init_world
from repro_torch.parallel.sharding import make_parallel_config
from repro_torch.serve import prng
from repro_torch.serve.engine import Engine, FixedSlotEngine
from repro_torch.serve.speculative import ModelDraft, SpecConfig

PREFILL_CHUNK = 256
SEED = 0
DRAFT_SEED = 7


def _parser():
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
    ap.add_argument("--fixed-slot", action="store_true",
                    help="the fixed-slot engine over a dense cache")
    ap.add_argument("--mesh", default="local", choices=tuple(MESHES))
    ap.add_argument("--seq-shards", type=int, default=1)
    ap.add_argument("--nproc", type=int, default=1,
                    help="spawn this many ranks (not under torchrun)")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="speculative draft depth (0 = vanilla decode)")
    ap.add_argument("--self-spec", action="store_true",
                    help="n-gram prompt-lookup drafts (no draft model)")
    ap.add_argument("--draft-config", default=None,
                    help="draft arch id (default: configs/spec_pairs.py)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.spec_depth and args.fixed_slot:
        raise SystemExit("--spec-depth serves through the paged engine")
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
    if args.window:
        cfg = cfg.replace(attn=dataclasses.replace(cfg.attn,
                                                   window=args.window))
    mesh = named_mesh(args.mesh, args.seq_shards, args.device)
    shape = ShapeSpec("cli", args.prompt_len, args.batch, "decode")
    par = make_parallel_config(mesh, shape)
    model = build_model(cfg, device=args.device, par=par, mesh=mesh)
    lead = mesh.world.rank == 0
    params = model.init(SEED)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    batch = {"tokens": prompts}
    extra = {"vlm": ("image_embeds", cfg.n_image_tokens),
             "audio": ("frames", cfg.n_audio_frames)}.get(cfg.arch_type)
    if extra is not None:                   # the stub frontend's rows
        batch[extra[0]] = torch.from_numpy(rng.standard_normal(
            (args.batch, extra[1], cfg.d_model)).astype(np.float32)).to(
            device=args.device, dtype=model.dtype)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    if model.device.type == "cuda":        # nvcc at first use, not timed
        t0 = time.perf_counter()
        build.build_all()
        if lead:
            print(f"kernels built in {time.perf_counter() - t0:.1f}s")
    sync()
    t0 = time.perf_counter()
    if args.fixed_slot or extra is not None:
        toks, _ = FixedSlotEngine(model, params).generate(
            batch, args.gen, rng=prng.prng_key(SEED),
            temperature=args.temperature)
        toks = toks.cpu().numpy()
        how = (f"fixed-slot mesh={dict(zip(mesh.axis_names, mesh.shape))} "
               f"schedule={model.par.schedule} cache shards="
               f"{1 if model.decode_group is None else model.decode_group.size}"
               f" transport={mesh.transport}")
    else:
        blocks_per_req = -(-(args.prompt_len + args.gen + args.spec_depth)
                           // args.block_size)
        P = args.seq_shards
        n_blocks = args.n_blocks or -(-(args.batch * (blocks_per_req + 4)
                                        + 2) // P) * P
        spec, draft = _speculation(args, cfg, n_blocks)
        eng = Engine(model, params, max_batch=args.batch,
                     block_size=args.block_size, n_blocks=n_blocks,
                     prefill_chunk_tokens=PREFILL_CHUNK, spec=spec,
                     draft=draft)
        toks = eng.generate({"tokens": prompts}, args.gen,
                            temperature=args.temperature)
        s = eng.stats()
        how = (f"paged bs={args.block_size} pool={n_blocks} "
               f"pool sharding={eng.cache.sharding} "
               f"steps={s['steps']} preempt={s['n_preemptions']} "
               f"prefill_chunks={s['prefill_chunks']}")
        if spec is not None:
            how += (f"; speculative mode={spec.mode} depth={spec.depth} "
                    f"proposed={s['spec_proposed']} accepted="
                    f"{s['spec_accepted']} rollbacks={s['spec_rollbacks']} "
                    f"acceptance={s['spec_acceptance']:.2f} tokens/step="
                    f"{s['decode_tokens'] / max(s['decode_steps'], 1):.2f}")
    sync()
    dt = time.perf_counter() - t0
    if lead:
        print(f"arch={cfg.name} layers={cfg.n_layers} device={model.device}"
              f" batch={args.batch} prompt={args.prompt_len} generated="
              f"{args.gen} tokens in {dt:.3f}s "
              f"({args.gen * args.batch / dt:.1f} tok/s) [{how}]")
        print("sampled token ids (first request):",
              [int(t) for t in toks[0][:16]], flush=True)
    return 0


def _speculation(args, cfg, n_blocks):
    """(SpecConfig, draft) for the paged engine, or (None, None)."""
    if args.spec_depth <= 0:
        return None, None
    if args.self_spec:
        return SpecConfig(depth=args.spec_depth, mode="ngram"), None
    d_arch = args.draft_config or draft_arch_for(cfg.name)
    if d_arch is None:
        raise SystemExit(f"no draft pairing for {cfg.name!r}; pass "
                         f"--draft-config or --self-spec")
    d_cfg = get_config(d_arch)
    if args.smoke:
        d_cfg = smoke_config(d_cfg)
    d_model = DecoderLM(d_cfg, device=args.device)
    draft = ModelDraft(d_model, d_model.init(DRAFT_SEED),
                       block_size=args.block_size, n_blocks=n_blocks,
                       max_batch=args.batch)
    return SpecConfig(depth=args.spec_depth, mode="model",
                      draft_arch=d_cfg.name), draft


if __name__ == "__main__":
    raise SystemExit(main())
