#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100

Phases, each fatal on failure (nothing is caught):

  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``.
  3. kernels  — each kernel's wrapper against its plain PyTorch version on
                the card, at llama-7b serving and training shapes plus edge
                cases; tolerances: forward float32 1e-5 (paged 2e-5), bf16
                2e-2; backward (kernels C and D) float32 2e-4, bf16 5e-2,
                and the pruned sweep equal to the dense one within 1e-6.
                bf16 outputs of A, C and D are also held element by element
                to 3e-2 of their own size (``rel_err``).
  4. serve    — llama-7b at full width and depth (32 layers, d_model 4096,
                32 heads × 128, bf16, seeded random weights made on the
                card) through the paged engine: 4 prompts of 1000, 700, 513
                and 64 tokens, 32 greedy tokens each.  Both kernels must
                have launched during the run; the last decode logits of the
                longest request are held against a plain whole-context
                forward of the same model that calls the plain attention,
                and the limit must reject two deliberately wrong forwards
                (one position off; the oldest cache block hidden).  Prefill and decode seconds come from the engine's own
                CUDA-event spans.
  6. train    — llama-7b's width (d_model 4096, 32 heads × 128, d_ff 11008,
                vocab 32000, bf16) at depth 8, one sequence of 8192 tokens:
                4 steps of ``make_train_step`` under ``remat_aware`` on
                ``SyntheticTokens`` (seed 0, lr 1e-4).  Kernels A, C and D
                must each launch 8 times per step, every loss be finite and
                no step be skipped; then 1 step under ``hf``, which must
                launch A 16 times, and 1 under ``none``, both giving step
                1's loss again; peak memory per policy.  A torch.profiler
                window over one more step shows where the time goes, and
                that step's attention inputs are kept for 6a and 5.
  6a. main    — kernels A, C and D on those inputs (T 8192), against their
                plain versions head slice by head slice, to the phase-3
                limits; the relative limit must reject a plain backward
                that never visits the last 64-key tile.
  6b. grads   — at 2 layers and T 1024, full width: per leaf, max |Δg|
                between the kernels and the plain attention is at most 5%
                of the leaf's max |g|, and the same limit rejects a plain
                backward whose causal mask is shifted by one position.
  5. times    — each kernel at the shapes of its path (C and D on the
                inputs kept in phase 6): its time (CUDA events, median
                after warm-up), its plain version's at the same shape, a
                library call's where one exists (for C and D, SDPA's
                backward of the pair, marked ``library_covers``), and the
                least time the card could take.

Prints the ``{"kernels": [...]}`` line second to last and
``{"ok": true, "device": {...}}`` last.  Exits non-zero with no result when
there is no CUDA device or the port is not beside this file.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import mask as mk  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    ParallelConfig, ShapeSpec, TrainConfig, get_config)
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttnFn, _BwdPlan, _launch_dkv, _launch_dq, flash_bwd, flash_fwd)
from repro_torch.kernels.paged import paged_attn, paged_attn_ref  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    NEG_INF, chunk_attn_bwd_ref, chunk_attn_ref)
from repro_torch.models.transformer import DecoderLM, trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# bf16 outputs are also held element by element to their own size (see
# rel_err): two bf16 roundings of one float32 value differ by at most 2^-7
# of it, and a sweep that skips a 64-key tile moves small outputs (late
# rows, last keys) by far more than that.
REL_TOL, REL_FLOOR = 3e-2, 1e-3
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
LOGIT_REL_TOL = 5e-2          # bf16, 32 layers: |Δ| ≤ 5% of max |logit|
GRAD_REL_TOL = 5e-2           # bf16 grads: |Δg| ≤ 5% of the leaf's max |g|
TRAIN_LAYERS, TRAIN_T, TRAIN_STEPS = 8, 8192, 4
DEV = torch.device("cuda", 0)


def say(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the device (CUDA events)."""
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
    return float(np.median(times))


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def rel_err(a, r):
    """max |a - r| / (|r| + REL_FLOOR · max |r|) over the elements: the
    error in units of each element's own size.  The floor keeps float32
    summation noise on outputs that cancel to ~0 from dominating."""
    a, r = a.float(), r.float()
    floor = REL_FLOOR * r.abs().max().clamp_min(1e-30)
    return float(((a - r).abs() / (r.abs() + floor)).max())


# ----------------------------------------------------------------- phase 3

def _flash_case(gen, name, B, Tq, Tk, Hq, Hkv, D, dtype, mask, segs=False):
    q = randn(gen, (B, Tq, Hq, D), dtype)
    k = randn(gen, (B, Tk, Hkv, D), dtype)
    v = randn(gen, (B, Tk, Hkv, D), dtype)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    o, lse = flash_fwd(q, k, v, mask=mask, **kw)
    torch.cuda.synchronize()
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, **kw)
    err = float((o.float() - o_r.float()).abs().max())
    tol = TOL[dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"flash_fwd {name}: o err {err} over {tol}")
    valid = (lse_r > NEG_INF / 2) | (lse > NEG_INF / 2)
    check(bool(valid.any()), f"flash_fwd {name}: every row is empty")
    lerr = float((lse - lse_r).abs()[valid].max())
    check(lerr <= LSE_TOL * (1 + float(lse_r[valid].abs().max())),
          f"flash_fwd {name}: lse err {lerr}")
    check(bool(torch.isfinite(o.float()).all()),
          f"flash_fwd {name}: non-finite")
    rel = ""
    if dtype == torch.bfloat16:
        r = rel_err(o, o_r)
        check(r <= REL_TOL, f"flash_fwd {name}: relative err {r} over "
              f"{REL_TOL}")
        rel = f"  rel {r:.2e} (limit {REL_TOL})"
    say(f"  A {name:<28} {str(dtype)[6:]:<9} max|Δo| {err:.3e}  "
        f"max|Δlse| {lerr:.3e}  tol {tol}{rel}")


def _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs, lengths, dtype):
    lengths = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    nb = int(-(-int(lengths.max()) // bs)) + 2
    N = B * nb + 8
    q = randn(gen, (B, Tq, Hq, D), dtype)
    kp = randn(gen, (N, bs, Hkv, D), dtype)
    vp = randn(gen, (N, bs, Hkv, D), dtype)
    # fragmented, out-of-order tables; entries past each length are null
    perm = torch.randperm(N - 1, generator=gen, device=DEV)[:B * nb] + 1
    table = perm.reshape(B, nb).to(torch.int32)
    for b in range(B):
        table[b, -(-int(lengths[b]) // bs):] = 0
    return q, kp, vp, table.contiguous(), lengths


def _paged_case(gen, name, B, Tq, Hq, Hkv, D, bs, lengths, window, dtype):
    q, kp, vp, bt, lens = _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs, lengths,
                                        dtype)
    mask = mk.sliding_window(window) if window else mk.causal()
    o = paged_attn(q, kp, vp, bt, lens, mask=mask)
    torch.cuda.synchronize()
    o_r = paged_attn_ref(q, kp, vp, bt, lens, mask=mask)
    err = float((o.float() - o_r.float()).abs().max())
    tol = PAGED_TOL[dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"paged_decode {name}: err {err} over {tol}")
    say(f"  B {name:<28} {str(dtype)[6:]:<9} max|Δo| {err:.3e}  tol {tol}")


def kernel_checks():
    gen = torch.Generator(device=DEV).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    # kernel A at llama-7b prefill shapes (Hq = Hkv = 32, D = 128) + edges
    _flash_case(gen, "causal Tq256 Tk1024 q_off768", 1, 256, 1024, 32, 32,
                128, bf, mk.causal(rel_offset=768))
    _flash_case(gen, "sliding_window 300", 1, 256, 1024, 32, 32, 128, bf,
                mk.sliding_window(300, rel_offset=768))
    _flash_case(gen, "gqa Hkv8", 1, 256, 1024, 32, 8, 128, bf,
                mk.causal(rel_offset=768))
    _flash_case(gen, "ragged Tq100 Tk1000", 1, 100, 1000, 32, 32, 128, bf,
                mk.causal(rel_offset=900))
    _flash_case(gen, "d64", 2, 256, 512, 8, 4, 64, f32,
                mk.causal(rel_offset=256))
    _flash_case(gen, "prefix_lm d32", 1, 192, 192, 4, 2, 32, f32,
                mk.prefix_lm(70))
    _flash_case(gen, "document boundaries", 1, 256, 256, 4, 4, 64, f32,
                mk.document(boundaries=(0, 37, 150, 151)))
    _flash_case(gen, "document segments", 2, 128, 256, 4, 2, 32, f32,
                mk.document(), segs=True)
    _flash_case(gen, "full kv_offset", 1, 64, 200, 4, 4, 32, f32,
                mk.MaskSpec(q_offset=10, kv_offset=3))
    # pruned == dense sweep to 1e-6
    q, k, v = (randn(gen, (1, 256, 4, 64), f32) for _ in range(3))
    m = mk.sliding_window(70)
    o1, l1 = flash_fwd(q, k, v, mask=m)
    o2, l2 = flash_fwd(q, k, v, mask=m, prune=False)
    d = float((o1 - o2).abs().max())
    check(d <= 1e-6, f"flash_fwd pruned vs dense: {d}")
    say(f"  A {'pruned == dense':<28} float32   max|Δo| {d:.3e}  tol 1e-06")
    # statically fully masked chunk: zeros and NEG_INF without a launch
    n0 = build.LAUNCHES["flash_fwd"]
    o, lse = flash_fwd(q, k, v, mask=mk.causal(rel_offset=-1000))
    check(build.LAUNCHES["flash_fwd"] == n0 and float(o.abs().max()) == 0
          and bool((lse == NEG_INF).all()), "empty chunk launched")
    # kernel B: B = 4, bs = 16, fragmented tables, mixed lengths incl. 1
    lens = [1, 700, 513, 1032]
    _paged_case(gen, "Tq1", 4, 1, 32, 32, 128, 16, lens, 0, bf)
    _paged_case(gen, "Tq4", 4, 4, 32, 32, 128, 16, lens, 0, bf)
    _paged_case(gen, "window 256", 4, 1, 32, 32, 128, 16, lens, 256, bf)
    _paged_case(gen, "gqa Hkv8 Tq4", 4, 4, 32, 8, 128, 16, lens, 0, bf)
    _paged_case(gen, "gqa d64 window", 4, 3, 8, 2, 64, 8, [2, 5, 40, 77],
                20, f32)
    _paged_case(gen, "d32 bs64", 4, 1, 4, 4, 32, 64, lens, 0, f32)


def _bwd_case(gen, name, B, Tq, Tk, Hq, Hkv, D, dtype, mask, segs=False,
              pass_delta=False):
    """Kernels C and D against the plain backward on the same saved (o,
    lse), and the pruned sweep against the dense one."""
    q = randn(gen, (B, Tq, Hq, D), dtype)
    k = randn(gen, (B, Tk, Hkv, D), dtype)
    v = randn(gen, (B, Tk, Hkv, D), dtype)
    do = randn(gen, (B, Tq, Hq, D), dtype)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    o, lse = chunk_attn_ref(q, k, v, mask=mask, **kw)
    if pass_delta:
        kw["delta"] = (o.float() * do.float()).sum(-1)
    n0 = (build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"])
    got = flash_bwd(q, k, v, o, lse, do, mask=mask, **kw)
    torch.cuda.synchronize()
    check((build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"])
          == (n0[0] + 1, n0[1] + 1), f"flash_bwd {name}: launches")
    ref = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=mask, **kw)
    dense = flash_bwd(q, k, v, o, lse, do, mask=mask, prune=False, **kw)
    tol = BWD_TOL[dtype]
    errs, rels = [], []
    for nm, a, r, d in zip(("dq", "dk", "dv"), got, ref, dense):
        check(a.shape == r.shape and a.dtype == r.dtype,
              f"flash_bwd {name}: {nm} {tuple(a.shape)} {a.dtype}")
        check(bool(torch.isfinite(a.float()).all()),
              f"flash_bwd {name}: {nm} non-finite")
        err = float((a.float() - r.float()).abs().max())
        check(torch.allclose(a.float(), r.float(), atol=tol, rtol=tol),
              f"flash_bwd {name}: {nm} err {err} over {tol}")
        pd = float((a.float() - d.float()).abs().max())
        check(pd <= 1e-6, f"flash_bwd {name}: {nm} pruned vs dense {pd}")
        errs.append(err)
        if dtype == torch.bfloat16:
            rels.append(rel_err(a, r))
            check(rels[-1] <= REL_TOL, f"flash_bwd {name}: {nm} relative "
                  f"err {rels[-1]} over {REL_TOL}")
    rel = (f"; rel {'/'.join(f'{x:.2e}' for x in rels)} (limit {REL_TOL})"
           if rels else "")
    say(f"  C/D {name:<26} {str(dtype)[6:]:<9} max|Δdq| {errs[0]:.3e}  "
        f"max|Δdk| {errs[1]:.3e}  max|Δdv| {errs[2]:.3e}  tol {tol}; "
        f"pruned == dense{rel}")


def bwd_checks():
    """Kernels C and D over the edge cases kernel A is held to, plus the
    training shape."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    _bwd_case(gen, "causal d128", 1, 256, 256, 4, 4, 128, f32, mk.causal())
    _bwd_case(gen, "sliding_window 70 d64", 1, 256, 256, 4, 1, 64, f32,
              mk.sliding_window(70))
    _bwd_case(gen, "prefix_lm 70 d32", 1, 192, 192, 4, 2, 32, f32,
              mk.prefix_lm(70))
    _bwd_case(gen, "document boundaries", 1, 256, 256, 4, 4, 64, f32,
              mk.document(boundaries=(0, 37, 150, 151)))
    _bwd_case(gen, "document segments gqa", 2, 128, 256, 4, 2, 32, f32,
              mk.document(), segs=True)
    _bwd_case(gen, "gqa Hkv2 Tq!=Tk offset", 2, 100, 300, 8, 2, 64, f32,
              mk.causal(rel_offset=200))
    _bwd_case(gen, "empty rows q_offset -64", 1, 128, 128, 2, 2, 32, f32,
              mk.causal(rel_offset=-64))
    _bwd_case(gen, "full kv_offset, delta in", 1, 64, 200, 4, 4, 32, f32,
              mk.MaskSpec(q_offset=10, kv_offset=3), pass_delta=True)
    _bwd_case(gen, "window gqa bf16", 1, 512, 512, 32, 8, 128, bf,
              mk.sliding_window(300))
    _bwd_case(gen, "train B1 T2048 H32 causal", 1, 2048, 2048, 32, 32, 128,
              bf, mk.causal())
    _bwd_case(gen, "train B1 T2048 H32 causal", 1, 2048, 2048, 32, 32, 128,
              f32, mk.causal())
    # statically fully masked chunk: zeros without a launch
    q = randn(gen, (1, 128, 2, 32), f32)
    m = mk.causal(rel_offset=-1000)
    o, lse = chunk_attn_ref(q, q, q, mask=m)
    n0 = build.LAUNCHES["flash_bwd_dq"] + build.LAUNCHES["flash_bwd_dkv"]
    g = flash_bwd(q, q, q, o, lse, q, mask=m)
    check(build.LAUNCHES["flash_bwd_dq"] + build.LAUNCHES["flash_bwd_dkv"]
          == n0 and all(float(x.abs().max()) == 0 for x in g),
          "empty chunk launched the backward")
    # the autograd glue: FlashAttnFn's gradients are flash_bwd's
    q, k, v = (randn(gen, (1, 128, 4, 64), f32).requires_grad_()
               for _ in range(3))
    do = randn(gen, (1, 128, 4, 64), f32)
    m = mk.causal()
    o, _ = FlashAttnFn.apply(
        q, k, v, lambda *a: flash_fwd(*a, mask=m),
        lambda *a: flash_bwd(*a, mask=m))
    got = torch.autograd.grad(o, (q, k, v), do)
    o_r, lse_r = chunk_attn_ref(q.detach(), k.detach(), v.detach(), mask=m)
    ref = chunk_attn_bwd_ref(q.detach(), k.detach(), v.detach(), o_r, lse_r,
                             do, mask=m)
    d = max(float((a - r).abs().max()) for a, r in zip(got, ref))
    check(d <= 2e-4, f"FlashAttnFn grads vs plain: {d}")
    say(f"  C/D {'FlashAttnFn autograd':<26} float32   max|Δ| {d:.3e}  "
        f"tol 0.0002")


# ----------------------------------------------------------------- phase 4

def serve():
    cfg = get_config("llama-7b")
    model = DecoderLM(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    say(f"  init {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.attn.n_heads}x{cfg.attn.head_dim} {cfg.dtype} "
        f"({cfg.param_count() / 1e9:.2f} B params) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens, n_new = [1000, 700, 513, 64], 32
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    kw = dict(max_batch=4, block_size=16, prefill_chunk_tokens=256,
              n_blocks=192)

    # warm-up (cuBLAS handles, allocator) on a short request
    warm = Engine(model, params, **kw)
    warm.submit(prompts[3], max_new_tokens=2)
    warm.run()
    del warm

    eng = Engine(model, params, record_logits=True, **kw)
    torch.cuda.synchronize()
    build.reset_launches()
    t_sub = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    ttft = {}
    while not eng.sched.idle:
        ev = eng.step()
        now = time.perf_counter()
        for rid in ev:
            ttft.setdefault(rid, now - t_sub)
    total = time.perf_counter() - t_sub
    launches = dict(build.LAUNCHES)
    out = {rid: np.asarray(eng.requests[rid].emitted) for rid in rids}
    st = eng.stats()
    spent = {"prefill": st["prefill_seconds"], "decode": st["decode_seconds"]}
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    for rid in rids:
        check(len(out[rid]) == n_new, f"request {rid} emitted {len(out[rid])}")
        check(bool(((out[rid] >= 0) & (out[rid] < cfg.vocab)).all()),
              f"request {rid}: token outside the vocabulary")
    say(f"  served {len(rids)} requests: prefill {st['prefill_tokens']} "
        f"tokens in {st['prefill_chunks']} chunks, decode "
        f"{st['decode_tokens']} tokens in {st['decode_steps']} steps, "
        f"{st['steps']} engine steps, {total:.3f} s")
    say(f"  launches on the main path: {launches}")
    say(f"  prefill {st['prefill_tokens'] / spent['prefill']:.1f} tok/s "
        f"({spent['prefill']:.3f} s), decode "
        f"{st['decode_tokens'] / spent['decode']:.1f} tok/s "
        f"({spent['decode']:.3f} s, "
        f"{1e3 * spent['decode'] / st['decode_steps']:.2f} ms/step)")
    say("  time to first token (ms, submit -> first token): "
        + ", ".join(f"{n}-token prompt {1e3 * ttft[r]:.1f}"
                    for n, r in zip(lens, rids)))

    # the longest request's last decode logits against a plain forward
    rid = rids[0]
    ctx = torch.from_numpy(np.concatenate([prompts[0], out[rid][:-1]])[None])
    ctx = ctx.to(DEV)
    ref = model.forward(params, ctx, last_only=True)[0, -1].float()
    got = eng.last_logits[rid]
    d = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), "non-finite serving logits")
    check(d <= LOGIT_REL_TOL * scale,
          f"serving logits vs plain forward: max|Δ| {d} > "
          f"{LOGIT_REL_TOL} × {scale}")
    say(f"  last logits of the {lens[0]}-token request vs plain forward: "
        f"max|Δ| {d:.4f} (max|logit| {scale:.3f}, tol {LOGIT_REL_TOL} × "
        f"max = {LOGIT_REL_TOL * scale:.4f}), argmax {int(got.argmax())} "
        f"vs {int(ref.argmax())}")
    logit_controls(model, params, ctx, ref, LOGIT_REL_TOL * scale)
    steps = max(st["decode_steps"], 1)
    say("== phase 4b: where the device time goes")
    trace(model, params, prompts)
    return dict(launches=launches, cfg=cfg,
                per_decode_step=launches["paged_decode"] / steps,
                per_chunk=launches["flash_fwd"] / max(st["prefill_chunks"], 1),
                prefill_tok_s=st["prefill_tokens"] / spent["prefill"],
                decode_tok_s=st["decode_tokens"] / spent["decode"],
                ttft_ms=[1e3 * ttft[r] for r in rids])


def _device_breakdown(prof, wall):
    """Device time by kernel family from a torch.profiler trace, and the
    share of the wall clock the device was busy."""
    from torch.autograd import DeviceType
    fam = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        name = ev.key
        key = ("kernel A flash_fwd" if "flash_fwd_kernel" in name else
               "kernel B paged_decode" if "paged_decode_kernel" in name else
               "kernel C flash_bwd_dq" if "flash_bwd_dq_kernel" in name else
               "kernel D flash_bwd_dkv" if "flash_bwd_dkv_kernel" in name else
               "matmul (cuBLAS)" if any(t in name.lower() for t in
                                        ("gemm", "gemv", "xmma", "cutlass",
                                         "splitk", "nvjet"))
               else "other (elementwise, copies, index_put)")
        n, t = fam.get(key, (0, 0.0))
        fam[key] = (n + ev.count, t + us / 1e3)
    busy = sum(t for _, t in fam.values())
    return fam, busy, 1e3 * wall


def trace(model, params, prompts):
    """torch.profiler over the first 4 engine steps (prefill-heavy) and 6
    decode-only steps of the same 4 requests."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(model, params, max_batch=4, block_size=16,
                 prefill_chunk_tokens=256, n_blocks=192)
    rids = [eng.submit(p, max_new_tokens=16) for p in prompts]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, cond in (("prefill steps 1-4", lambda i: i < 4),
                        ("6 decode-only steps", lambda i: i < 6)):
        if label.startswith("6"):
            while any(eng.requests[r].state != "decode" for r in rids):
                eng.step()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            i = 0
            while cond(i):
                eng.step()
                i += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        show_breakdown(label, prof, wall)


def show_breakdown(label, prof, wall):
    fam, busy, wall_ms = _device_breakdown(prof, wall)
    say(f"  trace {label}: wall {wall_ms:.1f} ms (under the profiler), "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for key, (n, t) in sorted(fam.items(), key=lambda kv: -kv[1][1]):
        say(f"    {key:<40} {t:9.2f} ms  {n:6d} launches  "
            f"{t / wall_ms:.3f} of wall")


def logit_controls(model, params, ctx, ref, limit):
    """Plain forwards with a deliberately wrong attention, held to the same
    limit, which must reject both: a path that is off by one position (the
    context without its last token), and one that hides the oldest cache
    block (16 keys) from the newest rows through a sliding window."""
    T = ctx.shape[1]
    short = model.forward(params, ctx[:, :-1], last_only=True)[0, -1].float()
    d_pos = float((short - ref).abs().max())
    check(d_pos > limit, f"logit limit {limit} does not reject an "
          f"off-by-one position (max|Δ| {d_pos})")
    cfg = model.cfg
    cut = DecoderLM(cfg.replace(attn=dataclasses.replace(
        cfg.attn, window=T - 16)), device=DEV)
    blk = cut.forward(params, ctx, last_only=True)[0, -1].float()
    d_blk = float((blk - ref).abs().max())
    check(d_blk > limit, f"logit limit {limit} does not reject a hidden "
          f"oldest block (max|Δ| {d_blk})")
    say(f"  controls, both rejected by the limit {limit:.4f}: off-by-one "
        f"position max|Δ| {d_pos:.4f}; oldest block hidden (window "
        f"{T - 16}) max|Δ| {d_blk:.4f}")


# ----------------------------------------------------------------- phase 6

BWD_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _capturing(seen):
    """The ``cuda`` backend, which also keeps the arguments of its first
    forward and first backward call in ``seen`` once ``seen["armed"]`` is
    set: the inputs the training path gives kernels A, C and D."""
    cuda = registry.get("cuda")

    def fwd(*a, **kw):
        if seen.get("armed"):
            seen.setdefault("fwd", (a, kw))
        return cuda.fwd(*a, **kw)

    def bwd(*a, **kw):
        if seen.get("armed"):
            seen.setdefault("bwd", (a, kw))
        return cuda.bwd(*a, **kw)
    return dataclasses.replace(cuda, fwd=fwd, bwd=bwd)


def _moved(call, dev):
    """A captured ``(args, kwargs)`` with its tensors on ``dev``."""
    a, kw = call
    to = (lambda x: x.to(dev) if torch.is_tensor(x) else x)
    return tuple(map(to, a)), {k: to(x) for k, x in kw.items()}


def _train_policy(cfg, policy, batches, tc, seen=None):
    """``len(batches)`` steps from the seed-0 init under ``policy``: losses,
    step seconds (CUDA events), launches and peak device memory.  With
    ``seen``, one more step runs under torch.profiler and leaves the inputs
    of its first attention forward (layer 1) and first attention backward
    (layer 8) in ``seen``, on the host."""
    model = DecoderLM(cfg, device=DEV, par=ParallelConfig(remat=policy),
                      impl=None if seen is None else _capturing(seen))
    params = trainable(model.init(seed=0))
    opt = adamw.init(params)
    step = make_train_step(model, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out = []
    for b in batches:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = step(params, opt, b)
        e.record()
        e.synchronize()
        out.append((m, s.elapsed_time(e) / 1e3))
    launches = {k: build.LAUNCHES[k] for k in BWD_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    if seen is not None:
        from torch.profiler import ProfilerActivity, profile
        seen["armed"] = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, opt, batches[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        show_breakdown(f"one {policy} training step", prof, wall)
        for k in ("fwd", "bwd"):
            seen[k] = _moved(seen[k], "cpu")
    del model, params, opt, step
    _free()
    return out, launches, peak


def train():
    """Phase 6: llama-7b's width at depth 8, T 8192, B 1, bf16."""
    cfg = get_config("llama-7b").replace(n_layers=TRAIN_LAYERS)
    L, T, n = TRAIN_LAYERS, TRAIN_T, TRAIN_STEPS
    tc = TrainConfig(lr=1e-4, warmup_steps=min(20, n // 5 + 1),
                     total_steps=n)
    ds = SyntheticTokens(cfg, ShapeSpec("chip", T, 1, "train"), device=DEV,
                         seed=0)
    batches = [ds.batch(i) for i in range(n)]
    say(f"  {cfg.name} width, {L} of 32 layers ({cfg.param_count() / 1e9:.2f}"
        f" B params), B 1 T {T}, bf16 params, fp32 moments, lr {tc.lr}")
    seen = {}
    runs, launches, peak = _train_policy(cfg, "remat_aware", batches, tc,
                                         seen=seen)
    for i, (m, sec) in enumerate(runs):
        check(m["skipped_nonfinite"] == 0, f"step {i + 1} was skipped")
        check(np.isfinite(m["loss"]), f"step {i + 1}: loss {m['loss']}")
        say(f"  remat_aware step {i + 1}: loss {m['loss']:.4f} gnorm "
            f"{m['gnorm']:.3f} lr {m['lr']:.2e} step {sec:.3f} s")
    tok_s = (n - 1) * T / sum(sec for _, sec in runs[1:])
    for k in BWD_KERNELS:
        check(launches[k] == L * n, f"remat_aware: {k} launched "
              f"{launches[k]} times in {n} steps, want {L} per step")
    say(f"  remat_aware: {tok_s:.1f} tokens/s over steps 2-{n}; launches "
        f"per step " + ", ".join(f"{k} {launches[k] / n:g}"
                                 for k in BWD_KERNELS)
        + f"; peak memory {peak / 2**30:.2f} GiB")
    peaks = {"remat_aware": peak}
    for policy, n_fwd in (("hf", 2 * L), ("none", L)):
        one, got, peaks[policy] = _train_policy(cfg, policy, batches[:1], tc)
        (m1, sec1), = one
        want = {"flash_fwd": n_fwd, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        check(got == want, f"{policy} launches {got}, want {want}")
        d = abs(m1["loss"] - runs[0][0]["loss"])
        check(d <= 1e-2 * abs(runs[0][0]["loss"]),
              f"{policy} step 1 loss {m1['loss']} vs remat_aware "
              f"{runs[0][0]['loss']}")
        say(f"  {policy} step 1: loss {m1['loss']:.4f} (|Δ| vs remat_aware "
            f"{d:.2e}), step {sec1:.3f} s; launches " + ", ".join(
                f"{k} {got[k]}" for k in BWD_KERNELS)
            + f"; peak memory {peaks[policy] / 2**30:.2f} GiB")
    return dict(launches=launches, losses=[m["loss"] for m, _ in runs],
                tok_s=tok_s, peaks=peaks, seen=seen)


HEAD_SLICE = 8      # heads per plain-version call at T 8192 (2.1 GB each
                    # (h, T, T) float32 tensor)


def _head_slices(q, k):
    """(q-head slice, kv-head slice) pairs covering every head."""
    g = q.shape[2] // k.shape[2]
    check(HEAD_SLICE % g == 0, f"head slice {HEAD_SLICE} splits a group")
    return [(slice(h, h + HEAD_SLICE), slice(h // g, (h + HEAD_SLICE) // g))
            for h in range(0, q.shape[2], HEAD_SLICE)]


def _bwd_slice(args, kw, sq, skv):
    """The backward's inputs restricted to one head slice."""
    q, k, v, o, lse, do = args
    kw = dict(kw)
    if kw.get("delta") is not None:
        kw["delta"] = kw["delta"][:, :, sq]
    return (q[:, :, sq], k[:, :, skv], v[:, :, skv], o[:, :, sq],
            lse[:, :, sq], do[:, :, sq]), kw


def main_path_checks(seen):
    """Kernels A, C and D on the inputs the training path gave them (B 1,
    T 8192, 32 heads × 128, bf16, causal), each held against its plain
    version head slice by head slice, and the same limits held to a plain
    backward that never visits the last 64-key tile, which they must
    reject."""
    (q, k, v), kw = _moved(seen["fwd"], DEV)
    check(kw["mask"] == mk.causal() and q.dtype == torch.bfloat16
          and q.shape == (1, TRAIN_T, 32, 128),
          f"training attention {kw['mask']} {q.dtype} {tuple(q.shape)}")
    o, lse = flash_fwd(q, k, v, **kw)
    e_o = r_o = e_lse = lse_max = 0.0
    for sq, skv in _head_slices(q, k):
        o_r, lse_r = chunk_attn_ref(q[:, :, sq], k[:, :, skv], v[:, :, skv],
                                    **kw)
        e_o = max(e_o, float((o[:, :, sq].float() - o_r.float()).abs()
                             .max()))
        r_o = max(r_o, rel_err(o[:, :, sq], o_r))
        e_lse = max(e_lse, float((lse[:, :, sq] - lse_r).abs().max()))
        lse_max = max(lse_max, float(lse_r.abs().max()))
    say(f"  A  layer-1 forward: max|Δo| {e_o:.3e} rel {r_o:.2e} (limit "
        f"{REL_TOL}), max|Δlse| {e_lse:.3e}")
    check(r_o <= REL_TOL and e_o <= TOL[torch.bfloat16],
          f"flash_fwd on the training path: o err {e_o}, rel {r_o}")
    check(e_lse <= LSE_TOL * (1 + lse_max),
          f"flash_fwd on the training path: lse err {e_lse}")
    del q, k, v, o, lse, o_r, lse_r
    args, kw = _moved(seen["bwd"], DEV)
    got = flash_bwd(*args, **kw)
    e_abs, e_rel, e_bad = [0.0] * 3, [0.0] * 3, None
    tol = BWD_TOL[torch.bfloat16]
    for sq, skv in _head_slices(args[0], args[1]):
        a_s, kw_s = _bwd_slice(args, kw, sq, skv)
        ref = chunk_attn_bwd_ref(*a_s, **kw_s)
        mine = (got[0][:, :, sq], got[1][:, :, skv], got[2][:, :, skv])
        for i, (a, r) in enumerate(zip(mine, ref)):
            check(torch.allclose(a.float(), r.float(), atol=tol, rtol=tol),
                  f"flash_bwd on the training path: output {i} over {tol}")
            e_abs[i] = max(e_abs[i], float((a.float() - r.float()).abs()
                                           .max()))
            e_rel[i] = max(e_rel[i], rel_err(a, r))
        if e_bad is None:             # the control, on the first slice
            q, k, v, o, lse, do = a_s
            cut = k.shape[1] - 64
            bq, bk, bv = chunk_attn_bwd_ref(q, k[:, :cut], v[:, :cut], o,
                                            lse, do, **kw_s)
            pad = torch.zeros_like(k[:, cut:])
            bad = (bq, torch.cat([bk, pad], 1), torch.cat([bv, pad], 1))
            e_bad = [rel_err(b, r) for b, r in zip(bad, ref)]
            del bad, bq, bk, bv
        del ref
    say(f"  C/D layer-8 backward: max|Δdq| {e_abs[0]:.3e} max|Δdk| "
        f"{e_abs[1]:.3e} max|Δdv| {e_abs[2]:.3e} (tol {tol}); rel dq/dk/dv "
        + "/".join(f"{x:.2e}" for x in e_rel) + f" (limit {REL_TOL}); "
        "control without the last kv tile: rel "
        + "/".join(f"{x:.2e}" for x in e_bad))
    check(max(e_rel) <= REL_TOL, f"flash_bwd on the training path: relative "
          f"errors {e_rel} over {REL_TOL}")
    check(min(e_bad) > REL_TOL, f"the limit {REL_TOL} does not reject a "
          f"backward without the last kv tile (rel {e_bad})")
    del got, args
    _free()
    return {"flash_bwd_dq": e_abs[0], "flash_bwd_dkv": max(e_abs[1:])}


def _shifted_backend():
    """A deliberately wrong attention backward: the plain one with the
    causal mask shifted by one position (each query also sees the next
    key).  The forward is the plain one."""
    ref = registry.get("ref")

    def bwd(q, k, v, o, lse, do, *, mask, **kw):
        return chunk_attn_bwd_ref(q, k, v, o, lse, do,
                                  mask=mask.replace(q_offset=mask.q_offset
                                                    + 1), **kw)
    return dataclasses.replace(ref, name="shifted", bwd=bwd)


def grad_check():
    """Phase 6b: per-leaf gradients of the kernels against the plain path
    at full width, 2 layers, T 1024; the limit must reject a shifted
    backward."""
    cfg = get_config("llama-7b").replace(n_layers=2)
    batch = SyntheticTokens(cfg, ShapeSpec("g", 1024, 1, "train"),
                            device=DEV).batch(0)
    base = DecoderLM(cfg, device=DEV).init(seed=0)

    def grads(impl):
        model = DecoderLM(cfg, device=DEV, impl=impl)
        params = trainable(base)
        loss, _ = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(loss,
                                                         leaves(params))

    def worst(gs, ref):
        """Largest per-leaf max |Δg| / max |g_ref|."""
        return max(float((a.float() - r.float()).abs().max())
                   / float(r.float().abs().max()) for a, r in zip(gs, ref))

    l_ref, g_ref = grads("ref")
    l_cuda, g_cuda = grads("cuda")
    ok = worst(g_cuda, g_ref)
    check(ok <= GRAD_REL_TOL, f"kernel grads vs plain: worst leaf {ok:.4f} "
          f"of its max |g|, over {GRAD_REL_TOL}")
    _, g_bad = grads(_shifted_backend())
    bad = worst(g_bad, g_ref)
    check(bad > GRAD_REL_TOL, f"the grad limit {GRAD_REL_TOL} does not "
          f"reject a backward shifted by one position (worst leaf {bad:.4f})")
    say(f"  loss kernels {l_cuda:.5f} vs plain {l_ref:.5f}; worst leaf "
        f"max|Δg| / max|g|: kernels {ok:.4f} (limit {GRAD_REL_TOL}), "
        f"shifted-mask control {bad:.4f} (rejected)")
    del base, g_ref, g_cuda, g_bad
    _free()


# ----------------------------------------------------------------- phase 5

def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_flash(launches):
    """Kernel A at the serving shape: one 256-token chunk of the 1000-token
    prompt at start 768 against the 1024-key (bucketed) gathered context."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    B, Tq, Tk, H, D, off = 1, 256, 1024, 32, 128, 768
    q = randn(gen, (B, Tq, H, D), torch.bfloat16)
    k = randn(gen, (B, Tk, H, D), torch.bfloat16)
    v = randn(gen, (B, Tk, H, D), torch.bfloat16)
    m = mk.causal(rel_offset=off)
    o, _ = flash_fwd(q, k, v, mask=m)
    o_r, _ = chunk_attn_ref(q, k, v, mask=m)
    err = float((o.float() - o_r.float()).abs().max())
    ms = cuda_ms(lambda: flash_fwd(q, k, v, mask=m))
    plain = cuda_ms(lambda: chunk_attn_ref(q, k, v, mask=m))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    allow = (torch.arange(Tk, device=DEV)[None, :]
             <= off + torch.arange(Tq, device=DEV)[:, None])
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=allow))
    pairs = sum(min(Tk, off + t + 1) for t in range(Tq))
    flops = 4.0 * B * H * pairs * D
    nbytes = 2 * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * H * Tq
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  flash_fwd  B{B} Tq{Tq} Tk{Tk} H{H} D{D} bf16 causal@{off}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:157",
            "launches": launches["flash_fwd"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def time_paged(launches):
    """Kernel B at the serving shape: one decode step of the 4 requests
    (lengths mid-way through their 32 new tokens), bs = 16."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    lens = [1016, 716, 529, 80]
    H, D, bs = 32, 128, 16
    q, kp, vp, bt, ln = _paged_inputs(gen, 4, 1, H, H, D, bs, lens,
                                      torch.bfloat16)
    m = mk.causal()
    o = paged_attn(q, kp, vp, bt, ln, mask=m)
    o_r = paged_attn_ref(q, kp, vp, bt, ln, mask=m)
    err = float((o.float() - o_r.float()).abs().max())
    ms = cuda_ms(lambda: paged_attn(q, kp, vp, bt, ln, mask=m))
    plain = cuda_ms(lambda: paged_attn_ref(q, kp, vp, bt, ln, mask=m))
    ctx = sum(lens)
    flops = 4.0 * ctx * H * D
    nbytes = 2 * (2 * ctx * H * D + 2 * 4 * H * D) + 4 * (4 + bt.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  paged_decode B4 Tq1 H{H} D{D} bs{bs} bf16 lengths {lens}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes / 1e6:.2f} MB), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged.py:182",
            "launches": launches["paged_decode"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def time_bwd(launches, seen, errs):
    """Kernels C and D on the training path's own backward inputs (B 1,
    T 8192, 32 heads × 128, bf16, causal).  Each kernel's plain version is
    the plain backward computing just its part (``only=``), run over every
    head slice in turn, so it covers the same work at the same shape.  No
    single library call computes dq or dk/dv alone: the library figure is
    SDPA's autograd backward, which computes the pair, and both rows say
    so."""
    (q, k, v, o, lse, do), kw = _moved(seen["bwd"], DEV)
    B, T, H, D = q.shape
    scale = D ** -0.5 if kw["scale"] is None else kw["scale"]
    pl = _BwdPlan(q, k, v, o, lse, do, kw["mask"], kw.get("delta"),
                  kw.get("q_segments"), kw.get("kv_segments"), True)
    dq_ms = cuda_ms(lambda: _launch_dq(pl, scale), reps=10, warmup=2)
    dkv_ms = cuda_ms(lambda: _launch_dkv(pl, scale), reps=10, warmup=2)
    slices = [_bwd_slice((q, k, v, o, lse, do), kw, sq, skv)
              for sq, skv in _head_slices(q, k)]

    def plain(only):
        return lambda: [chunk_attn_bwd_ref(*a, **k2, only=only)
                        for a, k2 in slices]
    plain_ms = {"flash_bwd_dq": cuda_ms(plain("dq"), reps=3, warmup=1),
                "flash_bwd_dkv": cuda_ms(plain("dkv"), reps=3, warmup=1)}
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True),
                  reps=10, warmup=2)
    del pl, slices, qt, kt, vt, out, dot, q, k, v, o, lse, do
    _free()
    pairs = B * H * T * (T + 1) // 2
    tensor = 2 * B * T * H * D                   # one bf16 (B,T,H,D)
    stats = 4 * B * T * H                        # one float32 (B,T,H)
    rows = []
    for name, ms, fl, nbytes, src_line in (
            ("flash_bwd_dq", dq_ms, 6.0 * D * pairs, 6 * tensor + 2 * stats,
             280),
            ("flash_bwd_dkv", dkv_ms, 8.0 * D * pairs, 6 * tensor + 2 * stats,
             322)):
        b_ms, b_by = bound(fl, nbytes, PEAK_BF16_FLOPS)
        say(f"  {name} B{B} T{T} H{H} D{D} bf16 causal: kernel {ms:.4f} ms "
            f"({fl / ms / 1e9:.1f} TFLOP/s), plain {plain_ms[name]:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; {fl / 1e12:.3f} TFLOP, "
            f"{nbytes / 1e6:.1f} MB), max|Δ| vs plain {errs[name]:.3e}")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{src_line}",
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms[name], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib,
                     "library_covers": "flash_bwd_dq+flash_bwd_dkv"})
    say(f"  pair C+D at T {T}: kernels {dq_ms + dkv_ms:.4f} ms, plain "
        f"{sum(plain_ms.values()):.4f} ms (each part on its own), SDPA "
        f"autograd backward {lib:.4f} ms")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    say("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"nvidia-smi: {smi}")
    say(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("== phase 2: build")
    t0 = time.perf_counter()
    report = build.build_all()
    say(f"  built {list(report)} in {time.perf_counter() - t0:.1f} s")
    for name, text in report.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    say("== phase 3: kernels against their plain versions")
    kernel_checks()
    bwd_checks()

    say("== phase 4: serve llama-7b")
    res = serve()
    say(f"  launches per decode step: paged_decode "
        f"{res['per_decode_step']:.1f}; per prefill chunk: flash_fwd "
        f"{res['per_chunk']:.1f}")
    _free()

    say("== phase 6: train at llama-7b width")
    tr = train()
    say("== phase 6a: kernels A, C and D on the training path's inputs")
    errs = main_path_checks(tr["seen"])
    say("== phase 6b: gradients against the plain path")
    grad_check()

    say("== phase 5: times at the shapes of each path")
    launches = {k: res["launches"][k] + tr["launches"].get(k, 0)
                for k in res["launches"]}
    say(f"  launches on the main paths: serve {res['launches']}, "
        f"train {tr['launches']}")
    rows = [time_flash(launches), time_paged(launches),
            *time_bwd(launches, tr["seen"], errs)]
    say(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
