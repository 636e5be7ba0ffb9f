#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100

Phases, each fatal on failure (nothing is caught):

  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``;
                ptxas' registers and spills of the tensor-core routes
                (kernel A's, and kernels C and D's), with their shared
                memory; no spill at D = 128.
  3. kernels  — each kernel's wrapper against its plain PyTorch version on
                the card, at llama-7b serving and training shapes plus edge
                cases, every case of A, C and D in both dtypes (bf16 runs
                the tensor-core routes, float32 the CUDA-core ones);
                tolerances: forward float32 1e-5 (paged 2e-5), bf16 2e-2;
                backward (kernels C and D) float32 2e-4, bf16 5e-2; lse
                1e-4; the pruned sweep equal to the dense one within 1e-6
                (bf16 forward: 2^-9 of max |o|, under one bf16 step).
                bf16 outputs of A are also held element by element to 3e-2
                of their own size (``rel_err``; A's route feeds p to the
                second product as two bf16 terms to meet it); bf16 outputs
                of C and D row by row to 2e-2 of each row's norm
                (``row_rel_err``), since their route rounds p and ds.
                Kernel B (split-KV) also at its split edges (lengths
                L_s - 1, L_s, L_s + 1, 2 L_s), a 32768-token request, a
                window across a split boundary and Tq 4 rows that are dead
                in some splits, each launch counted once; and bitwise: a
                request alone, in a batch of 4 and under a permuted block
                table gives the same o, and so do two launches.
  3c. plans   — kernels A, C and D under every distinct mask the plan
                steps give them: every active Work item of balanced, ring
                and zigzag (causal) at P 4, Tl 8192 (zigzag: two chunks of
                4096), of a windowed ring and a windowed zigzag (window
                3000: whole rows empty at large q offsets, rank offsets
                folded into static masks) and two steps of a document
                plan with segment ids; 32 heads × 128, bf16.  The backward
                gets the executor's inputs (o = 0, delta passed in).  Held
                head slice by head slice to phase 3's limits; empty rows
                must be (0, NEG_INF) and merge to the other partial; a
                statically empty chunk launches nothing.
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
                limits; the element-wise limit must reject a plain forward,
                and the per-row limit a plain backward, that never visits
                the last 64-key tile.  SDPA's forward and backward on the
                same inputs are printed under the same gates, as
                calibrations.
  6b. grads   — at 2 layers and T 1024, full width: per leaf, max |Δg|
                between the kernels and the plain attention is at most 5%
                of the leaf's max |g|, and the same limit rejects a plain
                backward whose causal mask is shifted by one position.
  7. ranks    — the multi-rank path: a gloo world of 4 processes sharing
                the card (transport "gloo-staged": every transfer staged
                through pinned host buffers), llama-7b's width (d_model
                4096, 32 × 128 heads, d_ff 11008, vocab 32000, bf16) at
                depth 2 on one global sequence of 32768 tokens (8192 a
                rank), remat_aware: 3 balanced steps, 1 ring, 1 zigzag.
                Per rank and step: A, C and D launch counts equal to the
                rank's Work items with a route that reaches an output
                (the coverage rule, checked to compute every causal chunk
                pair once) × layers, finite losses equal on every rank,
                no skipped step; peak memory.  Held to a P = 1 run of the
                same weights and batches in this process: the per-token
                losses of the first batch (the limit must reject a
                control whose plans drop the helper routes); the
                gradients of every layer's wq, wk, wv under each schedule,
                step 1's gradient norm and step 2's loss (the limits must
                reject two planted backward faults: the accumulators'
                home shift dropped, the helpers' dq dropped).  Any rank's
                failure, or the world still running after 600 s, is
                fatal.
  5. times    — each kernel at the shapes of its path (C and D on the
                inputs kept in phase 6): its time (CUDA events, median
                after warm-up), its plain version's at the same shape, a
                library call's where one exists (for C and D, SDPA's
                backward of the pair, marked ``library_covers``), and the
                least time the card could take.  Kernel A also at the
                training shape (its layer-1 inputs, T 8192, causal), beside
                its bound, its plain version and SDPA's causal forward
                (``train_*`` keys).  Kernel B with a cold L2 (launches
                rotate over 4 distinct pool pairs) at the serving step, a
                32768-token decode (``long_*``) and GQA Tq 4 (``gqa_*``):
                its device time (torch.profiler), the wrapper's (CUDA
                events) and the host time of one call (1000 calls).

Prints the ``{"kernels": [...]}`` line second to last and
``{"ok": true, "device": {...}}`` last.  Exits non-zero with no result when
there is no CUDA device or the port is not beside this file.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import mask as mk  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    ParallelConfig, ShapeSpec, TrainConfig, get_config)
from repro_torch.core import schedule as sp  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FWD_ROUTES, FlashAttnFn, _BwdPlan, _device_bounds, _launch_dkv,
    _launch_dq, flash_bwd, flash_fwd)
from repro_torch.kernels.paged import paged_attn, paged_attn_ref  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    NEG_INF, chunk_attn_bwd_ref, chunk_attn_ref, merge_ref, row_rel_err)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.world import spawn  # noqa: E402
from repro_torch.models.transformer import DecoderLM, trainable  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import make_parallel_config  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# bf16 outputs of kernel A are also held element by element to their own
# size (see rel_err): two bf16 roundings of one float32 value differ by at
# most 2^-7 of it, and a sweep that skips a 64-key tile moves small outputs
# (late rows, last keys) by far more than that.
REL_TOL, REL_FLOOR = 3e-2, 1e-3
# bf16 outputs of C and D are held row by row instead (row_rel_err; a row
# is one query's dq or one key's dk / dv in one head): the tensor-core
# route rounds p and ds to bf16 before the second products (C takes ds as
# two bf16 terms), as every tensor-core backward does, which moves single
# small elements by far more than one bf16 step of their size but a row by
# ~2^-8 of its norm (a CPU emulation at T 512: 4.6e-3), while a sweep
# without the last 64-key tile moves rows by 0.1 to 1.
ROW_TOL = 2e-2
BWD_DESIGN = ("bf16: wgmma m64n64k16 on the tensor cores (sm_90a), float32 "
              "accumulators, swizzled bf16 tiles double-buffered by 16-byte "
              "cp.async, ds into dq as two bf16 terms; float32: IEEE FMAs "
              "on the CUDA cores")
FWD_DESIGN = ("bf16: one block per 128 q rows (two warpgroups of 64); k/v "
              "tiles of 128 keys by TMA into a 3-stage swizzled ring with "
              "mbarriers; s = q·kᵀ as wgmma m64n128k16, o += p·v as wgmma "
              "with p in registers as two bf16 terms (hi, lo); float32: "
              "IEEE FMAs on the CUDA cores")
# bf16 pruned vs dense sweep of kernel A: both do the same arithmetic on
# every live tile; the limit, 2^-9 of max |o|, is under half of one bf16
# step at the largest output (a step there is at least 2^-8 of it)
PRUNE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -9}
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
    n0 = build.LAUNCHES["flash_fwd"]
    o, lse = flash_fwd(q, k, v, mask=mask, **kw)
    torch.cuda.synchronize()
    check(build.LAUNCHES["flash_fwd"] == n0 + 1, f"flash_fwd {name}: "
          "launches")
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, **kw)
    check(bool((lse[lse_r <= NEG_INF / 2] == NEG_INF).all()),
          f"flash_fwd {name}: an empty row's lse is not NEG_INF")
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
    n0 = build.LAUNCHES["paged_decode"]
    o = paged_attn(q, kp, vp, bt, lens, mask=mask)
    torch.cuda.synchronize()
    check(build.LAUNCHES["paged_decode"] == n0 + 1,
          f"paged_decode {name}: launches")
    o_r = paged_attn_ref(q, kp, vp, bt, lens, mask=mask)
    err = float((o.float() - o_r.float()).abs().max())
    tol = PAGED_TOL[dtype]
    check(torch.allclose(o.float(), o_r.float(), atol=tol, rtol=tol),
          f"paged_decode {name}: err {err} over {tol}")
    say(f"  B {name:<28} {str(dtype)[6:]:<9} max|Δo| {err:.3e}  tol {tol}")


def kernel_checks():
    gen = torch.Generator(device=DEV).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    # kernel A at llama-7b prefill shapes (Hq = Hkv = 32, D = 128) + edges,
    # every case on both routes: float32 (CUDA cores), bf16 (wgmma)
    for dt in (f32, bf):
        _flash_case(gen, "causal Tq256 Tk1024 q_off768", 1, 256, 1024, 32,
                    32, 128, dt, mk.causal(rel_offset=768))
        _flash_case(gen, "sliding_window 300", 1, 256, 1024, 32, 32, 128, dt,
                    mk.sliding_window(300, rel_offset=768))
        _flash_case(gen, "gqa Hkv8", 1, 256, 1024, 32, 8, 128, dt,
                    mk.causal(rel_offset=768))
        _flash_case(gen, "ragged Tq100 Tk1000", 1, 100, 1000, 32, 32, 128, dt,
                    mk.causal(rel_offset=900))
        _flash_case(gen, "d64", 2, 256, 512, 8, 4, 64, dt,
                    mk.causal(rel_offset=256))
        _flash_case(gen, "prefix_lm d32", 1, 192, 192, 4, 2, 32, dt,
                    mk.prefix_lm(70))
        _flash_case(gen, "document boundaries", 1, 256, 256, 4, 4, 64, dt,
                    mk.document(boundaries=(0, 37, 150, 151)))
        _flash_case(gen, "document segments", 2, 128, 256, 4, 2, 32, dt,
                    mk.document(), segs=True)
        _flash_case(gen, "full kv_offset", 1, 64, 200, 4, 4, 32, dt,
                    mk.MaskSpec(q_offset=10, kv_offset=3))
        _flash_case(gen, "empty rows q_offset -64", 1, 128, 128, 2, 2, 128,
                    dt, mk.causal(rel_offset=-64))
        # pruned == dense sweep
        q, k, v = (randn(gen, (1, 256, 4, 64), dt) for _ in range(3))
        m = mk.sliding_window(70)
        o1, l1 = flash_fwd(q, k, v, mask=m)
        o2, l2 = flash_fwd(q, k, v, mask=m, prune=False)
        d = float((o1.float() - o2.float()).abs().max())
        lim = PRUNE_TOL[dt] * (1.0 if dt == f32 else float(o1.float().abs()
                                                            .max()))
        check(d <= lim, f"flash_fwd pruned vs dense {str(dt)[6:]}: {d} over "
              f"{lim}")
        say(f"  A {'pruned == dense':<28} {str(dt)[6:]:<9} max|Δo| {d:.3e}  "
            f"tol {lim:.3e}")
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
    # the split-KV design: L_s = 256 tokens at bf16 D 128 (bs 16), 512 at
    # float32 D 32 (bs 64); lengths at the split edges L_s - 1, L_s,
    # L_s + 1, 2 L_s
    edges = [255, 256, 257, 512]
    _paged_case(gen, "split edges", 4, 1, 32, 32, 128, 16, edges, 0, bf)
    _paged_case(gen, "split edges gqa Tq4", 4, 4, 32, 8, 128, 16, edges, 0,
                bf)
    _paged_case(gen, "split edges f32 d32 bs64", 4, 1, 4, 4, 32, 64,
                [511, 512, 513, 1024], 0, f32)
    _paged_case(gen, "32768 tokens", 1, 1, 32, 32, 128, 16, [32768], 0, bf)
    _paged_case(gen, "window across splits", 4, 1, 32, 32, 128, 16,
                [300, 600, 700, 1000], 100, bf)
    # window 2 at Tq 4: the first rows attend only the split before 256,
    # the last only the one after, so each split is dead for some rows
    _paged_case(gen, "rows dead in some splits", 2, 4, 32, 8, 128, 16,
                [258, 770], 2, bf)
    _paged_case(gen, "rows dead in some splits", 2, 4, 8, 2, 64, 16,
                [514, 1026], 2, f32)
    paged_bitwise(gen)


def paged_bitwise(gen):
    """Kernel B's batch invariance: one request (1000 tokens, GQA, Tq 2,
    four splits) alone, in a batch of 4, and under a permuted block table
    gives bitwise the same o, and so do two launches."""
    B, Tq, Hq, Hkv, D, bs = 4, 2, 32, 8, 128, 16
    q, kp, vp, bt, lens = _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs,
                                        [80, 1000, 529, 1100],
                                        torch.bfloat16)
    m = mk.sliding_window(900)
    full = paged_attn(q, kp, vp, bt, lens, mask=m)
    again = paged_attn(q, kp, vp, bt, lens, mask=m)
    alone = paged_attn(q[1:2].contiguous(), kp, vp,
                       bt[1:2, :-(-1000 // bs)].contiguous(), lens[1:2],
                       mask=m)
    N = kp.shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device=DEV),
                      torch.randperm(N - 1, generator=gen, device=DEV) + 1])
    kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    moved = paged_attn(q, kp2, vp2, perm[bt.long()].to(torch.int32), lens,
                       mask=m)
    check(torch.equal(full, again), "paged_decode: two launches differ")
    check(torch.equal(alone[0], full[1]),
          "paged_decode: a request alone differs from it in a batch")
    check(torch.equal(moved, full),
          "paged_decode: a permuted block table changes o")
    say(f"  B {'bitwise batch invariance':<28} bfloat16  alone == in a "
        "batch of 4 == permuted table; launch == launch")


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
            rels.append(row_rel_err(a, r))
            check(rels[-1] <= ROW_TOL, f"flash_bwd {name}: {nm} per-row "
                  f"relative err {rels[-1]} over {ROW_TOL}")
    rel = (f"; row {'/'.join(f'{x:.2e}' for x in rels)} (limit {ROW_TOL})"
           if rels else "")
    say(f"  C/D {name:<26} {str(dtype)[6:]:<9} max|Δdq| {errs[0]:.3e}  "
        f"max|Δdk| {errs[1]:.3e}  max|Δdv| {errs[2]:.3e}  tol {tol}; "
        f"pruned == dense{rel}")


def bwd_checks():
    """Kernels C and D over the edge cases kernel A is held to, plus the
    training shape."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    # every edge case on both routes: float32 (CUDA cores), bf16 (wgmma)
    for dt in (f32, bf):
        _bwd_case(gen, "causal d128", 1, 256, 256, 4, 4, 128, dt,
                  mk.causal())
        _bwd_case(gen, "sliding_window 70 d64", 1, 256, 256, 4, 1, 64, dt,
                  mk.sliding_window(70))
        _bwd_case(gen, "prefix_lm 70 d32", 1, 192, 192, 4, 2, 32, dt,
                  mk.prefix_lm(70))
        _bwd_case(gen, "document boundaries", 1, 256, 256, 4, 4, 64, dt,
                  mk.document(boundaries=(0, 37, 150, 151)))
        _bwd_case(gen, "document segments gqa", 2, 128, 256, 4, 2, 32, dt,
                  mk.document(), segs=True)
        _bwd_case(gen, "gqa Hkv2 Tq!=Tk offset", 2, 100, 300, 8, 2, 64, dt,
                  mk.causal(rel_offset=200))
        _bwd_case(gen, "empty rows q_offset -64", 1, 128, 128, 2, 2, 32, dt,
                  mk.causal(rel_offset=-64))
        _bwd_case(gen, "full kv_offset, delta in", 1, 64, 200, 4, 4, 32, dt,
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
        key = ("kernel A flash_fwd" if "flash_fwd" in name else
               "kernel B paged_decode" if "paged_decode" in name else
               "kernel C flash_bwd_dq" if "flash_bwd_dq" in name else
               "kernel D flash_bwd_dkv" if "flash_bwd_dkv" in name else
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


def _sdpa_bwd(q, k, v, do, scale):
    """SDPA's causal forward and autograd backward of (q, k, v) for the
    cotangent do, in the (B, T, H, D) layout: the library yardstick of
    kernels C and D, never called by the port.  Returns (o, (dq, dk, dv))."""
    qt, kt, vt = (x.transpose(1, 2).detach().contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale,
        enable_gqa=qt.shape[1] != kt.shape[1])
    g = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    return (out.detach().transpose(1, 2),
            tuple(x.transpose(1, 2) for x in g))


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
    r_bad = r_lib = None
    for sq, skv in _head_slices(q, k):
        qh, kh, vh = q[:, :, sq], k[:, :, skv], v[:, :, skv]
        o_r, lse_r = chunk_attn_ref(qh, kh, vh, **kw)
        e_o = max(e_o, float((o[:, :, sq].float() - o_r.float()).abs()
                             .max()))
        r_o = max(r_o, rel_err(o[:, :, sq], o_r))
        e_lse = max(e_lse, float((lse[:, :, sq] - lse_r).abs().max()))
        lse_max = max(lse_max, float(lse_r.abs().max()))
        if r_bad is None:   # the control and the calibration, first slice
            cut = kh.shape[1] - 64
            r_bad = rel_err(chunk_attn_ref(qh, kh[:, :cut], vh[:, :cut],
                                           **kw)[0], o_r)
            o_lib = torch.nn.functional.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in (qh, kh, vh)), is_causal=True,
                scale=kw.get("scale"), enable_gqa=qh.shape[2] != kh.shape[2])
            r_lib = rel_err(o_lib.transpose(1, 2), o_r)
            del o_lib
    say(f"  A  layer-1 forward: max|Δo| {e_o:.3e} rel {r_o:.2e} (limit "
        f"{REL_TOL}), max|Δlse| {e_lse:.3e}; control without the last kv "
        f"tile: rel {r_bad:.2e}; SDPA's forward (calibration, first head "
        f"slice): rel {r_lib:.2e}")
    check(r_o <= REL_TOL and e_o <= TOL[torch.bfloat16],
          f"flash_fwd on the training path: o err {e_o}, rel {r_o}")
    check(e_lse <= LSE_TOL * (1 + lse_max),
          f"flash_fwd on the training path: lse err {e_lse}")
    check(r_bad > REL_TOL, f"the limit {REL_TOL} does not reject a forward "
          f"without the last kv tile (rel {r_bad})")
    del q, k, v, o, lse, o_r, lse_r, qh, kh, vh
    args, kw = _moved(seen["bwd"], DEV)
    got = flash_bwd(*args, **kw)
    e_abs, e_row, e_bad, e_lib = [0.0] * 3, [0.0] * 3, None, None
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
            e_row[i] = max(e_row[i], row_rel_err(a, r))
        if e_bad is None:             # the control, on the first slice
            q, k, v, o, lse, do = a_s
            cut = k.shape[1] - 64
            bq, bk, bv = chunk_attn_bwd_ref(q, k[:, :cut], v[:, :cut], o,
                                            lse, do, **kw_s)
            pad = torch.zeros_like(k[:, cut:])
            bad = (bq, torch.cat([bk, pad], 1), torch.cat([bv, pad], 1))
            e_bad = [row_rel_err(b, r) for b, r in zip(bad, ref)]
            del bad, bq, bk, bv
            # SDPA's backward uses its own forward's output in delta =
            # rowsum(o ⊙ do), so it is held to the plain backward from that
            # output
            o_lib, g_lib = _sdpa_bwd(q, k, v, do, kw_s.get("scale"))
            ref_lib = chunk_attn_bwd_ref(q, k, v, o_lib, lse, do, **kw_s)
            e_lib = [row_rel_err(b, r) for b, r in zip(g_lib, ref_lib)]
            del o_lib, g_lib, ref_lib
        del ref
    say(f"  C/D layer-8 backward: max|Δdq| {e_abs[0]:.3e} max|Δdk| "
        f"{e_abs[1]:.3e} max|Δdv| {e_abs[2]:.3e} (tol {tol}); per-row dq/dk/"
        "dv " + "/".join(f"{x:.2e}" for x in e_row) + f" (limit {ROW_TOL}); "
        "control without the last kv tile: per-row "
        + "/".join(f"{x:.2e}" for x in e_bad) + "; SDPA's backward "
        "(calibration, first head slice): per-row "
        + "/".join(f"{x:.2e}" for x in e_lib))
    check(max(e_row) <= ROW_TOL, f"flash_bwd on the training path: per-row "
          f"errors {e_row} over {ROW_TOL}")
    check(min(e_bad) > ROW_TOL, f"the limit {ROW_TOL} does not reject a "
          f"backward without the last kv tile (per-row {e_bad})")
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


# ---------------------------------------------------------------- phase 3c

PLAN_P, PLAN_TL, PLAN_WINDOW = 4, 8192, 3000
PLAN_SETS = (("balanced", mk.causal()), ("ring", mk.causal()),
             ("zigzag", mk.causal()),
             ("ring", mk.sliding_window(PLAN_WINDOW)),
             ("zigzag", mk.sliding_window(PLAN_WINDOW)),
             ("balanced", mk.document()))
PLAN_DOC_STEPS = ((0, 1), (1, 3))   # (step, rank) run of the document plan


def _plan_step_cases():
    """The distinct kernel calls of every Work item of ``PLAN_SETS`` at
    P 4, Tl 8192, as each rank's forward and backward make them
    (``schedule.rank_calls``): ``{(mask, chunk tokens, q chunk, kv chunk):
    [labels]}`` (the chunks only where segment ids make them matter:
    document masks)."""
    cases = {}
    for sched, m in PLAN_SETS:
        plan = sp.build_plan(sched, m, PLAN_P, PLAN_TL)
        tag = sched + ("-window" if m.window else "") \
            + ("-document" if m.document else "")
        for backward in (False, True):
            for si, p, qg, kg, km in sp.rank_calls(plan, backward):
                if m.document and (si, p) not in PLAN_DOC_STEPS:
                    continue
                key = (km, plan.chunk_len) + ((qg, kg) if m.document
                                              else (None, None))
                label = f"{tag} t{si} p{p}"
                if label not in cases.setdefault(key, []):
                    cases[key].append(label)
    return cases


def plan_step_checks():
    """Phase 3c: kernels A, C and D under every plan step's mask at
    llama-7b width (32 heads × 128, bf16), against their plain versions
    head slice by head slice at phase 3's limits; the backward gets the
    executor's inputs (o = 0, delta = rowsum(o ⊙ do) passed in)."""
    gen = torch.Generator(device=DEV).manual_seed(16)
    bf = torch.bfloat16
    T = PLAN_P * PLAN_TL
    seg_g = torch.sort(torch.randint(0, 7, (1, T), generator=gen,
                                     device=DEV), dim=1)[0].to(torch.int32)
    cases = _plan_step_cases()
    n_empty_rows = n_empty_chunks = 0
    for (m, c, qg, kg), labels in cases.items():
        q, k, v, do = (randn(gen, (1, c, 32, 128), bf) for _ in range(4))
        kw = {}
        if m.document:
            kw = dict(q_segments=seg_g[:, qg * c:(qg + 1) * c].contiguous(),
                      kv_segments=seg_g[:, kg * c:(kg + 1) * c]
                      .contiguous())
        block = FWD_ROUTES[bf][2]
        empty = _device_bounds(m, c, c, True, str(DEV), block)[1]
        n0 = dict(build.LAUNCHES)
        o, lse = flash_fwd(q, k, v, mask=m, **kw)
        delta = (o.float() * do.float()).sum(-1)
        zero = torch.zeros_like(q)
        got = flash_bwd(q, k, v, zero, lse, do, mask=m, delta=delta, **kw)
        torch.cuda.synchronize()
        want = 0 if empty else 1
        for name in BWD_KERNELS:
            check(build.LAUNCHES[name] - n0[name] == want,
                  f"plan step {labels[0]}: {name} launched "
                  f"{build.LAUNCHES[name] - n0[name]} times, want {want}")
        e = dict(o=0.0, lse=0.0, rel=0.0, dq=0.0, dk=0.0, dv=0.0)
        rows = [0.0] * 3
        dead = 0
        for sq, skv in _head_slices(q, k):
            qh, kh, vh = q[:, :, sq], k[:, :, skv], v[:, :, skv]
            o_r, lse_r = chunk_attn_ref(qh, kh, vh, mask=m, **kw)
            oh, lh = o[:, :, sq], lse[:, :, sq]
            check(torch.allclose(oh.float(), o_r.float(), atol=TOL[bf],
                                 rtol=TOL[bf]),
                  f"plan step {labels[0]}: o over {TOL[bf]}")
            e["o"] = max(e["o"], float((oh.float() - o_r.float()).abs()
                                       .max()))
            e["rel"] = max(e["rel"], rel_err(oh, o_r))
            gone = lse_r <= NEG_INF / 2
            dead += int(gone.sum())
            check(bool((lh[gone] == NEG_INF).all() and (oh[gone] == 0).all()),
                  f"plan step {labels[0]}: an empty row is not (0, NEG_INF)")
            if (~gone).any():
                e["lse"] = max(e["lse"], float((lh - lse_r).abs()[~gone]
                                               .max()))
            ref = chunk_attn_bwd_ref(qh, kh, vh, zero[:, :, sq], lh,
                                     do[:, :, sq], mask=m,
                                     delta=delta[:, :, sq], **kw)
            mine = (got[0][:, :, sq], got[1][:, :, skv], got[2][:, :, skv])
            for i, (nm, a, r) in enumerate(zip(("dq", "dk", "dv"), mine,
                                               ref)):
                check(torch.allclose(a.float(), r.float(), atol=BWD_TOL[bf],
                                     rtol=BWD_TOL[bf]),
                      f"plan step {labels[0]}: {nm} over {BWD_TOL[bf]}")
                e[nm] = max(e[nm], float((a.float() - r.float()).abs()
                                         .max()))
                rows[i] = max(rows[i], row_rel_err(a, r))
            del o_r, lse_r, ref
        check(e["rel"] <= REL_TOL, f"plan step {labels[0]}: o relative "
              f"err {e['rel']} over {REL_TOL}")
        check(max(rows) <= ROW_TOL, f"plan step {labels[0]}: per-row "
              f"errors {rows} over {ROW_TOL}")
        if dead:
            # merged with another partial, the empty rows stay finite and
            # take the other partial's value exactly
            o2 = randn(gen, o.shape, torch.float32)
            mo, ml = merge_ref(o.float(), lse, o2, torch.zeros_like(lse))
            gone = lse <= NEG_INF / 2
            check(bool(torch.isfinite(mo).all() and torch.isfinite(ml).all()
                       and (mo[gone] == o2[gone]).all()),
                  f"plan step {labels[0]}: merge of empty rows")
            n_empty_rows += 1
        n_empty_chunks += bool(empty)
        say(f"  {labels[0]:<24} {m.kind:<14} q_off {m.q_offset:>5} kv_off "
            f"{m.kv_offset:>5} c {c}: max|Δo| {e['o']:.2e} rel "
            f"{e['rel']:.2e} max|Δlse| {e['lse']:.2e}; dq/dk/dv "
            f"{e['dq']:.2e}/{e['dk']:.2e}/{e['dv']:.2e} per-row "
            + "/".join(f"{x:.2e}" for x in rows)
            + (f"; {dead} empty rows" if dead else "")
            + ("; statically empty, no launch" if empty else "")
            + f" ({len(labels)} rank-steps)")
        del q, k, v, do, o, lse, got, zero, delta
        _free()
    check(n_empty_rows > 0, "no plan step had empty rows")
    say(f"  {len(cases)} distinct plan-step kernel calls held to their "
        f"plain versions; {n_empty_rows} with empty rows, "
        f"{n_empty_chunks} statically empty")


# ----------------------------------------------------------------- phase 7

P7_RANKS, P7_LAYERS, P7_T = 4, 2, 32768
P7_RUNS = (("balanced", 3), ("ring", 1), ("zigzag", 1))
P7_TIMEOUT = 600
P7_TRANSPORT = "gloo-staged"       # four ranks, one card
# P = 4 against P = 1 on the same weights and first batch (bf16, width,
# depth 2): the mean |Δ| of the per-token losses and |Δ| of the loss.
# Calibrated on the first chip run: sound 5.03e-3 and 4.77e-5; the
# control without the helper routes 5.36e-2 and 5.18e-4.  Each limit sits
# about 3× above the sound run and 3× below the control.
P7_CE_TOL, P7_LOSS_TOL = 1.5e-2, 1.5e-4
# The backward against P = 1 on the same weights and batches: the worst
# relative error ‖g₄ − g₁‖ / ‖g₁‖ over the gradients of every layer's wq,
# wk and wv (each schedule), the relative |Δ| of step 1's gradient norm,
# and |Δ| of step 2's loss (after one AdamW update).  Two planted backward
# faults on the balanced schedule are the controls: the traveling
# accumulators' home shift dropped ("home"), and the helpers' dq
# accumulator emptied on its way home ("dqb").  Calibrated on the chip
# (H100, 700 W): sound ≤ 7.61e-3 / 2.91e-5 / 9.54e-6; home 0.821 /
# 3.39e-2 / 4.57e-2; dqb 0.223 / 5.79e-5 / 1.95e-4.  The gradient and
# step-2 limits sit about 4× above the sound run and 5-7× below the dqb
# control; the norm limit 34× from both the sound run and the home
# control.  The dqb control moves the norm only twice as far as the sound
# run does (the helpers' dq is a small part of it), so the norm limit
# need reject only the home control.
P7_GRAD_TOL, P7_GNORM_TOL, P7_LOSS2_TOL = 3e-2, 1e-3, 4e-5
P7_GRAD_RUNS = (("balanced", None), ("ring", None), ("zigzag", None),
                ("balanced", "home"), ("balanced", "dqb"))


def _p7_tc():
    return TrainConfig(lr=1e-4, warmup_steps=1,
                       total_steps=sum(n for _, n in P7_RUNS))


def _helperless(build_plan):
    """A deliberately wrong planner (phase 7's control): the plans with
    every shipped route dropped, so the balanced schedule's helper results
    never reach home."""
    def build(sched, m, P, Tl):
        plan = build_plan(sched, m, P, Tl)
        steps = []
        for s in plan.steps:
            work = [dataclasses.replace(w, routes=tuple(
                r for r in w.routes if not r.ship)) for w in s.work]
            steps.append(dataclasses.replace(
                s, work=tuple(w for w in work if w.routes)))
        return dataclasses.replace(plan, steps=tuple(steps))
    return build


@contextlib.contextmanager
def _backward_fault(fault):
    """A deliberately wrong backward while the block runs (phase 7's
    controls): ``execute_bwd``'s multi-hop shift that sends the traveling
    accumulators home (its only shift with negative hops) dropped
    (``"home"``), or made with the helpers' dq accumulator emptied
    (``"dqb"``); None leaves the backward as it is."""
    shift_now = sp._shift_now

    def faulty(comm, data, hops):
        if hops >= 0:
            return shift_now(comm, data, hops)
        if fault == "home":
            return data
        out = shift_now(comm, data, hops)
        out["dqb"] = torch.zeros_like(out["dqb"])
        return out
    if fault:
        sp._shift_now = faulty
    try:
        yield
    finally:
        sp._shift_now = shift_now


def _token_ce(model, params, batch):
    """Per-token cross-entropy (B, Tl) float32 of ``model`` on its shard,
    through the model's own layers (logits 4096 tokens at a time)."""
    from repro_torch.models import layers as L
    a = model.cfg.attn
    with torch.no_grad():
        h = model._embed(params, batch)
        cos, sin = L.rope_tables(model.positions(h.shape[1]), a.head_dim,
                                 a.rope_theta)
        h = model._backbone(params, h, cos, sin)
        labels = batch["labels"].to(model.device).long()
        out = []
        for i in range(0, h.shape[1], 4096):
            lf = model._head(params, h[:, i:i + 4096]).float()
            ll = lf.gather(-1, labels[:, i:i + 4096, None])[..., 0]
            out.append(torch.logsumexp(lf, -1) - ll)
        return torch.cat(out, dim=1)


def _attn_grads(model, params, batch):
    """Gradients of the global loss w.r.t. every layer's wq, wk and wv,
    summed over the ranks as the train step sums them."""
    loss, _ = model.loss(params, batch)
    gs = list(torch.autograd.grad(loss, [
        lp["attn"][k] for lp in params["layers"] for k in ("wq", "wk", "wv")]))
    if model.token_group is not None:
        model.token_group.all_reduce_(gs)
    return gs


def _grad_err(gs, ref):
    return max(float((g.float() - r.float()).norm() / r.float().norm())
               for g, r in zip(gs, ref))


def _p7_want(sched):
    """Per rank, the kernel calls one pass of ``sched``'s causal plan at
    P 4 must launch, derived apart from the executor's ``work_active``:
    the rank's Work items with a route that reaches an output
    (``schedule.route_reaches``, the coverage rule).  Fails unless those
    items compute every causal (q chunk, kv chunk) pair of
    ``global_allow`` exactly once over the ranks."""
    plan = sp.build_plan(sched, mk.causal(), P7_RANKS, P7_T // P7_RANKS)
    n = P7_RANKS * plan.n_chunks
    got = np.zeros((n, n), np.int64)
    want = [0] * P7_RANKS
    d = 0
    for step in plan.steps:
        d += step.shift
        for w in step.work:
            for p in range(P7_RANKS):
                if any(sp.route_reaches(r, P7_RANKS, p) for r in w.routes):
                    qg, kg, _ = sp.work_operands(plan, w, p, d)
                    got[qg, kg] += 1
                    want[p] += 1
    check(bool((got == sp.global_allow(mk.causal(), n)).all()),
          f"{sched}: the ranks' routes do not compute every causal chunk "
          f"pair once")
    return want


def _p7_rank(rank, ref_path):
    """One rank of phase 7's world (its process and world are started by
    ``spawn``): the per-token losses of the first batch under balanced
    and under the control, the attention projections' gradients of that
    batch under each schedule and under the backward controls (held on
    rank 0 to the P = 1 gradients saved at ``ref_path``), a train step
    under each backward control (undone), then the train steps of
    ``P7_RUNS``."""
    mesh = make_local_mesh(seq=P7_RANKS, device=DEV)
    p = mesh.coord("model")
    cfg = get_config("llama-7b").replace(n_layers=P7_LAYERS)
    shape = ShapeSpec("chip7", P7_T, 1, "train")
    models = {s: DecoderLM(cfg, DEV, mesh=mesh, par=make_parallel_config(
        mesh, shape, schedule=s)) for s, _ in P7_RUNS}
    data = {s: SyntheticTokens(cfg, shape, device=DEV, seed=0, mesh=mesh,
                               par=m.par) for s, m in models.items()}
    params = trainable(models["balanced"].init(seed=0))
    out = {"transport": mesh.transport, "rank": p}
    b0 = data["balanced"].batch(0)
    out["ce"] = _token_ce(models["balanced"], params, b0).cpu()
    real = sp.build_plan
    sp.build_plan = _helperless(real)
    try:
        out["ce_control"] = _token_ce(models["balanced"], params, b0).cpu()
    finally:
        sp.build_plan = real
    ref = torch.load(ref_path, map_location=DEV) if p == 0 else None
    out["grad_err"] = {}
    for sched, fault in P7_GRAD_RUNS:
        with _backward_fault(fault):
            gs = _attn_grads(models[sched], params, data[sched].batch(0))
        if ref is not None:
            out["grad_err"][f"{sched}/{fault or 'sound'}"] = _grad_err(gs,
                                                                       ref)
        del gs
    del ref
    # the controls through a whole train step from the same start: step
    # 1's gradient norm and the loss of batch 1 after the update
    bal, tc = models["balanced"], _p7_tc()
    saved = [t.detach().clone() for t in leaves(params)]
    out["control_steps"] = {}
    for fault in ("home", "dqb"):
        opt = adamw.init(params)
        with _backward_fault(fault):
            m = make_train_step(bal, tc)(params, opt, b0)
        with torch.no_grad():
            l2 = float(bal.loss(params, data["balanced"].batch(1))[0])
            for t, v in zip(leaves(params), saved):
                t.copy_(v)
        out["control_steps"][fault] = (m["gnorm"], l2)
        del opt
    del saved
    _free()
    comms = list({id(c): c for m in models.values()
                  for c in (m.seq_group, m.token_group)}.values())
    opt = adamw.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, i = [], 0
    for sched, n in P7_RUNS:
        step = make_train_step(models[sched], tc)
        for _ in range(n):
            batch = data[sched].batch(i)
            torch.cuda.synchronize()
            build.reset_launches()
            w0 = sum(c.shift_wait_s for c in comms)
            r0 = sum(c.reduce_s for c in comms)
            t0 = time.perf_counter()
            m = step(params, opt, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            steps.append(dict(
                schedule=sched, loss=m["loss"], gnorm=m["gnorm"], sec=sec,
                shift_wait=sum(c.shift_wait_s for c in comms) - w0,
                reduce_sec=sum(c.reduce_s for c in comms) - r0,
                skipped=m["skipped_nonfinite"],
                launches={k: build.LAUNCHES[k] for k in BWD_KERNELS}))
            i += 1
    out["steps"] = steps
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _p7_one(cfg, shape, ref_path):
    """P = 1 on this process: the first batch's per-token losses, its
    attention projections' gradients (saved at ``ref_path``), and two
    train steps from the same weights (step 1's loss and gradient norm,
    step 2's loss)."""
    one = DecoderLM(cfg, DEV)
    params = trainable(one.init(seed=0))
    ds = SyntheticTokens(cfg, shape, device=DEV, seed=0)
    b0 = ds.batch(0)
    ce1 = _token_ce(one, params, b0).cpu()
    torch.save([g.cpu() for g in _attn_grads(one, params, b0)], ref_path)
    step = make_train_step(one, _p7_tc())
    opt = adamw.init(params)
    s1 = step(params, opt, b0)
    s2 = step(params, opt, ds.batch(1))
    del one, params, opt, step
    _free()
    return ce1, s1, s2


def multi_rank():
    """Phase 7: a gloo world of 4 ranks sharing the one card, training
    llama-7b's width at depth 2 on one sequence of 32768 tokens (8192 a
    rank) under remat_aware: 3 balanced steps, 1 ring, 1 zigzag.  Before
    the world starts, the same weights and batches run on one process
    (P = 1), for the per-token losses, gradients and first two steps the
    ranks are held to."""
    cfg = get_config("llama-7b").replace(n_layers=P7_LAYERS)
    shape = ShapeSpec("chip7", P7_T, 1, "train")
    want = {s: _p7_want(s) for s, _ in P7_RUNS}
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "grads1.pt")
        ce1, s1, s2 = _p7_one(cfg, shape, ref_path)
        say(f"  P = 1: loss {float(ce1.mean()):.6f} over {P7_T} tokens "
            f"({cfg.name} width, {P7_LAYERS} layers, bf16); step 1 loss "
            f"{s1['loss']:.6f} gnorm {s1['gnorm']:.4f}, step 2 loss "
            f"{s2['loss']:.6f}")
        t0 = time.perf_counter()
        res = spawn(_p7_rank, P7_RANKS, (ref_path,), device=DEV,
                    timeout=P7_TIMEOUT, threads=2)
        wall = time.perf_counter() - t0
    res.sort(key=lambda r: r["rank"])
    check(all(r["transport"] == P7_TRANSPORT for r in res),
          f"transport {[r['transport'] for r in res]}")
    ce4 = torch.cat([r["ce"] for r in res], dim=1)
    ctl = torch.cat([r["ce_control"] for r in res], dim=1)
    check(bool(torch.isfinite(ce4).all()), "P = 4 losses not finite")
    d_tok = float((ce4 - ce1).abs().mean())
    d_ctl = float((ctl - ce1).abs().mean())
    d_loss = abs(float(ce4.mean()) - float(ce1.mean()))
    d_loss_ctl = abs(float(ctl.mean()) - float(ce1.mean()))
    st4 = res[0]["steps"]
    step1 = abs(st4[0]["loss"] - float(ce1.mean()))
    d_gnorm = abs(st4[0]["gnorm"] - s1["gnorm"]) / s1["gnorm"]
    d_loss2 = abs(st4[1]["loss"] - s2["loss"])
    gerr = res[0]["grad_err"]
    ctl_steps = {f: (abs(gn - s1["gnorm"]) / s1["gnorm"],
                     abs(l2 - s2["loss"]))
                 for f, (gn, l2) in res[0]["control_steps"].items()}
    say(f"  P = 4 (balanced) vs P = 1: |Δloss| {d_loss:.3e} (limit "
        f"{P7_LOSS_TOL}), mean |Δce| a token {d_tok:.3e} (limit "
        f"{P7_CE_TOL}), max {float((ce4 - ce1).abs().max()):.3e}; control "
        f"(helper routes dropped): |Δloss| {d_loss_ctl:.3e}, mean |Δce| a "
        f"token {d_ctl:.3e}")
    say("  backward vs P = 1, worst ‖Δg‖/‖g‖ of wq/wk/wv (limit "
        f"{P7_GRAD_TOL}): " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in gerr.items()))
    say(f"  step 1 gnorm {st4[0]['gnorm']:.4f} vs {s1['gnorm']:.4f}: "
        f"relative |Δ| {d_gnorm:.3e} (limit {P7_GNORM_TOL}); step 2 loss "
        f"{st4[1]['loss']:.6f} vs {s2['loss']:.6f}: |Δ| {d_loss2:.3e} "
        f"(limit {P7_LOSS2_TOL}); controls: " + ", ".join(
            f"{f} {gn:.3e} / {l2:.3e}" for f, (gn, l2) in ctl_steps.items()))
    check(d_tok <= P7_CE_TOL and d_loss <= P7_LOSS_TOL
          and step1 <= P7_LOSS_TOL,
          f"P = 4 vs P = 1: per-token {d_tok}, loss {d_loss}, first step's "
          f"loss {step1}")
    check(d_ctl > P7_CE_TOL and d_loss_ctl > P7_LOSS_TOL,
          f"the limits do not reject the control without helper routes "
          f"(per-token {d_ctl}, loss {d_loss_ctl})")
    for sched, fault in P7_GRAD_RUNS:
        e = gerr[f"{sched}/{fault or 'sound'}"]
        if fault:
            check(e > P7_GRAD_TOL, f"the gradient limit does not reject "
                  f"the {fault} control ({e})")
        else:
            check(e <= P7_GRAD_TOL, f"{sched} gradients vs P = 1: {e}")
    check(d_gnorm <= P7_GNORM_TOL and d_loss2 <= P7_LOSS2_TOL,
          f"P = 4 vs P = 1: step 1 gnorm {d_gnorm}, step 2 loss {d_loss2}")
    for fault, (_, e_l2) in ctl_steps.items():
        check(e_l2 > P7_LOSS2_TOL, f"the step-2 loss limit does not reject "
              f"the {fault} control ({e_l2})")
    check(ctl_steps["home"][0] > P7_GNORM_TOL, f"the gradient-norm limit "
          f"does not reject the home control ({ctl_steps['home'][0]})")
    launches = {k: 0 for k in BWD_KERNELS}
    for r in res:
        for i, st in enumerate(r["steps"]):
            check(st["skipped"] == 0, f"rank {r['rank']} step {i + 1} "
                  "skipped")
            check(np.isfinite(st["loss"]), f"rank {r['rank']} step {i + 1}"
                  f" loss {st['loss']}")
            w = P7_LAYERS * want[st["schedule"]][r["rank"]]
            check(all(st["launches"][k] == w for k in BWD_KERNELS),
                  f"rank {r['rank']} step {i + 1} ({st['schedule']}): "
                  f"launches {st['launches']}, want {w} each")
            for k in BWD_KERNELS:
                launches[k] += st["launches"][k]
        say(f"  rank {r['rank']}: peak {r['peak'] / 2**30:.2f} GiB; "
            "launches A/C/D a step " + ", ".join(
                f"{st['schedule']} {st['launches']['flash_fwd']}/"
                f"{st['launches']['flash_bwd_dq']}/"
                f"{st['launches']['flash_bwd_dkv']}"
                for st in r["steps"]))
    for i, st in enumerate(st4):
        losses = {r["steps"][i]["loss"] for r in res}
        check(len(losses) == 1, f"step {i + 1}: ranks disagree {losses}")
        say(f"  step {i + 1} {st['schedule']:<8} loss {st['loss']:.5f} "
            f"gnorm {st['gnorm']:.3f} "
            f"{max(r['steps'][i]['sec'] for r in res):.2f} s; host blocked "
            "on shifts / in gradient and loss all-reduces, per rank: "
            + ", ".join(f"{r['steps'][i]['shift_wait']:.2f}/"
                        f"{r['steps'][i]['reduce_sec']:.2f}" for r in res)
            + " s")
    say(f"  world of {P7_RANKS} ranks: {wall:.1f} s, spawn included")
    return dict(launches=launches, d_tok=d_tok, d_ctl=d_ctl, d_loss=d_loss,
                d_loss_ctl=d_loss_ctl, grad_err=gerr, d_gnorm=d_gnorm,
                d_loss2=d_loss2)


# ----------------------------------------------------------------- phase 5

def ptxas_kernels(text):
    """{kernel name: (registers, spill bytes)} from nvcc's ``-Xptxas -v``
    output, by the entry function each report follows."""
    out, name, spill = {}, None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1] + nums[2]     # spill stores, spill loads
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split("registers")[0])
            out[name] = (regs, spill)
    return out


def tensor_core_report(report):
    """Registers, spills and shared memory of the tensor-core routes at each
    head dim: kernel A's (``flash_fwd_sm90``) and kernels C and D's
    (``flash_bwd_sm90``); none may spill at D = 128."""
    import ctypes
    fwd = build.load("flash_fwd_sm90").repro_flash_fwd_sm90_smem
    fwd.argtypes, fwd.restype = [ctypes.c_int], ctypes.c_int
    bwd = build.load("flash_bwd_sm90").repro_flash_bwd_sm90_smem
    bwd.argtypes, bwd.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    seen = 0
    for lib in ("flash_fwd_sm90", "flash_bwd_sm90"):
        for mangled, (regs, spill) in sorted(
                ptxas_kernels(report[lib]).items()):
            d = int(mangled.split("ILi")[1].split("E")[0])
            if lib == "flash_fwd_sm90":
                name, smem = "A fwd", fwd(d)
            else:
                kernel = 0 if "dq_wgmma" in mangled else 1
                name, smem = ("C dq", "D dkv")[kernel], bwd(kernel, d)
            say(f"  ptxas {name} wgmma D={d}: {regs} registers, {spill} "
                f"bytes spilled, {smem} bytes dynamic shared memory")
            check(d != 128 or spill == 0, f"kernel {mangled} spills {spill} "
                  f"bytes at D = 128")
            seen += d == 128
    check(seen == 3, "ptxas reported fewer than three D = 128 tensor-core "
          "kernels")


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
    return {"name": "flash_fwd", "route": "cuda", "design": FWD_DESIGN,
            "source": "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
            "float32_source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:157",
            "launches": launches["flash_fwd"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def time_flash_train(seen):
    """Kernel A at the training shape: the layer-1 forward inputs kept in
    phase 6 (B 1, T 8192, 32 heads × 128, bf16, causal), beside its bound,
    its plain version over head slices and SDPA's causal forward."""
    (q, k, v), kw = _moved(seen["fwd"], DEV)
    B, T, H, D = q.shape
    ms = cuda_ms(lambda: flash_fwd(q, k, v, **kw), reps=10, warmup=2)
    slices = _head_slices(q, k)
    plain = cuda_ms(lambda: [chunk_attn_ref(q[:, :, sq], k[:, :, skv],
                                            v[:, :, skv], **kw)
                             for sq, skv in slices], reps=3, warmup=1)
    _free()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=kw.get("scale"),
        enable_gqa=H != k.shape[2]), reps=10, warmup=2)
    pairs = B * H * T * (T + 1) // 2
    flops = 4.0 * D * pairs
    nbytes = 2 * B * T * D * (2 * H + 2 * k.shape[2]) + 4 * B * T * H
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  flash_fwd  B{B} T{T} H{H} D{D} bf16 causal (training shape): "
        f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / ms:.4f} of the bound), plain {plain:.4f} ms, sdpa "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e12:.3f} "
        f"TFLOP, {nbytes / 1e6:.1f} MB)")
    del q, k, v, qt, kt, vt
    _free()
    return {"train_ms": ms, "train_plain_ms": plain, "train_bound_ms": b_ms,
            "train_bound_by": b_by, "train_library_ms": lib}


PAGED_DESIGN = ("split-KV (flash-decoding): grid (Hkv, B, S) over splits of "
                "L_s tokens (256 at bf16 D 128) fixed by the request's own "
                "positions; 256-thread blocks stage each split's pages in "
                "32-token tiles through a 4-stage 16-byte cp.async ring (48 "
                "KB in flight a block, three blocks an SM); scores, one max "
                "and sum per tile and p·v on the CUDA cores in float32; a "
                "second kernel merges the splits in a fixed order")
PAGED_LIBRARY = ("none: no single PyTorch call computes attention through a "
                 "block table (SDPA takes contiguous K/V)")
PAGED_POOLS = 4     # pool pairs the L2-cold timings rotate over


def _paged_device_ms(call, n=40):
    """Kernel B's own device time per call: torch.profiler's device time of
    every kernel named ``paged_decode*`` over n calls (split and merge)."""
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


def _paged_timing(gen, B, Tq, Hq, Hkv, D, bs, lens):
    """Kernel B L2-cold at one shape: every launch reads one of PAGED_POOLS
    distinct pool pairs in turn (together far above the 50 MB L2, as the
    engine's 32 layers are).  Returns its device time, the wrapper's time
    (CUDA events around one call), the host time of one call (a host clock
    around 1000 calls, no sync inside), the plain version's time, the bound
    and the error against the plain version."""
    q, kp, vp, bt, ln = _paged_inputs(gen, B, Tq, Hq, Hkv, D, bs, lens,
                                      torch.bfloat16)
    pools = [(kp, vp)] + [(torch.randn_like(kp), torch.randn_like(vp))
                          for _ in range(PAGED_POOLS - 1)]
    m = mk.causal()

    def call(i):
        k, v = pools[i % PAGED_POOLS]
        return paged_attn(q, k, v, bt, ln, mask=m)
    o = call(0)
    o_r = paged_attn_ref(q, kp, vp, bt, ln, mask=m)
    err = float((o.float() - o_r.float()).abs().max())
    dev = _paged_device_ms(call)
    it = iter(range(1 << 30))
    wrap = cuda_ms(lambda: call(next(it)), reps=20, warmup=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1000):
        call(i)
    host = 1e3 * (time.perf_counter() - t0) / 1000
    torch.cuda.synchronize()
    plain = cuda_ms(lambda: paged_attn_ref(q, *pools[next(it) % PAGED_POOLS],
                                           bt, ln, mask=m), reps=5, warmup=1)
    ctx = sum(lens)
    flops = 4.0 * ctx * Hq * Tq * D
    nbytes = 2 * (2 * ctx * Hkv * D + 2 * B * Tq * Hq * D) \
        + 4 * (B + bt.numel())
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say(f"  paged_decode B{B} Tq{Tq} Hq{Hq} Hkv{Hkv} D{D} bs{bs} bf16 "
        f"lengths {lens if len(lens) < 5 else len(lens)}, L2-cold: device "
        f"{dev:.4f} ms ({nbytes / dev / 1e6:.1f} GB/s, {b_ms / dev:.3f} of "
        f"the bound), wrapper {wrap:.4f} ms, host {host:.4f} ms a call, "
        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes / 1e6:.2f} MB), max|Δo| {err:.3e}")
    del q, kp, vp, pools, o, o_r
    _free()
    return dict(ms=dev, wrapper_ms=wrap, host_ms=host, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)


def time_paged(launches):
    """Kernel B, L2-cold, at the serving shape (one decode step of the 4
    requests, lengths mid-way through their 32 new tokens, bs 16), at a
    long-context decode (one 32768-token request) and at the GQA shape of
    phase 3 (Tq 4, 32 query heads over 8 kv heads)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    lens = [1016, 716, 529, 80]
    serve = _paged_timing(gen, 4, 1, 32, 32, 128, 16, lens)
    long = _paged_timing(gen, 1, 1, 32, 32, 128, 16, [32768])
    gqa = _paged_timing(gen, 4, 4, 32, 8, 128, 16, lens)
    row = {"name": "paged_decode", "route": "cuda", "design": PAGED_DESIGN,
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/paged.py:182",
           "launches": launches["paged_decode"], "library_ms": None,
           "library_note": PAGED_LIBRARY}
    row.update(serve)
    for name, r in (("long", long), ("gqa", gqa)):
        row.update({f"{name}_{k}": x for k, x in r.items()})
    return row


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
            f"({fl / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.4f} of the bound), "
            f"plain {plain_ms[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{fl / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB), max|Δ| vs plain "
            f"{errs[name]:.3e}")
        rows.append({"name": name, "route": "cuda", "design": BWD_DESIGN,
                     "source":
                         "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
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
    say(f"  {list(report)} built from the checkout's sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in report.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    tensor_core_report(report)

    say("== phase 3: kernels against their plain versions")
    kernel_checks()
    bwd_checks()
    say("== phase 3c: kernels A, C and D under every plan step's mask")
    plan_step_checks()

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
    say("== phase 7: multi-rank training, 4 ranks on the one card")
    mr = multi_rank()

    say("== phase 5: times at the shapes of each path")
    launches = {k: res["launches"][k] + tr["launches"].get(k, 0)
                + mr["launches"].get(k, 0) for k in res["launches"]}
    say(f"  launches on the main paths: serve {res['launches']}, "
        f"train {tr['launches']}, multi-rank (all ranks) {mr['launches']}")
    rows = [time_flash(launches), time_paged(launches),
            *time_bwd(launches, tr["seen"], errs)]
    rows[0].update(time_flash_train(tr["seen"]))
    say(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
