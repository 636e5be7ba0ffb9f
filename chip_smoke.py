#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one NVIDIA H100

Phases, each fatal on failure (nothing is caught):

  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``.
  3. kernels  — each kernel's wrapper against its plain PyTorch version on
                the card, at llama-7b serving shapes plus edge cases;
                tolerances float32 1e-5 (paged 2e-5), bf16 2e-2.
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
  5. times    — each kernel at the serving shapes: its time (CUDA events,
                median after warm-up), its plain version's, a library call's
                where one exists, and the least time the card could take.

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
from repro_torch.core.config import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_fwd  # noqa: E402
from repro_torch.kernels.paged import paged_attn, paged_attn_ref  # noqa: E402
from repro_torch.kernels.ref import NEG_INF, chunk_attn_ref  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
LOGIT_REL_TOL = 5e-2          # bf16, 32 layers: |Δ| ≤ 5% of max |logit|
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
    say(f"  A {name:<28} {str(dtype)[6:]:<9} max|Δo| {err:.3e}  "
        f"max|Δlse| {lerr:.3e}  tol {tol}")


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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
        fam, busy, wall_ms = _device_breakdown(prof, wall)
        say(f"  trace {label}: wall {wall_ms:.1f} ms (under the profiler), "
            f"device busy {busy:.1f} ms, idle share "
            f"{1 - busy / wall_ms:.3f}")
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

    say("== phase 4: serve llama-7b")
    res = serve()
    say(f"  launches per decode step: paged_decode "
        f"{res['per_decode_step']:.1f}; per prefill chunk: flash_fwd "
        f"{res['per_chunk']:.1f}")

    say("== phase 5: times at the serving shapes")
    rows = [time_flash(res["launches"]), time_paged(res["launches"])]
    say(f"  total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
