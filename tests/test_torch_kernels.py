"""Parity of the port's kernel modules with the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference (the Pallas kernels
in interpret mode, and the pure-jnp oracle) and through the port's kernel
wrappers, which on a CPU tensor run their plain PyTorch versions.  Bars are
the reference's own: chunk forward o 1e-5 and lse 1e-4 in float32, chunk
backward 2e-4 in float32 and 5e-2 in bf16 (tests/test_kernels.py), paged
decode 2e-5 (tests/test_paged_cache.py).  The port's host-side
block-sparse planning must equal the reference's range math exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mask as rmk
from repro.kernels import block_sparse as rbs
from repro.kernels import ops
from repro.kernels.paged import paged_attn_pallas
from repro.kernels.ref import chunk_attn_ref as r_chunk_attn_ref
from repro_torch.core import mask as tmk
from repro_torch.core.attention import chunk_attn, chunk_attn_bwd, merge
from repro_torch.kernels import block_sparse as tbs
from repro_torch.kernels.flash_attention import (flash_bwd, flash_fwd,
                                                 q_tile_bounds, tile_bounds)
from repro_torch.kernels.paged import (paged_attn, paged_attn_ref,
                                       paged_attn_split_ref, split_plan)
from repro_torch.kernels.ref import (NEG_INF, chunk_attn_bwd_ref,
                                     chunk_attn_ref, row_rel_err)

O_TOL, LSE_TOL, PAGED_TOL = 1e-5, 1e-4, 2e-5


def _spec_pair(kind, **kw):
    """The same mask built in both packages."""
    return getattr(rmk, kind)(**kw), getattr(tmk, kind)(**kw)


def _qkv(rng, B, Tq, Tk, Hq, Hkv, D):
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    return q, k, v


def _assert_partial(o_t, lse_t, o_r, lse_r):
    o_t, lse_t = o_t.numpy(), lse_t.numpy()
    o_r, lse_r = np.asarray(o_r), np.asarray(lse_r)
    np.testing.assert_allclose(o_t, o_r, atol=O_TOL, rtol=O_TOL)
    valid = (lse_r > NEG_INF / 2) | (lse_t > NEG_INF / 2)
    np.testing.assert_allclose(np.where(valid, lse_t, 0),
                               np.where(valid, lse_r, 0),
                               atol=LSE_TOL, rtol=LSE_TOL)


# (name, mask kind, mask kwargs, B, Tq, Tk, Hq, Hkv, D)
FLASH_CASES = [
    ("causal", "causal", {}, 1, 128, 128, 4, 4, 32),
    ("causal_gqa_qoffset", "causal", {"rel_offset": 64}, 2, 64, 128, 4, 2,
     64),
    ("window", "sliding_window", {"window": 40}, 1, 128, 128, 4, 1, 32),
    ("prefix_lm", "prefix_lm", {"prefix_len": 30}, 1, 128, 128, 2, 2, 64),
    ("document_static", "document", {"boundaries": (0, 50, 90)}, 1, 128,
     128, 4, 2, 32),
    ("full_offset", "full", {"rel_offset": 256}, 1, 64, 128, 4, 4, 32),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_matches_reference(case):
    _, kind, kw, B, Tq, Tk, Hq, Hkv, D = case
    r_mask, t_mask = _spec_pair(kind, **kw)
    q, k, v = _qkv(np.random.default_rng(0), B, Tq, Tk, Hq, Hkv, D)
    o_p, lse_p = ops.flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mask=r_mask, interpret=True)
    o_r, lse_r = r_chunk_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mask=r_mask)
    o_t, lse_t = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask=t_mask)
    _assert_partial(o_t, lse_t, o_p, lse_p)
    _assert_partial(o_t, lse_t, o_r, lse_r)


def test_flash_fwd_document_segments_matches_reference():
    """Dynamic (B, T) segment operands (document without boundaries)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 128, 128, 4, 2, 64)
    seg = np.sort(rng.integers(0, 3, (2, 128)), axis=1).astype(np.int32)
    r_mask, t_mask = _spec_pair("document")
    o_p, lse_p = ops.flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mask=r_mask, interpret=True,
                               q_segments=jnp.asarray(seg),
                               kv_segments=jnp.asarray(seg))
    ts = torch.from_numpy(seg)
    o_t, lse_t = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask=t_mask, q_segments=ts,
                           kv_segments=ts)
    _assert_partial(o_t, lse_t, o_p, lse_p)


@pytest.mark.parametrize("Tq,Tk,D", [(100, 164, 32), (37, 300, 64)])
def test_chunk_attn_ragged_matches_reference_oracle(Tq, Tk, D):
    """Ragged chunk lengths (no block divisor) and a folded numpy-int
    q_offset, as the engine's prefill chunk reaches chunk_attn."""
    r_mask, t_mask = _spec_pair("causal")
    q, k, v = _qkv(np.random.default_rng(2), 1, Tq, Tk, 4, 2, D)
    off = np.int64(Tk - Tq)
    o_r, lse_r = r_chunk_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mask=r_mask,
                                  q_offset=int(off))
    o_t, lse_t = chunk_attn(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), mask=t_mask, q_offset=off)
    _assert_partial(o_t, lse_t, o_r, lse_r)


def test_fold_offsets_makes_static_specs():
    m = tmk.fold_offsets(tmk.causal(), np.int32(5), torch.tensor(2))
    assert m == tmk.MaskSpec(causal=True, q_offset=5, kv_offset=2)
    assert tmk.fold_offsets(tmk.causal(), None, 0) == tmk.causal()
    with pytest.raises(TypeError):
        tmk.fold_offsets(tmk.causal(), 1.5, 0)


def test_merge_and_empty_rows_match_reference():
    """Two partials over split KV chunks merge to the whole; fully masked
    rows keep the o = 0, lse = NEG_INF contract."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 64, 128, 2, 2, 32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    mask = tmk.causal(rel_offset=32)
    o_full, lse_full = chunk_attn(tq, tk, tv, mask=mask)
    o1, l1 = chunk_attn(tq, tk[:, :64], tv[:, :64], mask=mask)
    o2, l2 = chunk_attn(tq, tk[:, 64:], tv[:, 64:], mask=mask, kv_offset=64)
    o_m, lse_m = merge(o1, l1, o2, l2)
    np.testing.assert_allclose(o_m.numpy(), o_full.numpy(), atol=O_TOL)
    np.testing.assert_allclose(lse_m.numpy(), lse_full.numpy(), atol=LSE_TOL)
    o_e, lse_e = chunk_attn(tq, tk, tv, mask=tmk.causal(rel_offset=-200))
    assert float(o_e.abs().max()) == 0.0
    assert bool((lse_e == NEG_INF).all())


def _random_specs(seed, n):
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(n):
        kind = rng.integers(0, 5)
        qo = int(rng.integers(-64, 512))
        ko = int(rng.integers(0, 256))
        if kind == 0:
            kw = dict(causal=True)
        elif kind == 1:
            kw = dict(causal=bool(rng.integers(0, 2)),
                      window=int(rng.integers(1, 300)))
        elif kind == 2:
            kw = dict(causal=True, prefix_len=int(rng.integers(1, 400)))
        elif kind == 3:
            cuts = sorted(set(int(x) for x in rng.integers(1, 700, 3)))
            kw = dict(causal=True, document=True,
                      boundaries=(0, *cuts))
        else:
            kw = dict(causal=False)
        specs.append((kw, qo, ko))
    return specs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_sparse_bounds_equal_reference(seed):
    for kw, qo, ko in _random_specs(seed, 40):
        rm = rmk.MaskSpec(q_offset=qo, kv_offset=ko, **kw)
        tm = tmk.MaskSpec(q_offset=qo, kv_offset=ko, **kw)
        for br, bc, nq, nk in [(64, 64, 4, 8), (32, 128, 6, 3),
                               (128, 32, 2, 16)]:
            for i in range(nq):
                for fn in ("kv_block_bounds", "interior_kv_bounds"):
                    a = tuple(int(x) for x in getattr(rbs, fn)(
                        i, br=br, bc=bc, nk=nk, mask=rm))
                    b = getattr(tbs, fn)(i, br=br, bc=bc, nk=nk, mask=tm)
                    assert a == b, (fn, kw, qo, ko, br, bc, i)
            pr = rbs.kv_profile(nq=nq, nk=nk, br=br, bc=bc, mask=rm)
            pt = tbs.kv_profile(nq=nq, nk=nk, br=br, bc=bc, mask=tm)
            assert dataclasses_eq(pr, pt), (kw, qo, ko)
    for T, blk in [(128, 128), (96, 64), (100, 64), (37, 32), (1024, 128)]:
        assert rbs.pick_block(T, blk) == tbs.pick_block(T, blk)


def dataclasses_eq(a, b) -> bool:
    return (a.rows, a.cols, tuple(a.row_counts), a.seq_grid, a.full_steps,
            a.launched_steps, a.executed_steps) == \
        (b.rows, b.cols, tuple(b.row_counts), b.seq_grid, b.full_steps,
         b.launched_steps, b.executed_steps)


def test_tile_bounds_plan():
    """Kernel A's host plan: 64-row tiles, pruned rows from the static
    spec, the dense plan sweeps and masks everything."""
    m = tmk.causal(rel_offset=768)
    rows = tile_bounds(m, 256, 1024 + 64)       # Tk past the context
    assert [r[:2] for r in rows] == [(0, 12), (0, 13), (0, 14), (0, 15)]
    assert [r[2:] for r in rows] == [(0, 11), (0, 12), (0, 13), (0, 14)]
    dense = tile_bounds(m, 100, 300, prune=False)
    assert dense == [(0, 4, 1, 0), (0, 4, 1, 0)]
    assert all(hi < lo for lo, hi, _, _ in
               tile_bounds(tmk.causal(rel_offset=-500), 128, 128))


def test_q_block_bounds_equal_reference_and_cover_the_forward():
    """Kernel D's transposed plan equals the reference's, and every kv
    block a q block's forward range reaches sweeps that q block back."""
    for seed in (0, 1, 2):
        for kw, qo, ko in _random_specs(seed, 40):
            rm = rmk.MaskSpec(q_offset=qo, kv_offset=ko, **kw)
            tm = tmk.MaskSpec(q_offset=qo, kv_offset=ko, **kw)
            for br, bc, nq, nk in [(64, 64, 4, 8), (32, 128, 6, 3),
                                   (128, 32, 2, 16)]:
                for j in range(nk):
                    a = tuple(int(x) for x in rbs.q_block_bounds(
                        j, br=br, bc=bc, nq=nq, mask=rm))
                    assert a == tbs.q_block_bounds(j, br=br, bc=bc, nq=nq,
                                                   mask=tm), (kw, qo, ko, j)
                assert dataclasses_eq(
                    rbs.q_profile(nq=nq, nk=nk, br=br, bc=bc, mask=rm),
                    tbs.q_profile(nq=nq, nk=nk, br=br, bc=bc, mask=tm))
            rows = tile_bounds(tm, 200, 300)
            cols = q_tile_bounds(tm, 200, 300)
            for i, (lo, hi, _, _) in enumerate(rows):
                for j in range(lo, hi + 1):
                    assert cols[j][0] <= i <= cols[j][1], (kw, qo, ko, i, j)


# the reference's own sweep (tests/test_kernels.py CASES):
# (B, Tq, Tk, Hq, Hkv, D, causal, rel, window, dtype)
BWD_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0, 0, "float32"),
    (2, 128, 128, 4, 2, 64, False, 256, 0, "float32"),
    (1, 256, 128, 2, 1, 32, False, 512, 300, "float32"),
    (1, 64, 64, 2, 2, 16, True, 0, 0, "float32"),
    (1, 128, 256, 8, 8, 128, False, 512, 0, "float32"),
    (2, 128, 128, 2, 2, 64, True, 0, 100, "float32"),
    (1, 128, 128, 2, 2, 64, True, 0, 0, "bfloat16"),
    (1, 256, 256, 3, 1, 64, True, 0, 0, "float32"),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_matches_reference_kernel(case):
    B, Tq, Tk, Hq, Hkv, D, causal, rel, window, dt = case
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, B, Tq, Tk, Hq, Hkv, D)
    do = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    r_mask = rmk.MaskSpec(causal=causal, window=window, q_offset=rel)
    t_mask = tmk.MaskSpec(causal=causal, window=window, q_offset=rel)
    jd, td = jnp.dtype(dt), getattr(torch, dt)
    jq, jk, jv, jdo = (jnp.asarray(x, jd) for x in (q, k, v, do))
    o, lse = r_chunk_attn_ref(jq, jk, jv, mask=r_mask)
    ref = ops.flash_bwd(jq, jk, jv, o, lse, jdo, mask=r_mask, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(td) for x in (q, k, v, do))
    to = torch.from_numpy(np.array(o, np.float32)).to(td)
    got = flash_bwd(tq, tk, tv, to, torch.from_numpy(np.array(lse)), tdo,
                    mask=t_mask)
    tol = 2e-4 if dt == "float32" else 5e-2
    for a, r in zip(got, ref):
        assert a.dtype == td
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r, np.float32), atol=tol,
                                   rtol=tol)


def test_chunk_attn_bwd_folds_offsets_and_takes_delta():
    """Offsets fold into the mask as in chunk_attn; a passed delta gives
    the same result; fully masked rows contribute nothing; the ``ref``
    backend is the plain backward."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 64, 96, 4, 2, 32))
    do = torch.from_numpy(rng.standard_normal((1, 64, 4, 32)).astype(
        np.float32))
    m = tmk.causal()
    o, lse = chunk_attn(q, k, v, mask=m, q_offset=np.int64(-16))
    a = chunk_attn_bwd(q, k, v, o, lse, do, mask=m, q_offset=np.int64(-16))
    b = chunk_attn_bwd_ref(q, k, v, o, lse, do,
                           mask=tmk.causal(rel_offset=-16),
                           delta=(o * do).sum(-1))
    c = chunk_attn_bwd(q, k, v, o, lse, do, mask=m, q_offset=-16,
                       impl="ref")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, z)
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
    assert float(a[0][:, :16].abs().max()) == 0.0   # rows that see no key


@pytest.mark.parametrize("only", ["dq", "dkv"])
def test_plain_bwd_parts_equal_the_whole(only):
    """``only=`` (the plain version of kernel C or D alone) gives exactly
    that part of the whole backward, GQA sums included."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 64, 64, 4, 2, 32))
    do = torch.from_numpy(rng.standard_normal((1, 64, 4, 32)).astype(
        np.float32))
    m = tmk.sliding_window(20)
    o, lse = chunk_attn_ref(q, k, v, mask=m)
    whole = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=m)
    part = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=m, only=only)
    keep = (0,) if only == "dq" else (1, 2)
    for i in range(3):
        if i in keep:
            assert torch.equal(part[i], whole[i])
        else:
            assert part[i] is None
    with pytest.raises(ValueError, match="only"):
        chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=m, only="dk")


ROW_TOL = 2e-2   # chip_smoke.py's per-row bar for kernels C and D in bf16


def _tensor_core_bwd(q, k, v, o, lse, do, mask):
    """A tensor-core backward's arithmetic, emulated on the CPU: float32
    scores and sums, p and ds rounded to bf16 before the second products
    (dq = ds·k, dk = dsᵀ·q, dv = pᵀ·do), bf16 outputs.  Kernel D does
    exactly this; kernel C takes ds as two bf16 terms, which is closer."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    allow = mask.allow(torch.arange(q.shape[1])[:, None],
                       torch.arange(k.shape[1])[None, :])
    p = torch.where(allow, torch.exp(s - lse.transpose(1, 2)[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (of * dof).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * scale
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def test_bf16_backward_row_gate_passes_rounded_p_ds_rejects_missing_tile():
    """The bar kernels C and D's bf16 outputs are held to on the card: a
    backward that rounds p and ds to bf16 fails the element-wise bar of
    kernel A (3e-2 of each element) yet passes the per-row bar (2e-2 of
    each row's norm), and the per-row bar rejects a plain backward that
    never visits the last 64-key tile."""
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 512, 2, 64)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    m = tmk.causal()
    o, lse = chunk_attn_ref(q, k, v, mask=m)
    ref = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=m)
    emu = _tensor_core_bwd(q, k, v, o, lse, do, m)
    bq, bk, bv = chunk_attn_bwd_ref(q, k[:, :-64], v[:, :-64], o, lse, do,
                                    mask=m)
    pad = torch.zeros_like(k[:, -64:])
    bad = (bq, torch.cat([bk, pad], 1), torch.cat([bv, pad], 1))
    for a, b, r in zip(emu, bad, ref):
        rf = r.float()
        floor = 1e-3 * rf.abs().max()
        elementwise = float(((a.float() - rf).abs() / (rf.abs() + floor))
                            .max())
        assert elementwise > 3e-2
        assert row_rel_err(a, r) <= ROW_TOL / 2
        assert row_rel_err(b, r) > 5 * ROW_TOL


def _pair_route_bwd(q, k, v, o, lse, do, mask, scale):
    """Kernels C and D's bf16 pair route (q/k 192, v 128) emulated on the
    CPU: float32 scores and p; D in one pass, pᵀ handed across in float32,
    dv from bf16 pᵀ, dk from bf16 dsᵀ; C takes ds as two bf16 terms (hi and
    the rounding remainder lo) into two float32 accumulators, dq = hi·k +
    lo·k added at the end."""
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    allow = mask.allow(mask.q_offset + torch.arange(q.shape[1])[:, None],
                       mask.kv_offset + torch.arange(k.shape[1])[None, :])
    p = torch.where(allow, torch.exp(s - lse.transpose(1, 2)[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (of * dof).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * scale
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float()
    dq = (torch.einsum("bhqk,bkhd->bqhd", hi, kf)
          + torch.einsum("bhqk,bkhd->bqhd", lo, kf))
    dk = torch.einsum("bhqk,bqhd->bkhd", hi, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).float(), dof)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def test_bf16_pair_backward_route_passes_row_gate_rejects_missing_tile():
    """The arithmetic of kernels C and D's bf16 pair route (q/k 192, v 128,
    v the strided last 128 columns of a (.., 256) array, causal, 1/√192),
    emulated on the CPU, meets the per-row bar the card holds it to (2e-2)
    against the plain backward and against the reference's
    ``flash_bwd_bhtd`` in interpret mode, by a margin; the bar rejects a
    plain backward that never visits the last 64-key tile."""
    rng = np.random.default_rng(24)
    T, H, scale = 512, 2, 192 ** -0.5
    q = rng.standard_normal((1, T, H, 192)).astype(np.float32)
    k = rng.standard_normal((1, T, H, 192)).astype(np.float32)
    kv = rng.standard_normal((1, T, H, 256)).astype(np.float32)
    do = rng.standard_normal((1, T, H, 128)).astype(np.float32)
    r_mask, t_mask = _spec_pair("causal")
    bf = jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(x, bf) for x in (q, k, kv[..., 128:], do))
    o, lse = r_chunk_attn_ref(jq, jk, jv, mask=r_mask, scale=scale)
    ref = ops.flash_bwd(jq, jk, jv, o, lse, jdo, mask=r_mask, scale=scale,
                        block_q=64, block_kv=64, interpret=True)
    tq, tk, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, do))
    tv = torch.from_numpy(kv).to(torch.bfloat16)[..., 128:]
    assert tv.stride()[2] == 256
    to = torch.from_numpy(np.array(o, np.float32)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse))
    plain = chunk_attn_bwd_ref(tq, tk, tv, to, tlse, tdo, mask=t_mask,
                               scale=scale)
    emu = _pair_route_bwd(tq, tk, tv, to, tlse, tdo, t_mask, scale)
    bq, bk, bv = chunk_attn_bwd_ref(tq, tk[:, :-64], tv[:, :-64], to, tlse,
                                    tdo, mask=t_mask, scale=scale)
    pad = torch.zeros_like(tk[:, -64:, :, :1])
    bad = (bq, torch.cat([bk, pad.expand(-1, -1, -1, 192)], 1),
           torch.cat([bv, pad.expand(-1, -1, -1, 128)], 1))
    for e, b, p, r in zip(emu, bad, plain, ref):
        r = torch.from_numpy(np.asarray(r, np.float32))
        assert e.shape == p.shape == r.shape
        assert row_rel_err(e, p) <= ROW_TOL / 2
        assert row_rel_err(e, r) <= ROW_TOL / 2
        assert row_rel_err(b, p) > 5 * ROW_TOL


def test_bwd_routes_and_row_alignment():
    """Kernels C and D: bf16 goes to the tensor-core library, float32 to
    the CUDA-core one, both built by ``build.py``; the tensor-core route,
    which copies 16-byte pieces, refuses rows that do not start on 16
    bytes."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (BWD_ROUTES,
                                                     _check_aligned)
    assert BWD_ROUTES[torch.bfloat16][0] == "flash_bwd_sm90"
    assert BWD_ROUTES[torch.float32][0] == "flash_bwd"
    assert {lib for lib, _ in BWD_ROUTES.values()} <= set(build.KERNELS)
    t = torch.zeros((1, 64, 2, 72), dtype=torch.bfloat16)
    _check_aligned(q=t[..., :64], k=t[..., 8:72])
    with pytest.raises(ValueError, match="16-byte"):
        _check_aligned(q=t[..., 1:65])
    with pytest.raises(ValueError, match="16-byte"):
        _check_aligned(do=torch.zeros((1, 64, 2, 36),
                                      dtype=torch.bfloat16)[..., :32])


REL_TOL = 3e-2   # chip_smoke.py's element-wise bar for kernel A in bf16


def _rel_err(a, r, floor=1e-3):
    """chip_smoke.py's ``rel_err``: max |a − r| / (|r| + floor · max |r|)."""
    a, r = a.float(), r.float()
    return float(((a - r).abs() / (r.abs() + floor * r.abs().max())).max())


def _tensor_core_fwd(q, k, v, mask, terms, bc=128, scale=None):
    """Kernel A's bf16 routes emulated on the CPU: float32 scores, an online
    softmax over ``bc``-key tiles in log2 units, l summed from float32 p,
    and p fed to o += p·v as ``terms`` bf16 terms (hi = bf16(p), then the
    rounding remainder), with float32 accumulation and a bf16 output.  v's
    head dim may differ from q/k's (the latent route), and each kv head
    serves a GQA group of Hq / Hkv query heads."""
    B, Tq, H, D = q.shape
    g = H // k.shape[2]
    scale2 = (D ** -0.5 if scale is None else scale) * 1.4426950408889634
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
    allow = mask.allow(mask.q_offset + torch.arange(Tq)[:, None],
                       mask.kv_offset + torch.arange(k.shape[1])[None, :])
    m = torch.full((B, H, Tq, 1), NEG_INF)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, v.shape[-1]))
    for k0 in range(0, k.shape[1], bc):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bc]) * scale2
        s = torch.where(allow[:, k0:k0 + bc], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                            torch.exp2(m - m_new))
        p = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(s),
                        torch.exp2(s - m_new))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha
        rest = p
        for _ in range(terms):
            part = rest.to(torch.bfloat16).float()
            acc = acc + torch.einsum("bhqk,bkhd->bhqd", part,
                                     vf[:, k0:k0 + bc])
            rest = rest - part
        m = m_new
    o = acc / torch.where(l == 0, torch.ones_like(l), l)
    return o.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("Tq,Tk,rel,latent", [
    pytest.param(512, 512, 0, False, id="512-512-0"),
    pytest.param(256, 1024, 768, False, id="256-1024-768"),
    pytest.param(256, 1024, 768, True, id="latent-256-1024-768"),
    pytest.param(512, 512, 0, "pair", id="pair-512-512-0")])
def test_bf16_forward_gate_needs_two_p_terms_rejects_missing_tile(Tq, Tk,
                                                                  rel,
                                                                  latent):
    """The element-wise bar kernel A's bf16 outputs are held to on the
    card (3e-2 of each element): a tensor-core forward that rounds p to one
    bf16 term fails it, the two-term split (hi + lo) passes it by a margin,
    and the bar rejects a plain forward that never visits the last 64 keys
    (a tile of the latent route).  Causal, at a training-like shape and at the serving chunk's
    offsets; at the latent route's (16 query heads over one latent kv
    head, q/k 576, v its 512-column view, scale 1/√192, its 64-key tiles);
    and at the pair route's (16 heads of q/k 192 and v 128, as materialised
    MLA's whole-prompt prefill, scale 1/√192, its 64-key tiles)."""
    rng = np.random.default_rng(13)
    if latent == "pair":
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _qkv(rng, 1, Tq, Tk, 16, 16, 192))
        v, scale, bc = v[..., :128].contiguous(), 192 ** -0.5, 64
    elif latent:
        q, k, _ = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _qkv(rng, 1, Tq, Tk, 16, 1, 576))
        v, scale, bc = k[..., :512], 192 ** -0.5, 64
    else:
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _qkv(rng, 1, Tq, Tk, 2, 2, 64))
        scale, bc = None, 128
    m = tmk.causal(rel_offset=rel)
    ref, _ = chunk_attn_ref(q, k, v, mask=m, scale=scale)
    one = _rel_err(_tensor_core_fwd(q, k, v, m, 1, bc, scale), ref)
    two = _rel_err(_tensor_core_fwd(q, k, v, m, 2, bc, scale), ref)
    cut, _ = chunk_attn_ref(q, k[:, :-64], v[:, :-64], mask=m, scale=scale)
    assert one > REL_TOL
    assert two <= REL_TOL / 2
    assert _rel_err(cut, ref) > REL_TOL


def test_fwd_routes_tables_and_row_alignment():
    """Kernel A: bf16 goes to the tensor-core library with 128 × 128 tiles,
    float32 to the CUDA-core one with 64 × 64, both built by ``build.py``;
    the 128-tile table equals the reference's range math at those sizes and
    is cached apart from the 64-tile one kernels C and D read; a bf16 call
    whose rows do not start on 16 bytes raises before any build."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (FWD_ROUTES,
                                                     _device_bounds,
                                                     _flash_fwd_cuda)
    assert FWD_ROUTES[torch.bfloat16][::2] == ("flash_fwd_sm90", 128)
    assert FWD_ROUTES[torch.float32][::2] == ("flash_fwd", 64)
    assert {lib for lib, _, _ in FWD_ROUTES.values()} <= set(build.KERNELS)
    rm, tm = _spec_pair("sliding_window", window=300, rel_offset=700)
    rows = tile_bounds(tm, 300, 1000, br=128, bc=128)
    assert len(rows) == 3
    for i, row in enumerate(rows):
        want = tuple(int(x) for fn in ("kv_block_bounds",
                                       "interior_kv_bounds")
                     for x in getattr(rbs, fn)(i, br=128, bc=128, nk=8,
                                               mask=rm))
        assert row == want, (i, row, want)
    t64, _ = _device_bounds(tm, 300, 1000, True, "cpu")
    t128, _ = _device_bounds(tm, 300, 1000, True, "cpu", 128)
    assert t64.shape == (5, 4) and t128.tolist() == [list(r) for r in rows]
    t = torch.zeros((1, 64, 2, 72), dtype=torch.bfloat16)
    odd = t[..., 1:65]
    with pytest.raises(ValueError, match="16-byte"):
        _flash_fwd_cuda(odd, odd, odd, tm, 0.125, None, None, True)


def test_latent_routes_by_dtype_and_position_head_tiles():
    """Kernel A's latent route: bf16 goes to the tensor-core library, whose
    64-row tiles are (position, head) pairs of one kv head's group (64 // G
    positions × G heads, or 64 heads of one position), float32 to the
    CUDA-core one; both built by ``build.py``.  The bf16 route's table at
    64 // G positions × 64 keys equals the reference's range math at those
    sizes."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (LATENT_OWN_V_KEYS,
                                                     LATENT_ROUTES,
                                                     _device_bounds,
                                                     latent_tile)
    assert LATENT_ROUTES[torch.bfloat16][:2] == (
        "flash_fwd_latent_sm90", "repro_flash_fwd_latent_sm90")
    assert LATENT_ROUTES[torch.float32][:2] == (
        "flash_fwd_latent", "repro_flash_fwd_latent")
    assert {r[0] for r in LATENT_ROUTES.values()} <= set(build.KERNELS)
    rows, keys = LATENT_ROUTES[torch.bfloat16][2:]
    assert (rows, keys, LATENT_OWN_V_KEYS) == (64, 64, 32)
    assert [latent_tile(g) for g in (1, 2, 16, 64, 128, 256)] == [
        (64, 1), (32, 2), (4, 16), (1, 64), (1, 64), (1, 64)]
    for rel, kind, kw in ((768, "causal", {}),
                          (700, "sliding_window", {"window": 300}),
                          (768, "document", {"boundaries": (0, 850, 940)})):
        rm, tm = _spec_pair(kind, rel_offset=rel, **kw)
        br = latent_tile(16)[0]
        got = tile_bounds(tm, 256, 1024, br=br, bc=keys)
        assert len(got) == 64
        for i, row in enumerate(got):
            want = tuple(int(x) for fn in ("kv_block_bounds",
                                           "interior_kv_bounds")
                         for x in getattr(rbs, fn)(i, br=br, bc=keys, nk=16,
                                                   mask=rm))
            assert row == want, (kind, i, row, want)
        t, _ = _device_bounds(tm, 256, 1024, True, "cpu", br, keys)
        assert t.tolist() == [list(r) for r in got]


def test_pair_routes_by_dtype_tables_and_refusals(monkeypatch):
    """Kernel A's pair route (q/k 192, v 128: materialised MLA): bf16 goes
    to its tensor-core library at 128-row q tiles of 64-key tiles, float32
    to the CUDA-core latent library's <192, 128> at 16 × 32; both are built
    by ``build.py`` and counted as ``flash_fwd_pair``.  The 128 × 64 table
    of the fixed-slot prefill (T 4096, causal) and of a chunk under a window
    equals the reference's range math at those sizes.  A bf16 call whose
    rows do not start on 16 bytes and a pair outside ``PAIR_DIMS`` raise
    before any build or launch; the backward plans the pair (kernels C and
    D at 192 / 128, by dtype through ``PAIR_BWD_ROUTES``: bf16 to the
    pair library, float32 to the CUDA-core one) and refuses the
    others."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (LATENT_ROUTES,
                                                     PAIR_BWD_ROUTES,
                                                     PAIR_DIMS, PAIR_ROUTES,
                                                     _BwdPlan,
                                                     _device_bounds,
                                                     _flash_fwd_cuda)
    bf, f32 = torch.bfloat16, torch.float32
    assert PAIR_DIMS == ((192, 128),)
    assert PAIR_ROUTES[bf] == ("flash_fwd_pair_sm90",
                               "repro_flash_fwd_pair_sm90", 128, 64)
    assert PAIR_ROUTES[f32] == LATENT_ROUTES[f32]
    assert {r[0] for r in PAIR_ROUTES.values()} <= set(build.KERNELS)
    assert PAIR_BWD_ROUTES == {bf: ("flash_bwd_pair_sm90", "_pair_sm90"),
                               f32: ("flash_bwd", "")}
    assert {r[0] for r in PAIR_BWD_ROUTES.values()} <= set(build.KERNELS)
    assert "flash_fwd_pair" in build.LAUNCHES
    for T, Tk, kind, kw in ((4096, 4096, "causal", {}),
                            (256, 1024, "sliding_window",
                             {"window": 300, "rel_offset": 768})):
        rm, tm = _spec_pair(kind, **kw)
        got = tile_bounds(tm, T, Tk, br=128, bc=64)
        assert len(got) == -(-T // 128)
        for i, row in enumerate(got):
            want = tuple(int(x) for fn in ("kv_block_bounds",
                                           "interior_kv_bounds")
                         for x in getattr(rbs, fn)(i, br=128, bc=64,
                                                   nk=-(-Tk // 64), mask=rm))
            assert row == want, (kind, i, row, want)
        t, _ = _device_bounds(tm, T, Tk, True, "cpu", 128, 64)
        assert t.tolist() == [list(r) for r in got]

    def no_build(*a, **kw):
        raise AssertionError("a refused call reached the build")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    n0 = dict(build.LAUNCHES)
    k = torch.zeros((1, 8, 4, 192), dtype=bf)
    q = torch.zeros((1, 8, 4, 200), dtype=bf)[..., 1:193]
    with pytest.raises(ValueError, match="16-byte"):
        _flash_fwd_cuda(q, k, k[..., :128], tmk.causal(), 0.07, None, None,
                        True)
    for dt in (bf, f32):
        q = torch.zeros((1, 8, 4, 192), dtype=dt)
        for dv in (64, 192 + 64):
            with pytest.raises(ValueError, match="head dims"):
                _flash_fwd_cuda(q, q, torch.zeros((1, 8, 4, dv), dtype=dt),
                                tmk.causal(), 0.07, None, None, True)
        v = torch.zeros((1, 8, 4, 128), dtype=dt)
        pl = _BwdPlan(q, q, v, v, torch.zeros((1, 8, 4)), v, tmk.causal(),
                      None, None, None, True)
        assert (pl.lib, pl.suffix) == PAIR_BWD_ROUTES[dt]
        for dv in (64, 192 + 64):
            w = torch.zeros((1, 8, 4, dv), dtype=dt)
            with pytest.raises(ValueError, match="head dims"):
                _BwdPlan(q, q, w, w, torch.zeros((1, 8, 4)), w,
                         tmk.causal(), None, None, None, True)
    assert dict(build.LAUNCHES) == n0


# materialised MLA's backward: (mask kind, kwargs, Tq, Tk, dtype); v is the
# last 128 columns of a (.., 256) array, as ``layers.mla_qkv`` hands it over
PAIR_BWD_CASES = [
    ("causal", {}, 128, 128, "float32"),
    ("causal", {"rel_offset": 64}, 64, 128, "float32"),
    ("sliding_window", {"window": 40}, 96, 96, "float32"),
    ("causal", {}, 128, 128, "bfloat16"),
]


@pytest.mark.parametrize("case", PAIR_BWD_CASES,
                         ids=[f"{c[0]}{c[2]}x{c[3]}{c[4]}"
                              for c in PAIR_BWD_CASES])
def test_pair_bwd_plain_matches_reference_kernel(case):
    """The plain version of kernels C and D at q/k 192, v 128 (v a strided
    view), through ``flash_bwd`` on CPU tensors, against the reference's
    ``flash_bwd_bhtd`` in interpret mode at 1/√192, the chunk backward's
    bars (2e-4 float32, 5e-2 bf16); dk and dv keep the shapes of k and
    v."""
    kind, kw, Tq, Tk, dt = case
    rng = np.random.default_rng(23)
    H, scale = 4, 192 ** -0.5
    q = rng.standard_normal((1, Tq, H, 192)).astype(np.float32)
    k = rng.standard_normal((1, Tk, H, 192)).astype(np.float32)
    kv = rng.standard_normal((1, Tk, H, 256)).astype(np.float32)
    v = kv[..., 128:]
    do = rng.standard_normal((1, Tq, H, 128)).astype(np.float32)
    r_mask, t_mask = _spec_pair(kind, **kw)
    jd, td = jnp.dtype(dt), getattr(torch, dt)
    jq, jk, jv, jdo = (jnp.asarray(x, jd) for x in (q, k, v, do))
    o, lse = r_chunk_attn_ref(jq, jk, jv, mask=r_mask, scale=scale)
    ref = ops.flash_bwd(jq, jk, jv, o, lse, jdo, mask=r_mask, scale=scale,
                        block_q=64, block_kv=64, interpret=True)
    tq, tk, tdo = (torch.from_numpy(x).to(td) for x in (q, k, do))
    tv = torch.from_numpy(kv).to(td)[..., 128:]
    assert tv.stride()[2] == 256
    to = torch.from_numpy(np.array(o, np.float32)).to(td)
    got = flash_bwd(tq, tk, tv, to, torch.from_numpy(np.array(lse)), tdo,
                    mask=t_mask, scale=scale)
    tol = 2e-4 if dt == "float32" else 5e-2
    for a, r, shape in zip(got, ref, (q.shape, k.shape, v.shape)):
        assert a.dtype == td and tuple(a.shape) == shape
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r, np.float32), atol=tol,
                                   rtol=tol)


def test_backward_refuses_other_pairs_before_any_build(monkeypatch):
    """Kernels C and D take one head dim or the pair (192, 128); any other
    (Dk, Dv), the latent pair (576, 512: absorbed MLA is never trained)
    included, and o / do not of v's head dim raise before a build, in both
    dtypes.  The default scale is 1/√Dk."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _BwdPlan

    def no_build(*a, **kw):
        raise AssertionError("a refused call reached the build")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    for dt in (torch.bfloat16, torch.float32):
        for dk, dv in ((192, 64), (160, 128), (128, 192), (576, 512)):
            q = torch.zeros((1, 8, 4, dk), dtype=dt)
            v = torch.zeros((1, 8, 4, dv), dtype=dt)
            with pytest.raises(ValueError, match="head dims"):
                _BwdPlan(q, q, v, v, torch.zeros((1, 8, 4)), v,
                         tmk.causal(), None, None, None, True)
        q = torch.zeros((1, 8, 4, 192), dtype=dt)
        v = torch.zeros((1, 8, 4, 128), dtype=dt)
        with pytest.raises(ValueError, match="do shape"):
            _BwdPlan(q, q, v, v, torch.zeros((1, 8, 4)), q, tmk.causal(),
                     None, None, None, True)
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.standard_normal((1, 16, 2, 192)).astype(
        np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.standard_normal((1, 16, 2, 128)).astype(
        np.float32)) for _ in range(2))
    o, lse = chunk_attn_ref(q, k, v, mask=tmk.causal())
    for a, b in zip(flash_bwd(q, k, v, o, lse, do, mask=tmk.causal()),
                    chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=tmk.causal(),
                                       scale=192 ** -0.5)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("why", ["group48", "group5", "unaligned"])
def test_latent_bf16_route_refuses_before_any_build(why, monkeypatch):
    """A bf16 latent call the tensor-core route cannot take (a GQA group
    that neither divides 64 nor is a multiple of it; rows that do not start
    on 16 bytes) raises before any build or launch; it is never handed to
    the CUDA-core route or the plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _flash_fwd_cuda

    def no_build(*a, **kw):
        raise AssertionError("a refused call reached the build")
    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    bf = torch.bfloat16
    hq = {"group48": 48, "group5": 5, "unaligned": 16}[why]
    q = torch.zeros((1, 8, hq, 576), dtype=bf)
    k = torch.zeros((1, 8, 1, 576), dtype=bf)
    if why == "unaligned":
        q = torch.zeros((1, 8, hq, 584), dtype=bf)[..., 1:577]
    n0 = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="GQA group" if why != "unaligned"
                       else "16-byte"):
        _flash_fwd_cuda(q, k, k[..., :512], tmk.causal(), 192 ** -0.5, None,
                        None, True)
    assert dict(build.LAUNCHES) == n0


# ----------------------------------------------------------------- paged

def _paged_inputs(seed, B, Tq, Hq, Hkv, D, bs, nb, N, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D)).astype(np.float32)
    # fragmented, out-of-order tables; entries past each length are null
    perm = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb)
    lens = np.asarray(lengths, np.int32)
    for b in range(B):
        perm[b, -(-int(lens[b]) // bs):] = 0
    return q, kp, vp, perm.astype(np.int32), lens


PAGED_CASES = [
    # (B, Tq, Hq, Hkv, D, bs, nb, lengths, window)
    (4, 1, 4, 4, 32, 8, 6, [1, 9, 17, 48], 0),
    (4, 1, 4, 2, 64, 16, 4, [3, 16, 33, 64], 0),
    (3, 3, 4, 1, 32, 8, 5, [3, 20, 40], 0),
    (4, 1, 4, 2, 32, 8, 6, [5, 13, 31, 47], 13),
    (2, 4, 4, 2, 32, 16, 4, [4, 50], 20),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_attn_matches_reference_kernel(case):
    B, Tq, Hq, Hkv, D, bs, nb, lengths, window = case
    q, kp, vp, bt, lens = _paged_inputs(7, B, Tq, Hq, Hkv, D, bs, nb,
                                        B * nb + 3, lengths)
    rmask = rmk.sliding_window(window) if window else rmk.causal()
    tmask = tmk.sliding_window(window) if window else tmk.causal()
    o_r = paged_attn_pallas(*(jnp.asarray(x) for x in (q, kp, vp, bt, lens)),
                            mask=rmask, interpret=True)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, lens)]
    o_t = paged_attn(*args, mask=tmask)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_r), atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    np.testing.assert_array_equal(
        paged_attn_ref(*args, mask=tmask).numpy(), o_t.numpy())


def test_paged_attn_rows_with_nothing_attendable_are_zero():
    """Tq = 3 with length 2: row 0 sits at position -1 and sees nothing."""
    q, kp, vp, bt, lens = _paged_inputs(8, 1, 3, 2, 2, 32, 8, 2, 6, [2])
    o = paged_attn(*(torch.from_numpy(x) for x in (q, kp, vp, bt, lens)))
    assert float(o[0, 0].abs().max()) == 0.0
    assert float(o[0, 1:].abs().min()) > 0.0


def test_paged_rejects_unsupported_masks():
    args = [torch.from_numpy(x) for x in
            _paged_inputs(9, 1, 1, 2, 2, 32, 8, 2, 6, [5])]
    with pytest.raises(ValueError, match="causal/sliding_window"):
        paged_attn(*args, mask=tmk.prefix_lm(3))
    with pytest.raises(ValueError, match="offset-free"):
        paged_attn(*args, mask=tmk.causal(rel_offset=2))


def test_split_plan_depends_on_pages_dim_and_dtype_only():
    """The kernel's split length is a whole number of pages near its target
    (256 tokens for bf16 D = 128), and S covers the table's width."""
    bf, f32 = torch.bfloat16, torch.float32
    assert split_plan(66, 16, 128, bf) == (256, 5)
    assert split_plan(2050, 16, 128, bf) == (256, 129)
    assert split_plan(16, 16, 128, bf) == (256, 1)
    assert split_plan(17, 16, 128, bf) == (256, 2)
    assert split_plan(3, 24, 128, bf) == (264, 1)     # 11 pages of 24
    assert split_plan(10, 64, 32, f32) == (512, 2)
    assert split_plan(1, 8, 128, f32) == (128, 1)
    for bs in range(8, 65):
        for D in (32, 64, 128):
            for dt in (bf, f32):
                Ls, S = split_plan(40, bs, D, dt)
                assert Ls % bs == 0 and Ls >= 128
                assert (S - 1) * Ls < 40 * bs <= S * Ls
                # the boundaries do not move with the table's width
                assert split_plan(400, bs, D, dt)[0] == Ls


SPLIT_CASES = [
    # (B, Tq, Hq, Hkv, D, bs, nb, lengths, window, split_tokens):
    # lengths at the split edges L_s - 1, L_s, L_s + 1, 2 L_s
    (4, 1, 4, 2, 32, 8, 6, [15, 16, 17, 32], 0, 16),
    (4, 2, 4, 4, 64, 8, 9, [23, 24, 25, 48], 0, 24),
    # windows across a split boundary
    (3, 1, 4, 2, 32, 8, 8, [21, 40, 57], 10, 16),
    (2, 3, 4, 1, 32, 16, 4, [37, 60], 20, 32),
    # Tq > 1 and GQA, rows with nothing attendable in some splits: with
    # window 2 the first rows see only the earlier split, the last only the
    # later one; length 2 at Tq 4 leaves rows with nothing at all
    (3, 4, 4, 2, 32, 8, 6, [18, 34, 2], 2, 16),
    (2, 4, 8, 2, 64, 8, 7, [17, 50], 0, 16),
    # the kernel's own plan: L_s 512 at float32 D = 32, bs 64
    (2, 2, 4, 2, 32, 64, 10, [511, 513], 0, None),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_split_and_merge_matches_reference_kernel(case):
    B, Tq, Hq, Hkv, D, bs, nb, lengths, window, split = case
    q, kp, vp, bt, lens = _paged_inputs(11, B, Tq, Hq, Hkv, D, bs, nb,
                                        B * nb + 3, lengths)
    rmask = rmk.sliding_window(window) if window else rmk.causal()
    tmask = tmk.sliding_window(window) if window else tmk.causal()
    o_r = paged_attn_pallas(*(jnp.asarray(x) for x in (q, kp, vp, bt, lens)),
                            mask=rmask, interpret=True)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, lens)]
    o_s = paged_attn_split_ref(*args, mask=tmask, split_tokens=split)
    np.testing.assert_allclose(o_s.numpy(), np.asarray(o_r), atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    np.testing.assert_allclose(o_s.numpy(),
                               paged_attn_ref(*args, mask=tmask).numpy(),
                               atol=PAGED_TOL, rtol=PAGED_TOL)


def test_paged_split_result_bits_do_not_depend_on_batch_or_width():
    """A request's split boundaries, and so its result bits, are the same
    alone, in a batch with a wider table, and under a permuted block
    table."""
    B, Tq, Hq, Hkv, D, bs = 4, 2, 4, 2, 32, 8
    q, kp, vp, bt, lens = _paged_inputs(14, B, Tq, Hq, Hkv, D, bs, 9,
                                        B * 9 + 5, [40, 70, 9, 33])
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, lens)]
    m = tmk.sliding_window(30)
    full = paged_attn_split_ref(*args, mask=m, split_tokens=16)
    b = 1
    alone_bt = args[3][b:b + 1, :-(-70 // bs)].contiguous()   # narrowest
    alone = paged_attn_split_ref(args[0][b:b + 1], args[1], args[2],
                                 alone_bt, args[4][b:b + 1], mask=m,
                                 split_tokens=16)
    assert torch.equal(alone[0], full[b])
    # the same pages moved to other block ids
    N = kp.shape[0]
    perm = np.concatenate([[0], np.random.default_rng(3).permutation(
        np.arange(1, N))])
    kp2, vp2 = np.empty_like(kp), np.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    moved = paged_attn_split_ref(
        args[0], torch.from_numpy(kp2), torch.from_numpy(vp2),
        torch.from_numpy(perm[bt].astype(np.int32)), args[4], mask=m,
        split_tokens=16)
    assert torch.equal(moved, full)


def test_registry_defaults_to_cuda_and_runs_plain_on_cpu():
    """``cuda`` is the default backend; on CPU tensors its wrappers give the
    plain versions' results, and an unknown name raises.  ``null`` (the
    dry-run's stub) is reached only by name and is not exact."""
    from repro_torch.kernels import registry
    assert registry.names() == ("cuda", "null", "ref")
    assert not registry.get("null").exact and registry.resolve(None).exact
    assert registry.resolve(None).name == "cuda"
    assert registry.resolve("ref").fwd is chunk_attn_ref
    assert registry.resolve("ref").bwd is chunk_attn_bwd_ref
    assert registry.resolve(None).bwd is flash_bwd
    with pytest.raises(ValueError, match="unknown"):
        registry.resolve("pallas")
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(5), 1, 64, 64, 2, 2, 32))
    m = tmk.causal()
    o_c, l_c = chunk_attn(q, k, v, mask=m)
    o_r, l_r = chunk_attn(q, k, v, mask=m, impl="ref")
    assert torch.equal(o_c, o_r) and torch.equal(l_c, l_r)
