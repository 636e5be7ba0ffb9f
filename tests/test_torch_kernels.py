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
from repro_torch.kernels.paged import paged_attn, paged_attn_ref
from repro_torch.kernels.ref import NEG_INF, chunk_attn_bwd_ref, chunk_attn_ref

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


def test_registry_defaults_to_cuda_and_runs_plain_on_cpu():
    """``cuda`` is the default backend; on CPU tensors its wrappers give the
    plain versions' results, and an unknown name raises."""
    from repro_torch.kernels import registry
    assert registry.names() == ("cuda", "ref")
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
