"""DeepSeek-V2-Lite (MLA + MoE) in the port against the JAX reference, on
the CPU.

The smoke config of ``deepseek-v2-lite-16b`` (2 layers — one dense, one
MoE of 4 routed + 1 shared experts, top 2 — 4 heads, MLA latent 32 + rope
16, float32); the reference on an Auto-axis (1, 1) mesh with ``impl="ref"``
and its weights carried into the port.  The serving path is MLA absorbed
over a latent pool (``ckv_pool``) and MoE dispatched per chunk.

Bars: ``mla_qkv`` 1e-5 (the chunk forward's, ``tests/test_kernels.py``);
``moe_apply`` / ``moe_decode_apply`` 2e-5 (``tests/test_moe.py``); logits
and written pools 1e-4 (float32 summation order, as
``tests/test_torch_serve.py``); engine streams equal; checkpoints
byte-identical.  At smoke size the capacity factor is 4.0 and nothing is
dropped, so ``moe_apply`` is also held at 0.5, where the capacity order
decides which (token, choice) pairs drop, and that case is shown to
reject a dispatch that fills capacity in reverse token order.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import mask as rmk
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.io import checkpoint as rck
from repro.kernels.flash_attention import flash_fwd_bhtd
from repro.kernels.paged import paged_attn_pallas
from repro.models import layers as RL
from repro.models import moe as RM
from repro.serve import faults as rfaults
from repro.serve.engine import Engine as REngine
from repro.serve.speculative import SpecConfig as RSpecConfig
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core import mask as mk
from repro_torch.io import checkpoint as ckpt
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged as pg
from repro_torch.kernels.ref import chunk_attn_ref
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.transformer import DecoderLM, to_reference_params
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.engine import Engine, FixedSlotEngine
from repro_torch.serve.faults import FaultEvent, FaultInjector
from repro_torch.serve.speculative import SpecConfig

from _torch_serve_cases import assert_same_run, drive, pair, prompts

ARCH = "deepseek-v2-lite-16b"
QKV_TOL = 1e-5
MOE_TOL = 2e-5
LOGIT_TOL = 1e-4
O_TOL, LSE_TOL, PAGED_TOL = 1e-5, 1e-4, 2e-5
DK, DV = 576, 512        # the latent shape of kernels A and B


@pytest.fixture(scope="module")
def ds():
    return pair(ARCH)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


# ------------------------------------------------------------ configs

def test_config_and_param_counts_match_reference():
    """The config field for field, both parameter counts (the reference's
    15,496,642,560 and 2,451,308,544), and ``smoke_config``'s MLA and MoE
    reductions."""
    t, r = get_config(ARCH), r_get_config(ARCH)
    for f in dataclasses.fields(t):
        if f.name not in ("attn", "moe"):
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    for sub in ("attn", "moe"):
        for f in dataclasses.fields(getattr(t, sub)):
            assert getattr(getattr(t, sub), f.name) == \
                getattr(getattr(r, sub), f.name), (sub, f.name)
    assert t.attn.is_mla and t.attn.qk_nope_head_dim == 128
    assert t.param_count() == r.param_count() == 15_496_642_560
    assert t.active_param_count() == r.active_param_count() == 2_451_308_544
    s, rs = smoke_config(t), r_smoke_config(r)
    for sub in ("attn", "moe"):
        for f in dataclasses.fields(getattr(s, sub)):
            assert getattr(getattr(s, sub), f.name) == \
                getattr(getattr(rs, sub), f.name), (sub, f.name)
    for name in ("n_layers", "d_model", "d_ff", "vocab", "dtype"):
        assert getattr(s, name) == getattr(rs, name), name
    assert s.param_count() == rs.param_count()
    assert s.active_param_count() == rs.active_param_count()


def test_init_tree_matches_reference(ds):
    """``DecoderLM.init``: the reference's keys and shapes
    (``dense_layers`` / ``moe_layers``), a float32 router in a bf16 model,
    unit norms."""
    r_flat = rck._flatten(ds.r_model.init(jax.random.PRNGKey(0)))[0]
    cfg = ds.t_model.cfg
    for dt in ("float32", "bfloat16"):
        p = DecoderLM(cfg.replace(dtype=dt), device="cpu").init(0)
        flat = ckpt.flatten(to_reference_params(p))
        assert list(flat) == list(r_flat)
        for k, v in flat.items():
            assert tuple(v.shape) == tuple(r_flat[k].shape), k
            want = torch.float32 if k.endswith("router") else \
                {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
            assert v.dtype == want, k
        assert bool((p["moe_layers"][0]["attn"]["kv_ln"] == 1).all())


# ------------------------------------------------------------- MLA

def _rope(cfg, pos):
    a = cfg.attn
    c, s = L.rope_tables(torch.from_numpy(pos.reshape(-1)),
                         a.qk_rope_head_dim, a.rope_theta)
    rc, rs = RL.rope_tables(jnp.asarray(pos.reshape(-1)),
                            a.qk_rope_head_dim, a.rope_theta)
    B, T = pos.shape
    return (c.reshape(B, T, -1), s.reshape(B, T, -1), rc.reshape(B, T, -1),
            rs.reshape(B, T, -1))


def test_mla_qkv_matches_reference(ds):
    """The materialised MLA projections of the MoE layer at T 16 with
    per-request rope tables: q, k, v within 1e-5."""
    cfg = ds.t_model.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(16), 9 + np.arange(16)])
    tc, ts, rc, rs = _rope(cfg, pos)
    rp = jax.tree.map(lambda t: jnp.asarray(t[0]),
                      ds.r_params["moe_layers"]["attn"])
    want = RL.mla_qkv(rp, jnp.asarray(x), ds.r_model.cfg, rc, rs)
    got = L.mla_qkv(ds.t_params["moe_layers"][0]["attn"],
                    torch.from_numpy(x), cfg, tc, ts)
    assert [tuple(g.shape) for g in got] == [(2, 16, 4, 48)] * 2 + \
        [(2, 16, 4, 32)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=QKV_TOL,
                                   rtol=QKV_TOL)
    assert L.mla_scale(cfg) == RL.mla_scale(ds.r_model.cfg) \
        == 1.0 / np.sqrt(48)


def test_absorbed_equals_materialised_attention(ds):
    """Inside the port: latent-space attention over the latent rows (one kv
    head, v their first kv_lora columns, ``_mla_parts`` / ``_mla_out``)
    gives the materialised layer's output (``mla_qkv``, per-head k/v)
    within 1e-5, causal over T 24."""
    model, cfg = ds.t_model, ds.t_model.cfg
    c = cfg.attn.kv_lora_rank
    lp = ds.t_params["dense_layers"][0]
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.standard_normal((1, 24, cfg.d_model))
                         .astype(np.float32))
    tc, ts, _, _ = _rope(cfg, np.arange(24)[None])
    tc, ts = tc[0], ts[0]
    spec, sc = mk.causal(), L.mla_scale(cfg)
    q, k, v = L.mla_qkv(lp["attn"], h, cfg, tc, ts)
    mat = L.attn_out(lp["attn"], h, chunk_attn_ref(q, k, v, mask=spec,
                                                   scale=sc)[0], cfg)
    q_full, new, w_uv = model._mla_parts(lp, h, tc, ts)
    g = new[:, :, None]
    o_lat = chunk_attn_ref(q_full, g, g[..., :c], mask=spec, scale=sc)[0]
    ab = model._mla_out(lp, h, o_lat, w_uv)
    np.testing.assert_allclose(ab.numpy(), mat.numpy(), atol=QKV_TOL,
                               rtol=QKV_TOL)
    assert float((ab - h).abs().max()) > 100 * QKV_TOL


# ------------------------------------------- kernels at the latent shape

def test_latent_chunk_plain_matches_reference_kernel():
    """Kernel A's plain version at q/k 576, v 512 (v the first 512 columns
    of k, one kv head under 16 query heads, causal at q offset 40, scale
    1/√192) against the reference's ``flash_fwd_bhtd`` in interpret mode:
    o within 1e-5, lse within 1e-4; the wrapper runs it for CPU
    tensors."""
    rng = np.random.default_rng(11)
    Tq, Tk, H, off = 24, 64, 16, 40
    q = rng.standard_normal((1, Tq, H, DK)).astype(np.float32)
    k = rng.standard_normal((1, Tk, 1, DK)).astype(np.float32)
    sc = 1.0 / np.sqrt(192)
    o_r, lse_r = flash_fwd_bhtd(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(k[..., :DV].transpose(0, 2, 1, 3)), scale=sc,
        mask=rmk.causal(rel_offset=off), interpret=True)
    kt = torch.from_numpy(k)
    o, lse = fa.flash_fwd(torch.from_numpy(q), kt, kt[..., :DV],
                          mask=mk.causal(rel_offset=off), scale=sc)
    assert tuple(o.shape) == (1, Tq, H, DV)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r).transpose(
        0, 2, 1, 3), atol=O_TOL, rtol=O_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r).transpose(
        0, 2, 1), atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("Tq", [1, 5])
def test_latent_paged_plain_versions_match_reference_kernel(Tq):
    """Kernel B's plain versions over a latent pool (N, 16, 1, 576) whose
    value pool is its 512-column view, 16 heads, Tq 1 and 5 (verify):
    ``paged_attn_ref`` and the split-and-merge ``paged_attn_split_ref`` at
    the kernel's own plan (32-token splits) equal the reference's Pallas
    kernel in interpret mode within 2e-5."""
    rng = np.random.default_rng(12)
    B, H, bs, nb, N = 3, 16, 16, 5, 20
    lens = np.array([70, 33, 5], np.int32)
    q = rng.standard_normal((B, Tq, H, DK)).astype(np.float32)
    pool = rng.standard_normal((N, bs, 1, DK)).astype(np.float32)
    bt = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb)
    for b in range(B):
        bt[b, -(-int(lens[b]) // bs):] = 0
    bt = bt.astype(np.int32)
    sc = 1.0 / np.sqrt(192)
    o_r = paged_attn_pallas(jnp.asarray(q), jnp.asarray(pool),
                            jnp.asarray(pool[..., :DV]), jnp.asarray(bt),
                            jnp.asarray(lens), mask=rmk.causal(), scale=sc,
                            interpret=True)
    kp = torch.from_numpy(pool)
    args = (torch.from_numpy(q), kp, kp[..., :DV], torch.from_numpy(bt),
            torch.from_numpy(lens))
    assert pg.split_plan(nb, bs, DK, torch.float32) == (32, 3)
    for o in (pg.paged_attn(*args, scale=sc),
              pg.paged_attn_split_ref(*args, scale=sc)):
        assert tuple(o.shape) == (B, Tq, H, DV)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_r),
                                   atol=PAGED_TOL, rtol=PAGED_TOL)


def test_latent_routes_take_only_their_head_dims():
    """Kernel A's latent routes (one by dtype) are built by ``build.py``,
    and the float32 one plans 16 × 32 tiles; of pairs its check takes
    (576, 512) and the pair route's (192, 128) only, and the backward none;
    kernel B's takes (576, 512) beside the one-D dims.  Every refusal raises
    before a build."""
    lib, _, br, bc = fa.LATENT_ROUTES[torch.float32]
    assert lib in build.KERNELS and (br, bc) == (16, 32)
    assert fa.LATENT_ROUTES[torch.bfloat16][0] in build.KERNELS
    assert "flash_fwd_latent" in build.LAUNCHES
    t, _ = fa._device_bounds(mk.causal(rel_offset=768), 256, 1024, True,
                             "cpu", br, bc)
    assert tuple(t.shape) == (16, 4) and t[0, 1] == 24 and t[-1, 1] == 31
    q = torch.zeros((1, 32, 16, DK))
    k = torch.zeros((1, 32, 1, DK))
    fa._check(q, k, k[..., :DV], latent=True)
    for v, latent in ((k[..., :256], True), (k[..., :DV], False)):
        with pytest.raises(ValueError, match="head dims"):
            fa._check(q, k, v, latent=latent)
    kp = torch.zeros((8, 16, 1, DK))
    args = (torch.zeros((2, 1, 16, DK)), kp, kp[..., :DV],
            torch.zeros((2, 4), dtype=torch.int32),
            torch.ones((2,), dtype=torch.int32))
    pg._check_cuda(*args, mk.causal())
    with pytest.raises(ValueError, match="head dims"):
        pg._check_cuda(*args[:2], kp[..., :256], *args[3:], mk.causal())


# ------------------------------------------------------------- MoE

def _moe_case(ds, cf, seed=5, n=(2, 16)):
    cfg = ds.t_model.cfg
    t_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=cf))
    r_cfg = ds.r_model.cfg.replace(moe=dataclasses.replace(
        ds.r_model.cfg.moe, capacity_factor=cf))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n + (cfg.d_model,)).astype(np.float32)
    rp = jax.tree.map(lambda t: jnp.asarray(t[0]),
                      ds.r_params["moe_layers"]["moe"])
    return t_cfg, r_cfg, x, rp, ds.t_params["moe_layers"][0]["moe"]


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_apply_matches_reference(ds, cf):
    """The capacity dispatch, output and aux loss within 2e-5, at the
    smoke capacity 4.0 (nothing dropped) and at 0.5 (pairs dropped: the
    token-major capacity order decides which).  At 0.5 a dispatch that
    fills each expert in reverse token order misses by far more."""
    t_cfg, r_cfg, x, rp, tp = _moe_case(ds, cf)
    y_r, aux_r = RM.moe_apply(rp, jnp.asarray(x), r_cfg, mesh=_mesh())
    xt = torch.from_numpy(x)
    y, aux = M.moe_apply(tp, xt, t_cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(aux_r), atol=MOE_TOL,
                               rtol=MOE_TOL)
    n, K, E = 32, t_cfg.moe.top_k, t_cfg.moe.n_routed
    cap = M.capacity(t_cfg, n)
    dropped = n * K > E * cap
    assert dropped == (cf < 1)
    # reversed capacity order: the rows in reverse, dispatched, restored
    rev = M.moe_apply(tp, xt.reshape(1, n, -1).flip(1), t_cfg)[0]
    rev = rev.flip(1).reshape(x.shape)
    err = float(np.abs(rev.numpy() - np.asarray(y_r)).max())
    if dropped:
        assert err > 100 * MOE_TOL, err
    else:
        assert err < MOE_TOL, err


def test_moe_padding_rows_take_capacity(ds):
    """The padded rows of a bucketed chunk route and take capacity as the
    reference's do: a 24-row chunk whose last 10 rows are padding, at
    capacity 0.5, matches the reference on every row."""
    t_cfg, r_cfg, x, rp, tp = _moe_case(ds, 0.5, seed=6, n=(1, 24))
    x[:, 14:] = 0.0
    y_r, _ = RM.moe_apply(rp, jnp.asarray(x), r_cfg, mesh=_mesh())
    y, _ = M.moe_apply(tp, torch.from_numpy(x), t_cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=MOE_TOL,
                               rtol=MOE_TOL)


def test_moe_decode_apply_matches_reference(ds):
    """Every expert on every row, float32 combine: within 2e-5."""
    t_cfg, r_cfg, x, rp, tp = _moe_case(ds, 1.25, seed=7, n=(4, 5))
    y_r = RM.moe_decode_apply(rp, jnp.asarray(x), r_cfg, mesh=_mesh())
    y = M.moe_decode_apply(tp, torch.from_numpy(x), t_cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=MOE_TOL,
                               rtol=MOE_TOL)


def test_top_k_breaks_ties_like_lax():
    """Equal probabilities keep the lower expert index first, as
    ``lax.top_k`` does (``torch.topk`` promises no order)."""
    rng = np.random.default_rng(8)
    p = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    v_r, i_r = jax.lax.top_k(jnp.asarray(p), 6)
    v, i = M.top_k(torch.from_numpy(p), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_r))


# ------------------------------------------------- chunk, decode, verify

def _pool(cfg, N=24, bs=8, seed=1):
    a = cfg.attn
    rng = np.random.default_rng(seed)
    return rng.standard_normal((cfg.n_layers, N, bs, a.kv_lora_rank
                                + a.qk_rope_head_dim)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_prefill_chunk_decode_verify_match_reference(ds):
    """Over a latent pool that already holds context: a padded prefill
    chunk (start 13, 6 of 8 rows valid) writes the reference's latent rows;
    then a decode step (3 requests, one idle) and a verify at T 4 (n_write
    4, 2, 0) give its logits and pools within 1e-4."""
    cfg, model = ds.t_model.cfg, ds.t_model
    pool = _pool(cfg)
    t_pool = torch.from_numpy(pool.copy())
    r_cache = {"ckv_pool": jnp.asarray(pool)}
    # prefill chunk through table row [3, 7, 1, 5]
    bt1 = np.array([[3, 7, 1, 5]], np.int32)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 8)) \
        .astype(np.int32)
    r_cache = ds.r_model.prefill_chunk(
        ds.r_params, {**r_cache, "block_table": jnp.asarray(bt1)},
        {"tokens": jnp.asarray(toks), "start": 13, "n_valid": 6})
    model.prefill_chunk(ds.t_params, {"ckv_pool": t_pool,
                                      "block_table": torch.from_numpy(bt1)},
                        torch.from_numpy(toks), 13, 6)
    _close(t_pool[:, 1:].numpy(), r_cache["ckv_pool"][:, 1:])
    # decode
    table = np.array([[3, 7, 1, 5, 0, 0], [2, 9, 11, 4, 6, 0],
                      [0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.array([19, 35, 0], np.int32)
    tok = np.array([[5], [77], [0]], np.int32)
    r_logits, r_cache = ds.r_model.decode(
        ds.r_params, {"ckv_pool": r_cache["ckv_pool"],
                      "block_table": jnp.asarray(table)},
        {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
    view = {"ckv_pool": t_pool, "block_table": torch.from_numpy(table)}
    logits = model.decode(ds.t_params, view, torch.from_numpy(tok),
                          torch.from_numpy(pos))
    _close(logits[:2].numpy(), np.asarray(r_logits)[:2])
    _close(t_pool[:, 1:].numpy(), r_cache["ckv_pool"][:, 1:])
    # verify
    pos = pos + np.array([1, 1, 0], np.int32)
    n_write = np.array([4, 2, 0], np.int32)
    vt = np.random.default_rng(3).integers(0, cfg.vocab, (3, 4)) \
        .astype(np.int32)
    r_logits, r_cache = ds.r_model.verify(
        ds.r_params, {"ckv_pool": r_cache["ckv_pool"],
                      "block_table": jnp.asarray(table)},
        {"tokens": jnp.asarray(vt), "pos": jnp.asarray(pos),
         "n_write": jnp.asarray(n_write)})
    logits = model.verify(ds.t_params, view, torch.from_numpy(vt),
                          torch.from_numpy(pos), torch.from_numpy(n_write))
    _close(logits[:2].numpy(), np.asarray(r_logits)[:2])
    _close(t_pool[:, 1:].numpy(), r_cache["ckv_pool"][:, 1:])


def test_served_logits_equal_materialised_forward(ds):
    """The absorbed paged path's last decode logits equal a whole-context
    forward with MLA materialised (at capacity 4.0 nothing drops either
    way) within 1e-4: the engine end to end against the independent
    form."""
    model, params = ds.t_model, ds.t_params
    seen = []
    decode = model.decode

    def recording(*a, **k):
        out = decode(*a, **k)
        seen.append(out)
        return out
    model.decode = recording
    try:
        toks = np.stack(prompts(ds.vocab, [29], seed=9))
        out = Engine(model, params, max_batch=2, block_size=8, n_blocks=16,
                     prefill_chunk_tokens=8).generate({"tokens": toks}, 3)
    finally:
        del model.decode
    ctx = np.concatenate([toks[0], out[0][:2]])[None]
    ref = model.forward(params, torch.from_numpy(ctx), last_only=True)
    _close(seen[-1][0, -1].numpy(), ref[0, -1].numpy())


# ------------------------------------------------------------- engine

ENGINE = dict(max_batch=3, block_size=8, n_blocks=40)


def _subs(vocab, temps=(0.0, 0.0, 0.0, 0.0)):
    p = prompts(vocab, [12, 21, 9, 30], seed=10)
    p[0] = np.concatenate([p[0], p[0]])           # n-gram drafts hit
    p[3][:16] = p[1][:16]                         # a prefix-cache hit
    return [dict(prompt=x, max_new_tokens=n, temperature=t, seed=i)
            for i, (x, n, t) in enumerate(zip(p, (12, 6, 8, 7), temps))]


@pytest.mark.parametrize("chunk", [0, 16])
def test_engine_streams_match_reference(ds, chunk):
    """Staggered greedy submissions, whole-prompt (0) or 16-token chunks,
    with a request that shares another's first 16 tokens (a prefix-cache
    hit): streams, states and counters equal the reference's."""
    subs = _subs(ds.vocab)
    kw = dict(ENGINE, prefill_chunk_tokens=chunk)
    r = drive(REngine, ds.r_model, ds.r_params, subs, stagger=2, **kw)
    t = drive(Engine, ds.t_model, ds.t_params, subs, stagger=2, **kw)
    assert_same_run(*r, *t)
    assert t[0].stats()["hit_tokens"] > 0
    assert t[0].cache.layout == "mla"


def test_engine_warm_prefix_pass_matches_reference(ds):
    """A second pass of the same prompts on a warm engine hits the prefix
    cache for their full blocks; streams equal the reference's and the
    first pass's."""
    subs = _subs(ds.vocab)
    outs = []
    for cls, model, params in ((REngine, ds.r_model, ds.r_params),
                               (Engine, ds.t_model, ds.t_params)):
        eng = cls(model, params, prefill_chunk_tokens=8, **ENGINE)
        passes = []
        for _ in range(2):
            rids = [eng.submit(**s) for s in [dict(x) for x in subs]]
            out = eng.run()
            passes.append([np.asarray(out[r]) for r in rids])
        outs.append((passes, eng.stats()))
    (r_passes, r_stats), (t_passes, t_stats) = outs
    for a, b in zip(r_passes, t_passes):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    for x, y in zip(*t_passes):
        np.testing.assert_array_equal(y, x)
    assert t_stats["hit_tokens"] == r_stats["hit_tokens"] > 40


def test_sampled_engine_matches_reference(ds):
    """Requests sampled at temperature 0.9 (one greedy) draw the
    reference's tokens."""
    subs = _subs(ds.vocab, temps=(0.9, 0.9, 0.0, 0.9))
    r = drive(REngine, ds.r_model, ds.r_params, subs, stagger=1,
              prefill_chunk_tokens=8, **ENGINE)
    t = drive(Engine, ds.t_model, ds.t_params, subs, stagger=1,
              prefill_chunk_tokens=8, **ENGINE)
    assert_same_run(*r, *t)


def test_ngram_spec_engine_matches_reference(ds):
    """n-gram drafts at depth 3 (verify over the latent pool): streams and
    ``spec_*`` counters equal the reference's, and the streams are the
    vanilla engine's."""
    subs = _subs(ds.vocab)
    kw = dict(ENGINE, prefill_chunk_tokens=8)
    vanilla = drive(Engine, ds.t_model, ds.t_params, subs, stagger=1,
                    **kw)[2]
    r = drive(REngine, ds.r_model, ds.r_params, subs, stagger=1,
              spec=RSpecConfig(depth=3, mode="ngram"), **kw)
    t = drive(Engine, ds.t_model, ds.t_params, subs, stagger=1,
              spec=SpecConfig(depth=3, mode="ngram"), **kw)
    assert_same_run(*r, *t)
    assert t[0].stats()["spec_accepted"] > 0
    for rid, s in t[2].items():
        np.testing.assert_array_equal(s, vanilla[rid])


def test_corrupt_latent_block_matches_reference(ds):
    """One ``corrupt_block`` on the latent pool at step 6: the same fault
    log, terminal states and streams as the reference (the victim is
    quarantined)."""
    subs = _subs(ds.vocab)
    ev = [FaultEvent(step=6, kind="corrupt_block", target=0)]
    kw = dict(ENGINE, prefill_chunk_tokens=8)
    r = drive(REngine, ds.r_model, ds.r_params, subs, stagger=1,
              faults=rfaults.FaultInjector(
                  [rfaults.FaultEvent(**dataclasses.asdict(e))
                   for e in ev]), **kw)
    t = drive(Engine, ds.t_model, ds.t_params, subs, stagger=1,
              faults=FaultInjector(ev), **kw)
    assert_same_run(*r, *t)
    assert t[0].stats()["quarantined"] >= 1
    t[0].cache.allocator.check_conservation()


def test_unported_paths_raise(ds):
    """The paged engine across ranks of an MLA / MoE model builds over a
    latent pool sharded by blocks, and so does a latent pool created over
    ranks on its own (the reference's ``_pool_pspec``: a rank-4 latent
    shape never shards by heads); on a model whose mesh has more than one
    rank, ``loss``, the whole-prompt ``prefill``, the dense ``decode`` and
    ``FixedSlotEngine`` run (here on a mesh record of 2 ranks whose model
    groups are those of one, so they compute the one-rank values; across
    real ranks: ``tests/test_torch_deepseek_dist.py`` and
    ``tests/test_torch_deepseek_mesh.py``)."""
    FixedSlotEngine(ds.t_model, ds.t_params)
    ranks = DecoderLM(ds.t_model.cfg, device="cpu")
    ranks.mesh = _two_seq_ranks()
    eng = Engine(ranks, ds.t_params, n_blocks=16)
    assert eng.cache.layout == "mla" and eng.cache.sharding == "blocks"
    assert eng.cache.shard.n_local == 8
    assert tuple(eng.cache.pools["ckv_pool"].shape[:2]) == (2, 8)
    cache = PagedKVCache.create(ds.t_model.cfg, block_size=4, n_blocks=8,
                                mesh=_two_seq_ranks(), device="cpu")
    assert cache.sharding == "blocks" and cache.shard.n_local == 4
    tok = torch.zeros((1, 8), dtype=torch.int64)
    want, _ = ds.t_model.prefill(ds.t_params, tok)
    got, cache = ranks.prefill(ds.t_params, tok)
    assert torch.equal(got, want)
    out, _ = FixedSlotEngine(ranks, ds.t_params).generate(
        {"tokens": tok.numpy()}, 2)
    assert out.shape == (1, 2)
    cache = ranks.pad_cache(cache, 9)
    ranks.decode(ds.t_params, cache, tok[:, :1],
                 torch.full((1,), 8, dtype=torch.int32))
    loss, met = ranks.loss(ds.t_params, {
        "tokens": torch.zeros((1, 8), dtype=torch.int64),
        "labels": torch.zeros((1, 8), dtype=torch.int64)})
    assert float(met["aux"]) > 0 and torch.isfinite(loss)


def _two_seq_ranks():
    """A mesh record whose sequence axis has 2 ranks, this one rank 0 (no
    world needed: building a pool or an engine runs no collective)."""
    two = types.SimpleNamespace(size=2, rank=0)
    return types.SimpleNamespace(size=lambda ax: 2, world=two,
                                 comms={"model": two})


# --------------------------------------------------------- checkpoints

def test_checkpoint_bytes_match_reference(ds, tmp_path):
    """The moe tree, carried into the port and back out with
    ``to_reference_params``, writes the reference's checkpoint to the
    byte, and the port restores the reference's file."""
    pp, rp = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(pp, {"params": to_reference_params(ds.t_params)}, step=2)
    rck.save(rp, {"params": ds.r_params}, step=2)
    for name in ("weights.npz", "manifest.json"):
        assert open(os.path.join(pp, name), "rb").read() == \
            open(os.path.join(rp, name), "rb").read(), name
    like = {"params": to_reference_params(DecoderLM(
        ds.t_model.cfg, device="cpu").init(1))}
    back = ckpt.restore(rp, like)["params"]
    for (k, a), b in zip(ckpt.flatten(back).items(),
                         ckpt.flatten(to_reference_params(
                             ds.t_params)).values()):
        assert torch.equal(a, b), k
