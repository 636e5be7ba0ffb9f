"""The Qwen dense family in the port against the JAX reference, on the CPU.

``qwen3-8b`` (GQA group 4, qk-norm), ``qwen2.5-14b`` (group 5 → one kv head
at smoke size, q/k/v bias) and ``qwen1.5-32b`` (MHA, q/k/v bias): their
smoke configs (2 layers, 4 heads of 32, float32).  The reference initializes
the biases to zeros and the qk-norm weights to ones, which would hide a
missing feature, so every case first perturbs those leaves in numpy (biases
N(0, 0.5²), norms uniform in [0.5, 1.5)) and loads the same tree into both
packages.  Each feature's bar is also shown to reject the port with that
feature left out.

Bars: ``attn_qkv`` float32 1e-5, bf16 2e-2 (the chunk forward's,
``tests/test_kernels.py``); loss and every gradient 5e-5 (the distributed
gradients', ``tests/test_dist_attention.py``); logits 1e-4 (float32
summation order, as ``tests/test_torch_serve.py``); engine streams equal;
checkpoints byte-identical.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core.config import ShapeSpec as RShapeSpec
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.io import checkpoint as rck
from repro.models import layers as RL
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine as REngine
from repro_torch.configs.spec_pairs import PAIRS
from repro_torch.core.config import ParallelConfig, get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.io import checkpoint as ckpt
from repro_torch.models import layers as L
from repro_torch.models.transformer import (DecoderLM, load_reference_params,
                                            to_reference_params, trainable)
from repro_torch.serve.engine import Engine, FixedSlotEngine

from _torch_mesh_cases import perturb
from _torch_serve_cases import assert_same_run, drive, prompts

ARCHS = ("qwen3-8b", "qwen2.5-14b", "qwen1.5-32b")
QKV_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 5e-5
LOGIT_TOL = 1e-4
T, B = 32, 2


def without_feature(cfg):
    """The config with its Qwen feature left out: the bias (1.5, 2.5) or
    the qk-norm (3)."""
    a = cfg.attn
    feat = "qk_norm" if a.qk_norm else "qkv_bias"
    return cfg.replace(attn=dataclasses.replace(a, **{feat: False}))


@dataclasses.dataclass
class Pair:
    r_model: object
    r_params: dict           # perturbed, jnp
    tree: dict               # the same, numpy
    t_cfg: object

    def t_params(self, dtype=None):
        return load_reference_params(self.t_cfg, self.tree, device="cpu",
                                     dtype=dtype)


def qwen_pair(arch, remat="remat_aware") -> Pair:
    r_cfg = r_smoke_config(r_get_config(arch))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    par = make_parallel_config(mesh, RShapeSpec("q", T, B, "train"),
                               remat=remat)
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    tree = perturb(jax.tree.map(np.asarray, r_model.init(
        jax.random.PRNGKey(0))))
    return Pair(r_model, jax.tree.map(jnp.asarray, tree), tree,
                smoke_config(get_config(arch)))


@pytest.fixture(scope="module", params=ARCHS)
def qwen(request):
    return qwen_pair(request.param)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_param_count_match_reference(arch):
    """The port's config is the reference's field for field (those the
    port has), and ``param_count`` is the reference's, biases uncounted."""
    t, r = get_config(arch), r_get_config(arch)
    for f in dataclasses.fields(t):
        if f.name != "attn":
            assert getattr(t, f.name) == getattr(r, f.name), f.name
    for f in dataclasses.fields(t.attn):
        assert getattr(t.attn, f.name) == getattr(r.attn, f.name), f.name
    assert t.param_count() == r.param_count()
    s = smoke_config(t)
    assert (s.attn.qkv_bias, s.attn.qk_norm) == (t.attn.qkv_bias,
                                                 t.attn.qk_norm)
    rs = r_smoke_config(r).attn
    for f in dataclasses.fields(s.attn):
        assert getattr(s.attn, f.name) == getattr(rs, f.name), f.name


def test_spec_pairs_resolve():
    """Every target and draft ``configs/spec_pairs.py`` names loads."""
    for target, draft in PAIRS.items():
        assert get_config(target).name == target
        assert get_config(draft).name == draft


def test_init_makes_the_reference_leaves():
    """``DecoderLM.init``: zero q/k/v biases and unit qk-norms, in the
    reference's tree layout."""
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        r_flat = rck._flatten(qwen_pair(arch).r_model.init(
            jax.random.PRNGKey(0)))[0]
        p = DecoderLM(cfg, device="cpu").init(0)
        flat = ckpt.flatten(to_reference_params(p))
        assert list(flat) == list(r_flat)
        for k, v in flat.items():
            assert tuple(v.shape) == tuple(r_flat[k].shape), k
        attn = p["layers"][0]["attn"]
        for k in ("bq", "bk", "bv"):
            assert (k in attn) == cfg.attn.qkv_bias
            if k in attn:
                assert not attn[k].any()
        for k in ("q_norm", "k_norm"):
            assert (k in attn) == cfg.attn.qk_norm
            if k in attn:
                assert bool((attn[k] == 1).all())


# ------------------------------------------------------------ attn_qkv

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_qkv_matches_reference(qwen, dtype):
    """Norm → projections → bias → qk-norm → rope, layer 0, at T 32 with
    per-request rope tables: q, k, v within the bar; the port without its
    Qwen feature exceeds it."""
    rng = np.random.default_rng(3)
    cfg = qwen.t_cfg.replace(dtype=dtype)
    a = cfg.attn
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(T), 7 + np.arange(T)])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rp = jax.tree.map(lambda t: jnp.asarray(t[0], jdt),
                      qwen.tree["layers"]["attn"])
    rc, rs = RL.rope_tables(jnp.asarray(pos.reshape(-1)), a.head_dim,
                            a.rope_theta)
    want = RL.attn_qkv(rp, jnp.asarray(x, jdt), r_smoke_config(
        r_get_config(cfg.name)).replace(dtype=dtype),
        rc.reshape(B, T, -1), rs.reshape(B, T, -1))
    tp = qwen.t_params(tdt)["layers"][0]["attn"]
    tc, ts = L.rope_tables(torch.from_numpy(pos.reshape(-1)), a.head_dim,
                           a.rope_theta)
    tc, ts = tc.reshape(B, T, -1), ts.reshape(B, T, -1)
    xt = torch.from_numpy(x).to(tdt)
    tol = QKV_TOL[dtype]
    for got, ref in zip(L.attn_qkv(tp, xt, cfg, tc, ts), want):
        assert got.dtype == tdt
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol,
                                   rtol=tol)
    bare = L.attn_qkv(tp, xt, without_feature(cfg), tc, ts)
    worst = max(float(np.abs(g.float().numpy() - np.asarray(r, np.float32))
                      .max()) for g, r in zip(bare, want))
    assert worst > 10 * tol, worst


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["remat_aware", "none"])
def test_loss_and_grads_match_reference(arch, remat):
    """The loss and every gradient, the biases and qk-norm weights among
    them, within 5e-5 under each checkpoint policy; the loss without the
    Qwen feature is off by more."""
    pr = qwen_pair(arch, remat)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, pr.t_cfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (r_loss, _), r_grads = jax.value_and_grad(pr.r_model.loss,
                                              has_aux=True)(
        pr.r_params, jax.tree.map(jnp.asarray, batch))
    model = DecoderLM(pr.t_cfg, device="cpu", par=ParallelConfig(
        remat=remat))
    params = trainable(pr.t_params())
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = model.loss(params, t_batch)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    ref = load_reference_params(pr.t_cfg, jax.tree.map(np.asarray, r_grads),
                                device="cpu")
    names = [n for n in params["layers"][0]["attn"]
             if n in ("bq", "bk", "bv", "q_norm", "k_norm")]
    assert names
    for g, r in zip(grads, leaves(ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    for n in names:
        assert float(ref["layers"][0]["attn"][n].abs().max()) > 1e-4, n
    bare, _ = DecoderLM(without_feature(pr.t_cfg), device="cpu").loss(
        pr.t_params(), t_batch)
    assert abs(float(bare) - float(r_loss)) > 10 * GRAD_TOL


# ------------------------------------------------------------- serving

ENGINE = dict(max_batch=3, block_size=8, n_blocks=40, prefill_chunk_tokens=8)


def _subs(vocab):
    p = prompts(vocab, [21, 13, 30, 9], seed=2)
    return [dict(prompt=x, max_new_tokens=n)
            for x, n in zip(p, (8, 5, 6, 7))]


def test_paged_engine_streams_match_reference(qwen):
    """Staggered submissions through chunked prefill, a shared pool with
    the prefix cache and decode: the same streams and counters as the
    reference ``Engine``."""
    subs = _subs(qwen.t_cfg.vocab)
    r = drive(REngine, qwen.r_model, qwen.r_params, subs, stagger=1,
              **ENGINE)
    t = drive(Engine, DecoderLM(qwen.t_cfg, device="cpu"), qwen.t_params(),
              subs, stagger=1, **ENGINE)
    assert_same_run(*r, *t)


def test_fixed_slot_engine_equals_paged(qwen):
    """The dense fixed-slot oracle and the paged engine give the same
    greedy streams (``tests/test_serving_engine.py``'s equivalence)."""
    model, params = DecoderLM(qwen.t_cfg, device="cpu"), qwen.t_params()
    toks = np.stack(prompts(qwen.t_cfg.vocab, [24, 24], seed=6))
    fixed, _ = FixedSlotEngine(model, params).generate({"tokens": toks}, 6)
    paged = Engine(model, params, max_batch=4, block_size=8,
                   n_blocks=32).generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(fixed.numpy(), paged)


def test_verify_matches_reference(qwen):
    """A speculative verify at T = 5 (n_write 5, 2 and an idle row) over a
    pool that already holds context: logits and written pools within
    1e-4."""
    a, cfg = qwen.t_cfg.attn, qwen.t_cfg
    Ly, bs, N, Tv = cfg.n_layers, 8, 24, 5
    rng = np.random.default_rng(1)
    pools = {k: rng.standard_normal((Ly, N, bs, a.n_kv_heads, a.head_dim))
             .astype(np.float32) for k in ("k_pool", "v_pool")}
    table = np.array([[3, 7, 1, 5, 0, 0], [2, 9, 11, 4, 6, 0],
                      [0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.array([21, 35, 0], np.int32)
    n_write = np.array([5, 2, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, (3, Tv)).astype(np.int32)
    r_logits, r_out = qwen.r_model.verify(
        qwen.r_params, {**{k: jnp.asarray(v) for k, v in pools.items()},
                        "block_table": jnp.asarray(table)},
        {"tokens": jnp.asarray(toks), "pos": jnp.asarray(pos),
         "n_write": jnp.asarray(n_write)})
    t_pools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    t_logits = DecoderLM(cfg, device="cpu").verify(
        qwen.t_params(), {**t_pools, "block_table": torch.from_numpy(table)},
        torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(n_write))
    np.testing.assert_allclose(t_logits[:2].numpy(),
                               np.asarray(r_logits)[:2], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for k in pools:
        np.testing.assert_allclose(t_pools[k][:, 1:].numpy(),
                                   np.asarray(r_out[k])[:, 1:],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


# --------------------------------------------------------- checkpoints

def test_checkpoint_bytes_match_reference(qwen, tmp_path):
    """The perturbed tree, carried into the port and back out with
    ``to_reference_params``, writes the reference's checkpoint to the
    byte, and the port restores the reference's file to the same
    parameters."""
    params = qwen.t_params()
    pp, rp = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(pp, {"params": to_reference_params(params)}, step=3)
    rck.save(rp, {"params": qwen.r_params}, step=3)
    for name in ("weights.npz", "manifest.json"):
        assert open(os.path.join(pp, name), "rb").read() == \
            open(os.path.join(rp, name), "rb").read(), name
    like = {"params": to_reference_params(DecoderLM(
        qwen.t_cfg, device="cpu").init(1))}
    back = ckpt.restore(rp, like)["params"]
    for (k, a), b in zip(ckpt.flatten(back).items(),
                         ckpt.flatten(to_reference_params(params)).values()):
        assert torch.equal(a, b), k
