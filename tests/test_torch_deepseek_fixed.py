"""DeepSeek-V2-Lite (MLA + MoE) through the fixed-slot engine, in the port
against the JAX reference, on the CPU.

The smoke config of ``deepseek-v2-lite-16b`` (2 layers — one dense, one MoE
of 4 routed + 1 shared experts, top 2 — 4 heads, MLA q/k 48 = nope 32 ⊕ rope
16, v 32, latent 32 + rope 16, float32); the reference on an Auto-axis
(1, 1) mesh with ``impl="ref"`` and its weights carried into the port.  The
whole-prompt ``prefill`` runs MLA materialised (kernel A's pair route on
the card; its plain version here) and keeps the latent rows as the dense
cache ``{"ckv"}``; the dense-cache ``decode`` attends them absorbed.

Bars: ``mla_qkv`` 1e-5 (the chunk forward's, ``tests/test_kernels.py``);
the plain chunk at Dk ≠ Dv 1e-5 (o) and 1e-4 (lse) against the reference's
Pallas kernel in interpret mode; logits and ``ckv`` 1e-4 (float32
summation order, as ``tests/test_torch_deepseek.py``); engine streams
equal.  At smoke size the capacity factor is 4.0 and nothing drops, so the
prefill is also held at 0.5, where the whole prompt's B·T rows share one
dispatch and pairs drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mask as rmk
from repro.kernels.flash_attention import flash_fwd_bhtd
from repro.models import layers as RL
from repro.models.transformer import Runtime, build_model
from repro.serve.engine import FixedSlotEngine as RFixedSlotEngine
from repro_torch.core import mask as mk
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import prng
from repro_torch.serve.engine import FixedSlotEngine

from _torch_serve_cases import pair, prompts

ARCH = "deepseek-v2-lite-16b"
QKV_TOL = 1e-5
O_TOL, LSE_TOL = 1e-5, 1e-4
LOGIT_TOL = 1e-4
T_PROMPT, N_GEN = 24, 5
SAMPLE_SEED = 3


@pytest.fixture(scope="module")
def ds():
    return pair(ARCH)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _at_capacity(ds, cf):
    """The pair's models at MoE capacity factor ``cf`` (same weights)."""
    if cf == ds.t_model.cfg.moe.capacity_factor:
        return ds.r_model, ds.t_model
    r_cfg = ds.r_model.cfg.replace(moe=dataclasses.replace(
        ds.r_model.cfg.moe, capacity_factor=cf))
    t_cfg = ds.t_model.cfg.replace(moe=dataclasses.replace(
        ds.t_model.cfg.moe, capacity_factor=cf))
    return (build_model(r_cfg, Runtime(mesh=ds.r_model.rt.mesh,
                                       par=ds.r_model.rt.par, impl="ref")),
            DecoderLM(t_cfg, device="cpu"))


# ------------------------------------------------------------- MLA

def test_mla_qkv_returns_reference_latent(ds):
    """``mla_qkv(return_latent=True)`` on the dense layer at T 16: q, k, v
    and the latent rows (normed c_kv ⊕ roped k_pe, 48 columns) within 1e-5
    of the reference's; without the flag, the same q, k, v."""
    cfg = ds.t_model.cfg
    a = cfg.attn
    x = np.random.default_rng(21).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16)
    tc, ts = L.rope_tables(torch.from_numpy(pos), a.qk_rope_head_dim,
                           a.rope_theta)
    rc, rs = RL.rope_tables(jnp.asarray(pos), a.qk_rope_head_dim,
                            a.rope_theta)
    rp = jax.tree.map(lambda t: jnp.asarray(t[0]),
                      ds.r_params["dense_layers"]["attn"])
    want = RL.mla_qkv(rp, jnp.asarray(x), ds.r_model.cfg, rc, rs,
                      return_latent=True)
    lp = ds.t_params["dense_layers"][0]["attn"]
    got = L.mla_qkv(lp, torch.from_numpy(x), cfg, tc, ts,
                    return_latent=True)
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 4, 48), (2, 16, 4, 48), (2, 16, 4, 32),
        (2, 16, a.kv_lora_rank + a.qk_rope_head_dim)]
    for g, w in zip(got, want):
        _close(g.numpy(), w, QKV_TOL)
    for g, w in zip(L.mla_qkv(lp, torch.from_numpy(x), cfg, tc, ts), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dk,dv", [(48, 32), (192, 128)],
                         ids=["smoke", "served"])
def test_pair_chunk_plain_matches_reference_kernel(dk, dv):
    """Kernel A's plain version at q/k ≠ v — the smoke config's 48 / 32 and
    the served model's 192 / 128 (kernel A's pair route on the card) — 4
    heads, causal at q offset 40, scale 1/√dk, against the reference's
    ``flash_fwd_bhtd`` in interpret mode: o within 1e-5, lse within 1e-4;
    the wrapper runs it for CPU tensors."""
    rng = np.random.default_rng(22)
    Tq, Tk, H, off = 24, 64, 4, 40
    q = rng.standard_normal((1, Tq, H, dk)).astype(np.float32)
    k = rng.standard_normal((1, Tk, H, dk)).astype(np.float32)
    v = rng.standard_normal((1, Tk, H, dv)).astype(np.float32)
    sc = 1.0 / np.sqrt(dk)
    o_r, lse_r = flash_fwd_bhtd(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        scale=sc, mask=rmk.causal(rel_offset=off), interpret=True)
    o, lse = fa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                          mask=mk.causal(rel_offset=off), scale=sc)
    assert tuple(o.shape) == (1, Tq, H, dv)
    _close(o.numpy(), np.asarray(o_r).transpose(0, 2, 1, 3), O_TOL)
    _close(lse.numpy(), np.asarray(lse_r).transpose(0, 2, 1), LSE_TOL)
    assert ((dk, dv) in fa.PAIR_DIMS) == (dk == 192)


# ------------------------------------------------- prefill and decode

@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_prefill_and_dense_decode_match_reference(ds, cf):
    """The whole-prompt prefill of 2 prompts of 24 tokens: last logits and
    the latent cache ``{"ckv"}`` (L, B, T, 48) within 1e-4 of the
    reference's; then the cache padded by 3 slots and three dense decode
    steps at per-request positions (request 1 rewrites slots inside its
    prompt): logits and ``ckv`` within 1e-4 after each.  At capacity 0.5
    the prompt's 48 rows overflow the experts (pairs drop)."""
    r_model, t_model = _at_capacity(ds, cf)
    cfg = t_model.cfg
    toks = np.stack(prompts(ds.vocab, [T_PROMPT] * 2, seed=23))
    n, K, E = toks.size, cfg.moe.top_k, cfg.moe.n_routed
    assert (n * K > E * M.capacity(cfg, n)) == (cf < 1)
    r_logits, r_cache = r_model.prefill(ds.r_params,
                                        {"tokens": jnp.asarray(toks)})
    logits, cache = t_model.prefill(ds.t_params, torch.from_numpy(toks))
    assert list(cache) == ["ckv"] == list(r_cache)
    assert tuple(cache["ckv"].shape) == (2, 2, T_PROMPT, 48)
    _close(logits.numpy(), r_logits)
    _close(cache["ckv"].numpy(), r_cache["ckv"])
    S = T_PROMPT + 3
    cache = t_model.pad_cache(cache, S)
    rc = {"ckv": jnp.pad(r_cache["ckv"], [(0, 0), (0, 0), (0, 3), (0, 0)])}
    rng = np.random.default_rng(24)
    for i in range(3):
        tok = rng.integers(0, ds.vocab, (2, 1)).astype(np.int32)
        pos = np.array([T_PROMPT + i, T_PROMPT - 4 + i], np.int32)
        r_logits, rc = r_model.decode(
            ds.r_params, rc, {"token": jnp.asarray(tok),
                              "pos": jnp.asarray(pos)})
        logits = t_model.decode(ds.t_params, cache, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        _close(logits.numpy(), r_logits)
        _close(cache["ckv"].numpy(), rc["ckv"])


# ------------------------------------------------------------- engine

@pytest.mark.parametrize("B,cf,temp", [(1, 4.0, 0.0), (2, 4.0, 0.0),
                                       (2, 0.5, 0.0), (2, 4.0, 0.9)],
                         ids=["greedy1", "greedy2", "drops", "sampled"])
def test_fixed_slot_engine_matches_reference(ds, B, cf, temp):
    """``FixedSlotEngine.generate`` on B prompts of 24 tokens, 5 tokens
    each: greedy (one prompt, two; two at capacity 0.5) or sampled at 0.9
    with the reference's key (``serve/prng.py``): the reference's tokens,
    and last logits within 1e-4."""
    r_model, t_model = _at_capacity(ds, cf)
    toks = np.stack(prompts(ds.vocab, [T_PROMPT] * B, seed=25))
    r_rng = jax.random.PRNGKey(SAMPLE_SEED) if temp else None
    t_rng = prng.prng_key(SAMPLE_SEED) if temp else None
    r_out, r_logits = RFixedSlotEngine(r_model, ds.r_params).generate(
        {"tokens": jnp.asarray(toks)}, N_GEN, rng=r_rng, temperature=temp)
    out, logits = FixedSlotEngine(t_model, ds.t_params).generate(
        {"tokens": toks}, N_GEN, rng=t_rng, temperature=temp)
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    _close(logits.numpy(), r_logits)


def test_fixed_slot_cli_serves_across_four_ranks(capfd):
    """``python -m repro_torch.launch.serve --fixed-slot --arch
    deepseek-v2-lite-16b --smoke --device cpu`` on one rank and on a
    self-spawned 4-rank world (``--nproc 4 --seq-shards 4``: the prefill
    across the ranks, the routed experts one a rank, the ``{"ckv"}`` cache
    sharded along the sequence) prints the same tokens."""
    from repro_torch.launch import serve as cli
    base = ["--fixed-slot", "--arch", ARCH, "--smoke", "--device", "cpu",
            "--prompt-len", "32", "--gen", "6", "--batch", "2"]
    toks = []
    for extra in ([], ["--nproc", "4", "--seq-shards", "4"]):
        assert cli.main(base + extra) == 0
        out = capfd.readouterr().out
        toks.append([x for x in out.splitlines()
                     if x.startswith("sampled token ids")])
        assert len(toks[-1]) == 1, out
    assert "cache shards=4" in out
    assert toks[0] == toks[1]
