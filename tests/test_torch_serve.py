"""Parity of the port's serving slice with the JAX reference, on the CPU.

Smoke ``llama-7b`` (MHA) and ``llama-gqa`` (GQA): 2 layers, 4 heads of 32,
float32.  The reference ``DecoderLM.init`` weights are carried into the port
with ``load_reference_params``; prompts come from numpy.  Logits agree to
1e-4 — the slack is float32 matmul summation order (XLA's CPU dots against
PyTorch's).  Greedy engine streams must be token-identical to the reference
``Engine``; sampled streams are also held to the port's own batch and
preemption invariance (their equality with the reference's is in
``tests/test_torch_sampling.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import ShapeSpec
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine as REngine
from repro_torch.core.config import get_config, smoke_config
from repro_torch.models.transformer import DecoderLM, load_reference_params
from repro_torch.serve.engine import Engine

LOGIT_TOL = 1e-4   # float32 matmul summation order


def _pair(arch, window=0):
    """(reference model, reference params, port model, port params)."""
    r_cfg = r_smoke_config(r_get_config(arch))
    t_cfg = smoke_config(get_config(arch))
    if window:
        r_cfg = r_cfg.replace(attn=dataclasses.replace(r_cfg.attn,
                                                       window=window))
        t_cfg = t_cfg.replace(attn=dataclasses.replace(t_cfg.attn,
                                                       window=window))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    par = make_parallel_config(mesh, ShapeSpec("srv", 32, 4, "prefill"))
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    r_params = r_model.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, r_params)
    t_model = DecoderLM(t_cfg, device="cpu")
    return r_model, r_params, t_model, load_reference_params(t_cfg, tree,
                                                             device="cpu")


@pytest.mark.parametrize("arch,window", [("llama-7b", 0), ("llama-gqa", 0),
                                         ("llama-gqa", 6)])
def test_prefill_chunk_then_decode_logits_match_reference(arch, window):
    """Three chunked-prefill chunks (the last one padded) into a fragmented
    block table, then two decode steps with an idle second batch row."""
    r_model, r_params, t_model, t_params = _pair(arch, window)
    a = t_model.cfg.attn
    bs, N, L = 8, 16, t_model.cfg.n_layers
    shape = (L, N, bs, a.n_kv_heads, a.head_dim)
    table = np.array([[3, 7, 1, 5, 9, 2, 0, 0]], np.int32)
    rng = np.random.default_rng(0)
    ctx = rng.integers(0, t_model.cfg.vocab, 23).astype(np.int32)
    r_cache = {"k_pool": jnp.zeros(shape), "v_pool": jnp.zeros(shape)}
    t_cache = {"k_pool": torch.zeros(shape), "v_pool": torch.zeros(shape)}
    for start, n in [(0, 8), (8, 8), (16, 4)]:
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = ctx[start:start + n]
        nkv = 4
        out = r_model.prefill_chunk(
            r_params, {**r_cache, "block_table": jnp.asarray(table[:, :nkv])},
            {"tokens": jnp.asarray(toks), "start": start, "n_valid": n})
        r_cache = {k: out[k] for k in r_cache}
        t_model.prefill_chunk(
            t_params, {**t_cache, "block_table": torch.from_numpy(
                table[:, :nkv].copy())}, torch.from_numpy(toks), start, n)
    for pos in (20, 21):
        bt = np.concatenate([table, np.zeros_like(table)])
        tok = np.array([[ctx[pos]], [0]], np.int32)
        p = np.array([pos, 0], np.int32)
        r_logits, out = r_model.decode(
            r_params, {**r_cache, "block_table": jnp.asarray(bt)},
            {"token": jnp.asarray(tok), "pos": jnp.asarray(p)})
        r_cache = {k: out[k] for k in r_cache}
        t_logits = t_model.decode(
            t_params, {**t_cache, "block_table": torch.from_numpy(bt)},
            torch.from_numpy(tok), torch.from_numpy(p))
        np.testing.assert_allclose(t_logits[0].numpy(),
                                   np.asarray(r_logits)[0], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    # the written KV itself agrees, block for block
    for k in ("k_pool", "v_pool"):
        np.testing.assert_allclose(t_cache[k][:, 1:].numpy(),
                                   np.asarray(r_cache[k])[:, 1:],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch,window", [("llama-7b", 0), ("llama-gqa", 0),
                                         ("llama-gqa", 16)])
def test_generate_greedy_streams_match_reference_engine(arch, window):
    r_model, r_params, t_model, t_params = _pair(arch, window)
    prompts = np.random.default_rng(1).integers(
        0, t_model.cfg.vocab, (3, 24)).astype(np.int32)
    kw = dict(max_batch=4, block_size=8, n_blocks=32)
    r_out = np.asarray(REngine(r_model, r_params, **kw).generate(
        {"tokens": prompts}, 6))
    t_out = Engine(t_model, t_params, **kw).generate({"tokens": prompts}, 6)
    np.testing.assert_array_equal(t_out, r_out)


def _mixed_prompts(vocab):
    """Mixed lengths, a shared 20-token prefix, and a one-token prompt."""
    rng = np.random.default_rng(2)
    p0 = rng.integers(0, vocab, 30)
    return [p0, np.concatenate([p0[:20], rng.integers(0, vocab, 7)]),
            rng.integers(0, vocab, 11), rng.integers(0, vocab, 1)]


def test_chunked_prefix_cached_preempted_streams_match_reference():
    """Chunked prefill, prefix-cache sharing and pool-pressure preemption
    schedule identically in both engines, so greedy streams match."""
    r_model, r_params, t_model, t_params = _pair("llama-gqa")
    prompts = _mixed_prompts(t_model.cfg.vocab)
    kw = dict(max_batch=3, block_size=8, n_blocks=9,
              prefill_chunk_tokens=8, prefix_cache=True)
    r_eng = REngine(r_model, r_params, **kw)
    t_eng = Engine(t_model, t_params, audit=True, **kw)
    for p in prompts:
        r_eng.submit(p, max_new_tokens=12)
        t_eng.submit(p, max_new_tokens=12)
    r_out, t_out = r_eng.run(), t_eng.run()
    assert t_eng.stats()["n_preemptions"] > 0
    assert t_eng.stats()["hit_tokens"] > 0
    assert t_eng.stats()["n_preemptions"] == r_eng.stats()["n_preemptions"]
    assert t_eng.stats()["audit_passes"] == t_eng.stats()["steps"]
    for rid in r_out:
        np.testing.assert_array_equal(t_out[rid], r_out[rid])


def test_stream_and_stop_tokens():
    """``stream`` yields what ``run`` returns; a stop token ends a request
    early with reason "stop"."""
    model = DecoderLM(smoke_config(get_config("llama-7b")), device="cpu")
    params = model.init(1)
    prompt = _mixed_prompts(model.cfg.vocab)[2]
    full = Engine(model, params, max_batch=2, block_size=8, n_blocks=16)
    rid = full.submit(prompt, max_new_tokens=8)
    streamed = np.asarray(list(full.stream(rid)))
    eng = Engine(model, params, max_batch=2, block_size=8, n_blocks=16)
    rid2 = eng.submit(prompt, max_new_tokens=8)
    np.testing.assert_array_equal(streamed, eng.run()[rid2])
    stop = int(streamed[3])
    k = int(np.nonzero(streamed == stop)[0][0])
    eng = Engine(model, params, max_batch=2, block_size=8, n_blocks=16)
    rid3 = eng.submit(prompt, max_new_tokens=8, stop_tokens=(stop,))
    np.testing.assert_array_equal(eng.run()[rid3], streamed[:k + 1])
    assert eng.status(rid3) == ("finished", "stop")


def test_sampled_streams_are_batch_and_preemption_invariant():
    """The port's own contract for temperature sampling: a request's stream
    depends only on (prompt, seed, temperature) — alone, in a batch, under
    preemption — and another seed changes it."""
    model = DecoderLM(smoke_config(get_config("llama-gqa")), device="cpu")
    params = model.init(0)
    prompts = _mixed_prompts(model.cfg.vocab)
    kw = dict(max_new_tokens=10, temperature=0.9)

    def solo(i, seed):
        eng = Engine(model, params, max_batch=2, block_size=8, n_blocks=32,
                     prefill_chunk_tokens=0, prefix_cache=False)
        rid = eng.submit(prompts[i], seed=seed, **kw)
        return eng.run()[rid]

    eng = Engine(model, params, max_batch=3, block_size=8, n_blocks=9,
                 prefill_chunk_tokens=8)
    rids = [eng.submit(p, seed=100 + i, **kw) for i, p in enumerate(prompts)]
    out = eng.run()
    assert eng.stats()["n_preemptions"] > 0
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid], solo(i, 100 + i))
    assert not np.array_equal(solo(0, 100), solo(0, 101))


def test_paged_engine_logits_match_plain_forward():
    """The engine's last decode logits equal a plain whole-context forward
    of the same port model (the check the GPU smoke makes at full size).
    The logits are recorded by a wrapper of ``model.decode``: each decode
    row's logits under the request that holds its slot."""
    model = DecoderLM(smoke_config(get_config("llama-7b")), device="cpu")
    params = model.init(3)
    prompts = _mixed_prompts(model.cfg.vocab)
    eng = Engine(model, params, max_batch=4, block_size=8, n_blocks=64,
                 prefill_chunk_tokens=16)
    last = {}
    decode = model.decode

    def recording(p, cache, token, pos):
        logits = decode(p, cache, token, pos)
        for slot, r in eng.sched.running.items():
            if r.state == "decode":
                last[r.rid] = logits[slot, -1].float()
        return logits

    model.decode = recording
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    out = eng.run()
    for rid, p in zip(rids, prompts):
        ctx = np.concatenate([p, out[rid][:-1]])[None]
        ref = model.forward(params, torch.from_numpy(ctx), last_only=True)
        np.testing.assert_allclose(last[rid].numpy(),
                                   ref[0, -1].float().numpy(),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert int(ref[0, -1].argmax()) == int(out[rid][-1])


def test_engine_reports_phase_seconds():
    """``stats()`` carries the seconds spent in prefill chunks and decode
    steps, each positive once that phase has run."""
    model = DecoderLM(smoke_config(get_config("llama-gqa")), device="cpu")
    params = model.init(0)
    eng = Engine(model, params, max_batch=2, block_size=8, n_blocks=32,
                 prefill_chunk_tokens=8)
    assert eng.stats()["prefill_seconds"] == eng.stats()["decode_seconds"] == 0
    eng.submit(_mixed_prompts(model.cfg.vocab)[0], max_new_tokens=3)
    eng.run()
    st = eng.stats()
    assert st["prefill_seconds"] > 0 and st["decode_seconds"] > 0
