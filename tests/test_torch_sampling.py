"""The port's sampled streams are the reference's: ``serve/prng.py`` against
``jax.random`` (jax's default partitionable threefry2x32), and the port's
``Engine`` against the reference ``Engine`` at temperature > 0.

Keys, bits and uniforms must be equal to the bit.  Gumbel values go through
two float32 logarithms, and numpy's differs from XLA's CPU logarithm by up
to 3 units in the last place: they are held to 4 float32 steps of
``max(1, |g|)``.  Categorical draws must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.config import ShapeSpec
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine as REngine
from repro_torch.core.config import get_config, smoke_config
from repro_torch.models.transformer import DecoderLM, load_reference_params
from repro_torch.serve import prng
from repro_torch.serve.engine import Engine

SEEDS = [0, 1, 7, 4242, 2 ** 31 - 1]
POSITIONS = [0, 1, 25, 4095, 70_000]
TINY = np.finfo(np.float32).tiny
GUMBEL_STEPS = 4


def _key_data(key):
    return np.asarray(key, np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniforms_are_the_references_bits(seed):
    base = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), _key_data(base))
    for pos in POSITIONS:
        k = jax.random.fold_in(base, pos)
        kp = prng.fold_in(prng.prng_key(seed), pos)
        np.testing.assert_array_equal(kp, _key_data(k))
        for shape in [(1,), (517,), (3, 40)]:
            np.testing.assert_array_equal(
                prng.random_bits(kp, shape),
                np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32)))
        np.testing.assert_array_equal(
            prng.uniform(kp, (2000,)), np.asarray(jax.random.uniform(
                k, (2000,))))
        np.testing.assert_array_equal(
            prng.uniform(kp, (2000,), minval=TINY),
            np.asarray(jax.random.uniform(k, (2000,), minval=TINY)))


@pytest.mark.parametrize("V", [512, 32000])
def test_gumbel_and_categorical_match_jax(V):
    rng = np.random.default_rng(V)
    for seed in SEEDS:
        for pos in POSITIONS:
            k = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
            kp = prng.fold_in(prng.prng_key(seed), pos)
            g = np.asarray(jax.random.gumbel(k, (V,)))
            gp = prng.gumbel(kp, (V,))
            lim = GUMBEL_STEPS * 2.0 ** -23 * np.maximum(1.0, np.abs(g))
            assert (np.abs(gp.astype(np.float64) - g) <= lim).all()
            for scale in (0.5, 3.0):
                logits = (scale * rng.standard_normal(V)).astype(np.float32)
                assert int(prng.categorical(kp, logits)) == int(
                    jax.random.categorical(k, jnp.asarray(logits)))


def _pair(arch):
    r_cfg = r_smoke_config(r_get_config(arch))
    t_cfg = smoke_config(get_config(arch))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    par = make_parallel_config(mesh, ShapeSpec("srv", 32, 4, "prefill"))
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    r_params = r_model.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, r_params)
    t_model = DecoderLM(t_cfg, device="cpu")
    return r_model, r_params, t_model, load_reference_params(
        t_cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ["llama-7b", "llama-gqa"])
def test_sampled_streams_equal_reference_engine(arch):
    """Temperature 0.8, three requests with their own seeds and lengths,
    chunked prefill: the streams are the reference ``Engine``'s, token for
    token; a greedy request beside them stays greedy."""
    r_model, r_params, t_model, t_params = _pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, t_model.cfg.vocab, n) for n in (24, 9, 17)]
    kw = dict(max_batch=4, block_size=8, n_blocks=32,
              prefill_chunk_tokens=8)
    r_eng = REngine(r_model, r_params, **kw)
    t_eng = Engine(t_model, t_params, **kw)
    rids = []
    for i, p in enumerate(prompts):
        sk = dict(max_new_tokens=12, temperature=0.8, seed=11 + 31 * i)
        rids.append((r_eng.submit(p, **sk), t_eng.submit(p, **sk)))
    greedy = (r_eng.submit(prompts[0], max_new_tokens=12),
              t_eng.submit(prompts[0], max_new_tokens=12))
    r_out, t_out = r_eng.run(), t_eng.run()
    for r_id, t_id in rids + [greedy]:
        np.testing.assert_array_equal(t_out[t_id], np.asarray(r_out[r_id]))
    # sampling really drew: the seeded streams differ from the greedy one
    assert not np.array_equal(t_out[rids[0][1]], t_out[greedy[1]])


def test_sampling_positions_follow_the_reference():
    """The draw for the token at context position ``pos + 1`` uses
    ``fold_in(PRNGKey(seed), pos + 1)`` (the reference engine's
    ``_key_for(req, cached + 1)``): the port's ``_sample`` equals a direct
    ``jax.random.categorical`` under that key, row by row."""
    import torch
    from repro_torch.serve.engine import _sample
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((3, 512)).astype(np.float32)
    temps = np.array([0.8, 0.0, 1.3], np.float32)
    seeds = np.array([3, 4, 5])
    pos = np.array([10, 2, 77], np.int32)
    got = _sample(torch.from_numpy(logits), temps, seeds, pos + 1)
    for b in range(3):
        if temps[b] == 0:
            assert got[b] == int(np.argmax(logits[b]))
            continue
        k = jax.random.fold_in(jax.random.PRNGKey(int(seeds[b])),
                               int(pos[b]) + 1)
        want = jax.random.categorical(
            k, jnp.asarray(logits[b]) / jnp.maximum(temps[b], 1e-6))
        assert got[b] == int(want)


def test_sampled_stream_differs_by_seed_and_stays_in_vocab():
    cfg = dataclasses.replace(smoke_config(get_config("llama-gqa")))
    model = DecoderLM(cfg, device="cpu")
    params = model.init(0)
    prompt = np.arange(12) % cfg.vocab
    outs = []
    for seed in (1, 2):
        eng = Engine(model, params, max_batch=2, block_size=8, n_blocks=16)
        rid = eng.submit(prompt, max_new_tokens=10, temperature=1.0,
                         seed=seed)
        outs.append(np.asarray(eng.run()[rid]))
    assert not np.array_equal(outs[0], outs[1])
    assert all(((o >= 0) & (o < cfg.vocab)).all() for o in outs)
