"""Parity of the port's speculative decoding with the JAX reference, on the
CPU: the tree masks, ``SpecConfig`` and ``NGramDraft``, ``DecoderLM.verify``
(logits to 1e-4 and the written pools; at T = 1 it must be the port's
``decode`` bit for bit), and the speculating ``Engine``, whose streams,
``spec_*`` counters and depth histogram must equal the reference engine's
for n-gram, null and model drafts, adaptive depth, and a draft whose
vocabulary is wider than the target's.  Smoke configs in float32, the
reference's weights carried across with ``load_reference_params``.
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mask as rmk
from repro.serve import speculative as rspec
from repro.serve.engine import Engine as REngine
from repro_torch.core import mask as mk
from repro_torch.serve import speculative as spec
from repro_torch.serve.engine import Engine

from _torch_serve_cases import (LOGIT_TOL, assert_same_run, drive, pair,
                                prompts)

PARENTS = [(-1,), (-1, 0, 1, 2), (-1, 0, -1, 2), (-1, -1, -1),
           (-1, 0, 1, -1, 3)]


# ==========================================================================
# tree masks, SpecConfig, NGramDraft
# ==========================================================================

@pytest.mark.parametrize("parents", PARENTS)
def test_tree_masks_match_reference(parents):
    """``tree_spec`` (with and without a window), ``tree_ancestor_mask``
    and ``chain_parents`` equal the reference's; the spec's ``allow`` over
    the verify chunk reproduces the ancestor matrix with the committed
    context visible to every node and no context row seeing a node."""
    P = 6
    for kw in (dict(prefix_len=P), dict(prefix_len=P, window=3)):
        assert mk.tree_spec(parents, **kw).__dict__ \
            == rmk.tree_spec(parents, **kw).__dict__
    np.testing.assert_array_equal(mk.tree_ancestor_mask(parents),
                                  rmk.tree_ancestor_mask(parents))
    assert mk.chain_parents(len(parents)) == rmk.chain_parents(len(parents))
    K = len(parents)
    pos = torch.arange(P + K)
    m = mk.tree_spec(parents, prefix_len=P).allow(pos[:, None],
                                                  pos[None, :]).numpy()
    want = np.zeros((K, P + K), bool)
    want[:, :P] = True
    want[:, P:] = mk.tree_ancestor_mask(parents)
    np.testing.assert_array_equal(m[P:], want)
    assert not m[:P, P:].any()


@pytest.mark.parametrize("parents,match", [((-1, 0, 0), "chains and stars"),
                                           ((), "empty"),
                                           ((0, -1), "parent")])
def test_tree_spec_rejections_match_reference(parents, match):
    for tree_spec in (mk.tree_spec, rmk.tree_spec):
        with pytest.raises(ValueError, match=match):
            tree_spec(parents)


@pytest.mark.parametrize("kw", [dict(depth=-1), dict(mode="telepathy"),
                                dict(ngram=0), dict(adapt_window=0),
                                dict(adapt_floor=1.0),
                                dict(depth=2, min_depth=3)])
def test_spec_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        rspec.SpecConfig(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        spec.SpecConfig(**kw)


def test_make_draft_matches_reference():
    assert isinstance(spec.make_draft(spec.SpecConfig(mode="ngram")),
                      spec.NGramDraft)
    assert isinstance(spec.make_draft(spec.SpecConfig(mode="none")),
                      spec.NullDraft)
    with pytest.raises(ValueError, match="ModelDraft"):
        spec.make_draft(spec.SpecConfig(mode="model"))


def test_ngram_proposals_match_reference():
    """Seeded contexts over a tiny vocabulary (so n-grams recur), every
    n-gram length and budget: the proposals are the reference's."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        ctx = rng.integers(0, 4, int(rng.integers(1, 30))).astype(np.int32)
        req = types.SimpleNamespace(context=ctx)
        for n in (1, 2, 3):
            for k in (0, 1, 4):
                assert spec.NGramDraft(n).propose(req, k) \
                    == rspec.NGramDraft(n).propose(req, k)


# ==========================================================================
# DecoderLM.verify
# ==========================================================================

@pytest.mark.parametrize("arch,window", [("llama-7b", 0),
                                         ("smollm-360m", 0),
                                         ("llama-gqa", 6)])
def test_verify_matches_reference(arch, window):
    """Three requests at T = 5 with n_write 5, 2 and 0 (an idle row),
    fragmented tables over a pool that already holds context: logits to
    1e-4, and the pools after the writes (the null block aside)."""
    pr = pair(arch, window=window)
    a = pr.t_model.cfg.attn
    L, bs, N, T = pr.t_model.cfg.n_layers, 8, 24, 5
    shape = (L, N, bs, a.n_kv_heads, a.head_dim)
    rng = np.random.default_rng(1)
    pools = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k_pool", "v_pool")}
    table = np.array([[3, 7, 1, 5, 0, 0], [2, 9, 11, 4, 6, 0],
                      [0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.array([21, 35, 0], np.int32)
    n_write = np.array([5, 2, 0], np.int32)
    toks = rng.integers(0, pr.vocab, (3, T)).astype(np.int32)
    r_logits, r_out = pr.r_model.verify(
        pr.r_params, {**{k: jnp.asarray(v) for k, v in pools.items()},
                      "block_table": jnp.asarray(table)},
        {"tokens": jnp.asarray(toks), "pos": jnp.asarray(pos),
         "n_write": jnp.asarray(n_write)})
    t_pools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    t_logits = pr.t_model.verify(
        pr.t_params, {**t_pools, "block_table": torch.from_numpy(table)},
        torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(n_write))
    assert t_logits.shape == (3, T, pr.vocab)
    np.testing.assert_allclose(t_logits[:2].numpy(),
                               np.asarray(r_logits)[:2], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for k in pools:
        np.testing.assert_allclose(t_pools[k][:, 1:].numpy(),
                                   np.asarray(r_out[k])[:, 1:],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # request 1 writes positions 35 and 36 (block 6, offsets 3 and 4); its
    # rows past n_write = 2 go to the null block, not to offsets 5..7
    got, was = t_pools["k_pool"][:, 6].numpy(), pools["k_pool"][:, 6]
    assert (got[:, 3:5] != was[:, 3:5]).all()
    np.testing.assert_array_equal(got[:, :3], was[:, :3])
    np.testing.assert_array_equal(got[:, 5:], was[:, 5:])


def test_verify_t1_is_decode_bitwise():
    """verify at T = 1, n_write = 1 is the port's decode: the same logits
    and the same pools, bit for bit."""
    pr = pair("smollm-360m")
    m, a = pr.t_model, pr.t_model.cfg.attn
    shape = (m.cfg.n_layers, 16, 8, a.n_kv_heads, a.head_dim)
    gen = torch.Generator().manual_seed(0)
    base = {k: torch.randn(shape, generator=gen)
            for k in ("k_pool", "v_pool")}
    table = torch.tensor([[3, 7, 1, 0], [2, 9, 0, 0], [0, 0, 0, 0]],
                         dtype=torch.int32)
    tok = torch.tensor([[5], [17], [0]])
    pos = torch.tensor([19, 9, 0], dtype=torch.int32)
    c1 = {k: v.clone() for k, v in base.items()}
    c2 = {k: v.clone() for k, v in base.items()}
    d = m.decode(pr.t_params, {**c1, "block_table": table}, tok, pos)
    v = m.verify(pr.t_params, {**c2, "block_table": table}, tok, pos,
                 torch.ones(3, dtype=torch.int32))
    assert torch.equal(d, v)
    for k in base:
        assert torch.equal(c1[k], c2[k])


# ==========================================================================
# the speculating Engine against the reference's
# ==========================================================================

def _subs(vocab):
    """Greedy and sampled requests; the greedy streams of these seeded
    prompts repeat themselves, so n-gram drafts are accepted."""
    p = prompts(vocab, [12, 17, 9, 20], seed=3)
    p[0] = np.concatenate([p[0], p[0]])
    return [dict(prompt=p[0], max_new_tokens=16, temperature=0.0, seed=0),
            dict(prompt=p[1], max_new_tokens=6, temperature=0.8, seed=123),
            dict(prompt=p[2], max_new_tokens=16, temperature=0.0, seed=1),
            dict(prompt=p[3], max_new_tokens=5, temperature=0.8, seed=7)]


ENGINE = dict(max_batch=3, block_size=8, n_blocks=40, prefill_chunk_tokens=8)

CASES = {
    "depth0": dict(depth=0, mode="none"),
    "ngram2": dict(depth=2, mode="ngram"),
    "ngram4": dict(depth=4, mode="ngram", ngram=2),
    "adaptive": dict(depth=4, mode="ngram", adaptive=True, adapt_window=2,
                     adapt_floor=0.5),
}


@pytest.fixture(scope="module")
def target():
    return pair("llama-7b")


@pytest.fixture(scope="module")
def vanilla(target):
    """The reference's non-speculative streams of ``_subs``."""
    return drive(REngine, target.r_model, target.r_params,
                 _subs(target.vocab), stagger=1, **ENGINE)[2]


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_matches_reference(target, vanilla, case):
    """Streams equal the reference's token for token (and its vanilla
    streams), and so do the counters, ``spec_*`` and the depth histogram
    among them."""
    subs = _subs(target.vocab)
    r = drive(REngine, target.r_model, target.r_params, subs, stagger=1,
              spec=rspec.SpecConfig(**CASES[case]), **ENGINE)
    t = drive(Engine, target.t_model, target.t_params, subs, stagger=1,
              spec=spec.SpecConfig(**CASES[case]), **ENGINE)
    assert_same_run(*r, *t)
    for rid, s in t[2].items():
        np.testing.assert_array_equal(s, vanilla[rid])
    st = t[0].stats()
    if case != "depth0":
        assert st["spec_accepted"] > 0
    assert st["spec_depth_hist"] == r[0].stats()["spec_depth_hist"]


@pytest.mark.parametrize("draft", ["self", "smollm-wide"])
def test_model_draft_engine_matches_reference(target, vanilla, draft):
    """A ``ModelDraft``: the target's own weights (every greedy proposal
    accepted), or smoke smollm-360m with a vocabulary of 1024 against the
    target's 512, whose out-of-range proposals the target clamps as the
    reference's gather does and rejects.  Streams, counters and the draft
    pool's conservation equal the reference's."""
    subs = _subs(target.vocab)
    if draft == "self":
        d = target
    else:
        d = pair("smollm-360m", vocab=2 * target.vocab, seed=7)
    dkw = dict(block_size=8, n_blocks=48, max_batch=3)
    r_draft = rspec.ModelDraft(d.r_model, d.r_params, **dkw)
    t_draft = spec.ModelDraft(d.t_model, d.t_params, **dkw)
    seen = []
    propose = t_draft.propose

    def recording(req, k):
        out = propose(req, k)
        seen.extend(out)
        return out

    t_draft.propose = recording
    sc = dict(depth=3, mode="model")
    r = drive(REngine, target.r_model, target.r_params, subs, stagger=1,
              spec=rspec.SpecConfig(**sc), draft=r_draft, **ENGINE)
    t = drive(Engine, target.t_model, target.t_params, subs, stagger=1,
              spec=spec.SpecConfig(**sc), draft=t_draft, **ENGINE)
    assert_same_run(*r, *t)
    for rid, s in t[2].items():
        np.testing.assert_array_equal(s, vanilla[rid])
    if draft == "self":
        assert t[0].stats()["spec_accepted"] > 0
    else:
        assert max(seen) >= target.vocab, "no out-of-range proposal"
    assert not t_draft._slots
    t_draft.cache.allocator.check_conservation()
    assert t_draft.cache.allocator.n_free \
        == r_draft.cache.allocator.n_free == t_draft.cache.allocator.n_usable


@pytest.mark.parametrize("chunk,max_ctx", [(8, 40), (0, 37)])
def test_warm_prefill_count_matches_reference(target, chunk, max_ctx):
    """warm_prefill runs the reference's set of chunk shapes and touches
    no allocator state."""
    kw = dict(max_batch=2, block_size=8, n_blocks=24,
              prefill_chunk_tokens=chunk)
    r_eng = REngine(target.r_model, target.r_params, **kw)
    t_eng = Engine(target.t_model, target.t_params, **kw)
    n = t_eng.warm_prefill(max_ctx)
    assert n == r_eng.warm_prefill(max_ctx) > 1
    assert t_eng.cache.allocator.n_free == t_eng.cache.allocator.n_usable
    # the engine serves as before after the dummy chunks
    rid = t_eng.submit(prompts(target.vocab, [13])[0], max_new_tokens=3)
    r_rid = r_eng.submit(prompts(target.vocab, [13])[0], max_new_tokens=3)
    np.testing.assert_array_equal(t_eng.run()[rid], r_eng.run()[r_rid])
