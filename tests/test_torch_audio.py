"""The encoder–decoder — smoke whisper-tiny — in the port's ``EncDecLM``
against the reference's, on the CPU: the synthetic batch, ``encode``,
the loss and every gradient leaf under ``remat_aware``, ``hf`` and
``none`` at one rank and at 4 (and zigzag, which falls back to
balanced), the prefill's logits and cache, ``FixedSlotEngine``'s tokens
and logits at one rank and at 4, the decode cache's shapes, the paged
``Engine``'s refusal, and the weights' round trip.

The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, model)`` meshes; it saves its ``EncDecLM.init``
weights for the port.  The port's 4-rank cases run in one ``gloo`` world
(``tests/_torch_audio_cases.py``), its one-rank cases in this process.
Bars: ROADMAP item 1's — the encoder output, the loss and the logits
2e-5, every gradient leaf 5e-5; serving tokens equal, last logits within
1e-4 × max |logit|.  Two planted faults must miss them: a causal mask on
the cross-attention, and the encoder's gradients summed over the
sequence ranks twice.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_audio_cases as C
from _torch_dist_cases import load_tree
from repro_torch.core import mask as mk
from repro_torch.core.config import (ParallelConfig, ShapeSpec, get_config,
                                     smoke_config)
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticTokens, audio_cache_shapes
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import (EncDecLM, build_model,
                                            load_reference_params,
                                            to_reference_params, trainable)
from repro_torch.serve.engine import Engine, FixedSlotEngine

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
LOGIT_REL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_audio_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens, cache_specs
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine, FixedSlotEngine
devs = np.array(jax.devices())
def mesh_of(P):
    return Mesh(devs[:P].reshape(1, P), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
def flat(tree, prefix):
    return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
cfg = smoke_config(get_config(C.ARCH))
shape = ShapeSpec("tt", C.T, C.B, "train")
out, params = {{}}, None
for case in C.TRAIN:
    P, sched = case
    mesh = mesh_of(P)
    par = make_parallel_config(mesh, shape, schedule=sched, remat="none")
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    if params is None:
        params = model.init(jax.random.PRNGKey(0))
        np.savez({params_path!r}, **flat(params, ""))
    batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    key = C.case_name(case) + "/"
    out[key + "loss"] = np.asarray(loss)
    out.update(flat(grads, key + "g/"))
    if P == 1:
        for k, v in batch.items():
            out["batch/" + k] = np.asarray(v.astype(jnp.float32))
        out["encode"] = np.asarray(jax.jit(model.encode)(params,
                                                         batch["frames"]))
mesh = mesh_of(1)
dshape = ShapeSpec("srv", C.T_PROMPT, C.B, "decode")
par = make_parallel_config(mesh, dshape)
model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
sb = {{k: jnp.asarray(v) for k, v in C.serve_batch(cfg).items()}}
lg, cache = jax.jit(model.prefill)(params, sb)
out["prefill/logits"] = np.asarray(lg)
for k, v in cache.items():
    out["prefill/" + k] = np.asarray(v)
t, lg = FixedSlotEngine(model, params).generate(sb, C.N_GEN)
out["serve/tokens"] = np.asarray(t)
out["serve/logits"] = np.asarray(lg[:, -1], np.float32)
specs, _ = cache_specs(cfg, dshape, par)
for k, s in specs.items():
    out["cache/" + k] = np.asarray(s.shape)
    out["cache_dtype/" + k] = np.asarray(str(s.dtype))
try:
    Engine(model, params)
    out["engine/error"] = np.asarray("no error")
except ValueError as e:
    out["engine/error"] = np.asarray(str(e))
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    path, params_path = str(tmp / "ref.npz"), str(tmp / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            tests=TESTS, path=path, params_path=params_path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), params_path


@pytest.fixture(scope="module")
def world(reference):
    return spawn(C.world, C.WORLD, (reference[1],), device="cpu",
                 timeout=150)


def _cfg():
    return smoke_config(get_config(C.ARCH))


def _params(reference, train=False):
    p = load_reference_params(_cfg(), load_tree(reference[1]), "cpu")
    return trainable(p) if train else p


def _batch():
    return SyntheticTokens(_cfg(), ShapeSpec("tt", C.T, C.B, "train"),
                           device="cpu").batch(0)


def _ref_grads(ref, key):
    pre = key + "/g/"
    tree = {}
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return [t.numpy() for t in leaves(load_reference_params(_cfg(), tree,
                                                            "cpu"))]


def _worst(grads, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(grads, want))


def _held(got, ref, key):
    assert abs(got["loss"] - float(ref[f"{key}/loss"])) <= FWD_TOL, \
        (got["loss"], float(ref[f"{key}/loss"]))
    want = _ref_grads(ref, key)
    assert len(got["grads"]) == len(want)
    for g, w in zip(got["grads"], want):
        assert g.shape == w.shape
    assert _worst(got["grads"], want) <= GRAD_TOL, _worst(got["grads"], want)


def test_batch_and_encode_match_reference(reference):
    """One rank's batch is the reference's (tokens and labels (B, 64), the
    frames ``default_rng(step)`` draws), and ``encode`` of its frames —
    non-causal attention at Tq = Tk = 64, then ``ln_enc`` — is within
    2e-5 of the reference's."""
    ref = reference[0]
    batch = _batch()
    assert batch["frames"].shape == (C.B, _cfg().n_audio_frames,
                                     _cfg().d_model)
    for k, v in batch.items():
        np.testing.assert_array_equal(v.float().numpy(), ref[f"batch/{k}"])
    model = EncDecLM(_cfg(), "cpu")
    with torch.no_grad():
        enc = model.encode(_params(reference), batch["frames"])
    np.testing.assert_allclose(enc.numpy(), ref["encode"], atol=FWD_TOL)


@pytest.mark.parametrize("policy", C.POLICIES)
def test_one_rank_loss_and_grads_match_reference(policy, reference):
    """One rank under each checkpoint policy (``remat_aware``: two
    remat-aware sub-layers a decoder layer, the cross one passing its
    gradient to the encoder output): the loss within 2e-5 and every
    gradient leaf within 5e-5 of the reference's."""
    model = EncDecLM(_cfg(), "cpu", par=ParallelConfig(remat=policy))
    _held(C.train_one(model, _params(reference, True), _batch()),
          reference[0], "1/balanced")


def test_causal_cross_attention_misses_the_bars(reference):
    """The planted fault — a causal mask on the cross-attention (query t
    sees frames 0..t) — moves the loss beyond 2e-5."""
    model = EncDecLM(_cfg(), "cpu")
    model.cross_mask = mk.causal()
    loss = float(model.loss(_params(reference), _batch())[0])
    assert abs(loss - float(reference[0]["1/balanced/loss"])) \
        > 100 * FWD_TOL


@pytest.mark.parametrize("run", [f"balanced/{p}" for p in C.POLICIES]
                         + ["zigzag/remat_aware"])
def test_four_ranks_loss_and_grads_match_reference(run, reference, world):
    """4 ranks of 16 decoder tokens, each with the whole clip's frames
    (the encoder run whole on every rank): every rank's loss within 2e-5
    of the reference's and every summed gradient leaf within 5e-5 — the
    encoder's and the cross ``wk`` / ``wv``'s shares summed over the ranks
    once; zigzag falls back to balanced (contiguous columns)."""
    ref = reference[0]
    for r in world:
        got = r[run]
        _held(got, ref, "4/balanced")
        cols = got["cols"]
        assert len(cols) == C.T // C.WORLD
        assert (np.diff(cols) == 1).all()
        np.testing.assert_array_equal(got["batch"]["frames"],
                                      ref["batch/frames"])
        np.testing.assert_array_equal(got["batch"]["tokens"],
                                      ref["batch/tokens"][:, cols])


def test_encoder_grads_summed_twice_miss_the_bar(reference, world):
    """The planted fault — the encoder's gradients summed over the 4
    sequence ranks once more — misses the gradient bar."""
    want = _ref_grads(reference[0], "4/balanced")
    for r in world:
        assert _worst(r["balanced/remat_aware"]["twice"], want) > GRAD_TOL


def test_prefill_matches_reference(reference):
    """The prefill's last logits and its cache — ``k`` / ``v`` of the
    prompt, ``ek`` / ``ev`` of the frames, a layer each — within 2e-5 of
    the reference's."""
    ref = reference[0]
    model = EncDecLM(_cfg(), "cpu")
    sb = C.serve_batch(_cfg())
    logits, cache = model.prefill(_params(reference), sb["tokens"],
                                  sb["frames"])
    np.testing.assert_allclose(logits.numpy(), ref["prefill/logits"],
                               atol=FWD_TOL)
    assert set(cache) == {"k", "v", "ek", "ev"}
    for k, v in cache.items():
        np.testing.assert_allclose(v.numpy(), ref[f"prefill/{k}"],
                                   atol=FWD_TOL)


def test_fixed_slot_engine_matches_reference(reference, world):
    """``FixedSlotEngine`` on the frames and 32-token prompts (the decode's
    cross-attention at Tq = 1 against the frames): greedy tokens equal the
    reference's, last logits within 1e-4 × max |logit|, at one rank and on
    every rank of 4; there ``pad_cache`` pads ``k`` / ``v`` to 40 slots
    (38 rounded up over the shards), 10 a rank, and leaves ``ek`` / ``ev``
    whole."""
    ref = reference[0]
    cfg = _cfg()
    model = build_model(cfg, "cpu")
    toks, logits = FixedSlotEngine(model, _params(reference)).generate(
        C.serve_batch(cfg), C.N_GEN)
    runs = [dict(tokens=toks.numpy(), logits=logits[:, -1].numpy())] + \
        [r["serve"] for r in world]
    want = ref["serve/logits"]
    for got in runs:
        np.testing.assert_array_equal(got["tokens"], ref["serve/tokens"])
        err = float(np.abs(got["logits"] - want).max())
        assert err <= LOGIT_REL * float(np.abs(want).max()), err
    a = cfg.attn
    for r in world:
        sh = r["serve"]["shapes"]
        assert sh["k"][2] == -(-(C.T_PROMPT + C.N_GEN) // C.WORLD)
        assert sh["ek"] == (cfg.n_layers, C.B, cfg.n_audio_frames,
                            a.n_heads, a.head_dim)
        assert r["serve"]["ek_same"]


def test_cache_shapes_match_cache_specs(reference):
    """``audio_cache_shapes`` gives the reference's ``cache_specs`` arm:
    ``k`` / ``v`` over the sequence, ``ek`` / ``ev`` over the frames, in
    the model's dtype."""
    ref = reference[0]
    got = audio_cache_shapes(_cfg(), C.B, C.T_PROMPT)
    assert set(got) == {k.split("/")[1] for k in ref
                        if k.startswith("cache/")}
    for k, (shape, dt) in got.items():
        assert list(shape) == list(ref[f"cache/{k}"]), k
        assert str(dt)[6:] == str(ref[f"cache_dtype/{k}"]), k


def test_paged_engine_refuses_with_reference_message(reference):
    """The paged ``Engine`` refuses the encoder–decoder with the
    reference's words."""
    model = EncDecLM(_cfg(), "cpu")
    with pytest.raises(ValueError) as e:
        Engine(model, model.init(0))
    assert str(e.value) == str(reference[0]["engine/error"])


def test_weights_round_trip(reference):
    """``load_reference_params`` then ``to_reference_params`` gives the
    reference's tree back — ``enc_layers``, ``dec_layers`` with their
    ``cross`` blocks, ``ln_enc``, ``ln_f`` — leaf for leaf and bit for
    bit, and a port init has the same tree."""
    tree = load_tree(reference[1])
    back = to_reference_params(load_reference_params(_cfg(), tree, "cpu"))
    mine = to_reference_params(EncDecLM(_cfg(), "cpu").init(0))

    def walk(a, b, c, path=""):
        assert set(a) == set(b) == set(c), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], c[k], path + "/" + k)
            else:
                np.testing.assert_array_equal(b[k].numpy(), a[k])
                assert tuple(c[k].shape) == a[k].shape, path + "/" + k
    walk(tree, back, mine)
