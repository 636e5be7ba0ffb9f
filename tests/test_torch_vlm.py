"""The vision-language model — smoke internvl2-2b, 16 image positions
before the text — in the port against the reference, on the CPU: the
synthetic batch and its shards, the loss and every gradient leaf at one
rank and at 4 under balanced and zigzag (the zigzag permutation of the
concatenated sequence), ``FixedSlotEngine``'s tokens and logits at one
rank and at 4, the paged ``Engine``'s refusal, and the weights' round
trip.

The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, model)`` meshes; it saves its ``DecoderLM.init``
weights for the port.  The port's 4-rank cases run in one ``gloo`` world
(``tests/_torch_vlm_cases.py``), its one-rank cases in this process.
Bars: the distributed bars of ROADMAP item 1 — loss 2e-5, every gradient
leaf 5e-5; serving tokens equal, last logits within 1e-4 × max |logit|.
The image labels left unmasked must miss the loss bar.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_vlm_cases as C
from _torch_dist_cases import load_tree
from repro_torch.core.config import ShapeSpec, get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import (DecoderLM,
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
import _torch_vlm_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens
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
mesh = mesh_of(1)
par = make_parallel_config(mesh, ShapeSpec("srv", C.T_PROMPT, C.B, "decode"))
model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
sb = {{k: jnp.asarray(v) for k, v in C.serve_batch(cfg).items()}}
t, lg = FixedSlotEngine(model, params).generate(sb, C.N_GEN)
out["serve/tokens"] = np.asarray(t)
out["serve/logits"] = np.asarray(lg[:, -1], np.float32)
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


def _held(got, ref, key):
    assert abs(got["loss"] - float(ref[f"{key}/loss"])) <= FWD_TOL, \
        (got["loss"], float(ref[f"{key}/loss"]))
    want = _ref_grads(ref, key)
    assert len(got["grads"]) == len(want)
    for g, w in zip(got["grads"], want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=GRAD_TOL)


def _one_rank(reference):
    cfg = _cfg()
    model = DecoderLM(cfg, "cpu")
    params = trainable(load_reference_params(cfg, load_tree(reference[1]),
                                             "cpu"))
    batch = SyntheticTokens(cfg, ShapeSpec("tt", C.T, C.B, "train"),
                            device="cpu").batch(0)
    return model, params, batch


def test_batch_matches_reference(reference):
    """One rank's batch is the reference's: tokens and labels (B, 48) of
    the text, and the 16 image rows ``default_rng(step)`` draws."""
    ref = reference[0]
    _, _, batch = _one_rank(reference)
    cfg = _cfg()
    assert batch["tokens"].shape == (C.B, C.T - cfg.n_image_tokens)
    assert batch["image_embeds"].shape == (C.B, cfg.n_image_tokens,
                                           cfg.d_model)
    for k, v in batch.items():
        np.testing.assert_array_equal(v.float().numpy(), ref[f"batch/{k}"])


def test_one_rank_loss_and_grads_match_reference(reference):
    """One rank: the loss (the image positions' labels −100) within 2e-5
    and every gradient leaf within 5e-5 of the reference's."""
    _held(C.train_one(*_one_rank(reference)), reference[0], "1/balanced")


def test_unmasked_image_labels_miss_the_loss_bar(reference, world):
    """The planted fault — the image positions labelled with token 0
    instead of −100 — moves the loss beyond 2e-5, at one rank and on
    every rank of both 4-rank layouts."""
    ref = reference[0]
    model, params, batch = _one_rank(reference)
    bad = float(C.unmasked(model).loss(params, batch)[0].detach())
    assert abs(bad - float(ref["1/balanced/loss"])) > 100 * FWD_TOL
    for r in world:
        for sched in ("balanced", "zigzag"):
            got = r[f"4/{sched}"]["unmasked"]
            assert abs(got - float(ref[f"4/{sched}/loss"])) > 100 * FWD_TOL


@pytest.mark.parametrize("sched", ["balanced", "zigzag"])
def test_four_ranks_loss_and_grads_match_reference(sched, reference, world):
    """4 ranks: every rank's loss within 2e-5 of the reference's on the
    same mesh and schedule and every summed gradient leaf within 5e-5; a
    rank holds its columns of the concatenated (image, text) sequence —
    zigzag's two mirror chunks — its image rows their prefix."""
    ref = reference[0]
    img = ref["batch/image_embeds"]
    toks = ref["batch/tokens"]
    n = _cfg().n_image_tokens
    for r in world:
        got = r[f"4/{sched}"]
        _held(got, ref, f"4/{sched}")
        cols = got["cols"]
        k = int((cols < n).sum())
        assert (cols[:k] < n).all() and (cols[k:] >= n).all()
        np.testing.assert_array_equal(got["batch"]["image_embeds"],
                                      img[:, cols[:k]])
        np.testing.assert_array_equal(got["batch"]["tokens"],
                                      toks[:, cols[k:] - n])
        np.testing.assert_array_equal(got["batch"]["labels"],
                                      ref["batch/labels"][:, cols[k:] - n])
    held = np.concatenate([r[f"4/{sched}"]["cols"] for r in world])
    assert sorted(held) == list(range(C.T))


def test_fixed_slot_engine_matches_reference(reference, world):
    """``FixedSlotEngine`` on the image rows and 32-token prompts: its
    greedy tokens equal the reference's and its last logits are within
    1e-4 × max |logit|, at one rank and on every rank of 4 (S0 = 48, the
    image rows counted)."""
    ref = reference[0]
    cfg = _cfg()
    model = DecoderLM(cfg, "cpu")
    params = load_reference_params(cfg, load_tree(reference[1]), "cpu")
    toks, logits = FixedSlotEngine(model, params).generate(
        C.serve_batch(cfg), C.N_GEN)
    runs = [dict(tokens=toks.numpy(), logits=logits[:, -1].numpy())] + \
        [r["serve"] for r in world]
    want = ref["serve/logits"]
    for got in runs:
        np.testing.assert_array_equal(got["tokens"], ref["serve/tokens"])
        err = float(np.abs(got["logits"] - want).max())
        assert err <= LOGIT_REL * float(np.abs(want).max()), err


def test_paged_engine_refuses_with_reference_message(reference):
    """The paged ``Engine`` refuses the VLM with the reference's words."""
    cfg = _cfg()
    model = DecoderLM(cfg, "cpu")
    with pytest.raises(ValueError) as e:
        Engine(model, model.init(0))
    assert str(e.value) == str(reference[0]["engine/error"])


def test_weights_round_trip(reference):
    """``load_reference_params`` then ``to_reference_params`` gives the
    reference's tree back, leaf for leaf and bit for bit."""
    tree = load_tree(reference[1])
    back = to_reference_params(load_reference_params(_cfg(), tree, "cpu"))

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + "/" + k)
            else:
                np.testing.assert_array_equal(b[k].numpy(), a[k])
    walk(tree, back)
