"""DeepSeek-V2-Lite (MLA + MoE) on a 2D sequence × head mesh: training and
``FixedSlotEngine`` in the port against the reference, on the CPU.

The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, seq, head)`` meshes: the smoke deepseek config's
``model.loss`` value and gradients (T 64, B 2) on (1, 2, 2) under balanced
at capacity factors 4.0 and 0.5 and on (1, 1, 4) under ring;
``FixedSlotEngine`` on (1, 2, 2); and the latent ring's prefill on
(1, 2, 2), which raises (ROADMAP fault 3.7).  It saves its
``DecoderLM.init`` weights for the port.  The port side is one 4-rank
``gloo`` world (``tests/_torch_deepseek2d_cases.py``): the routed experts
shard over ``seq`` alone, each head rank gathers its seq shard's MoE rows,
and the aux statistics reduce over ``seq``, as the reference's
``shard_map`` over ``P(b, seq_axis, None)``.

Bars: the distributed bars of ROADMAP item 1 — loss, ce and aux 2e-5,
every gradient leaf 5e-5 — and the gradient norm 5e-5 of its size;
serving tokens equal, last logits within 1e-4 × max |logit|.  The expert
shards' gradients summed over ``head`` not at all or twice, and the aux
statistics reduced over ``head`` as well, must each miss a bar.  The world
and the reference process run under time limits of their own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_deepseek2d_cases as C
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import load_reference_params

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
import _torch_deepseek2d_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import FixedSlotEngine
devs = np.array(jax.devices())
def mesh_of(d, r, u):
    return Mesh(devs[:d * r * u].reshape(d, r, u), ("data", "seq", "head"),
                axis_types=(AxisType.Auto,) * 3)
def flat(tree, prefix):
    return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
base = smoke_config(get_config(C.ARCH))
shape = ShapeSpec("tt", C.T, C.B, "train")
out, params = {{}}, None
for case in C.TRAIN:
    m, sched, cf = case
    mesh = mesh_of(*m)
    cfg = C.with_capacity(base, cf)
    par = make_parallel_config(mesh, shape, schedule=sched, remat="none")
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    if params is None:
        params = model.init(jax.random.PRNGKey(0))
        np.savez({params_path!r}, **flat(params, ""))
    batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    key = C.train_name(case) + "/"
    out[key + "loss"] = np.asarray(loss)
    for k in ("ce", "aux"):
        out[key + k] = np.asarray(met[k])
    out.update(flat(grads, key + "g/"))
mesh = mesh_of(*C.SERVE_MESH)
toks = jnp.asarray(C.prompts(base.vocab))
par = make_parallel_config(mesh, ShapeSpec("srv", C.T_PROMPT, C.B, "decode"))
model = build_model(base, Runtime(mesh=mesh, par=par, impl="ref"))
t, lg = FixedSlotEngine(model, params).generate({{"tokens": toks}}, C.N_GEN)
out["serve/tokens"] = np.asarray(t)
out["serve/logits"] = np.asarray(lg[:, -1], np.float32)
# the latent ring's prefill on the 2D mesh (ROADMAP fault 3.7)
zz = make_parallel_config(mesh, ShapeSpec("srv", C.T_PROMPT, C.B, "decode"),
                          schedule="zigzag")
model = build_model(base, Runtime(mesh=mesh, par=zz, impl="ref",
                                  latent_ring=True))
try:
    model.prefill(params, {{"tokens": toks}})
    out["ring/error"] = np.asarray("no error")
except Exception as e:
    out["ring/error"] = np.asarray(type(e).__name__ + ": " + str(e))
np.savez({path!r}, **out)
"""


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
    return spawn(C.world, 4, (reference[1],), device="cpu", timeout=180)


def _ref_grads(ref, key):
    """The reference's gradients of case ``key`` in the port's leaf
    order."""
    tree = {}
    pre = key + "/g/"
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    cfg = smoke_config(get_config(C.ARCH))
    return [t.numpy() for t in leaves(load_reference_params(cfg, tree,
                                                            "cpu"))]


def _worst(grads, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(grads, want))


def _worst_rel(grads, want):
    """The worst leaf's max |Δg| over its max |g|."""
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                1e-30)
               for g, w in zip(grads, want))


CASES = [C.train_name(c) for c in C.TRAIN]


@pytest.mark.parametrize("key", CASES)
def test_loss_and_grads_on_a_2d_mesh_match_reference(key, reference,
                                                     world):
    """Every rank's loss, ce and aux within 2e-5 of the reference's on the
    same mesh, and every gradient leaf (replicated leaves summed over the
    world, expert shards over ``head`` and gathered over ``seq``) within
    5e-5; the gradient norm counts each expert once (5e-5 of its size
    from the reference's gradient tree)."""
    ref = reference[0]
    want = _ref_grads(ref, key)
    gnorm = float(np.sqrt(sum(float(np.square(w.astype(np.float64)).sum())
                              for w in want)))
    for r in world:
        got = r[key]
        for k in ("loss", "ce", "aux"):
            assert abs(got[k] - float(ref[f"{key}/{k}"])) <= FWD_TOL, \
                (k, got[k], float(ref[f"{key}/{k}"]))
        assert got["aux"] > 0
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            assert g.shape == w.shape
        assert _worst(got["grads"], want) <= GRAD_TOL
        assert abs(got["gnorm"] - gnorm) <= GRAD_TOL * gnorm


def test_expert_and_row_groups_on_a_2d_mesh(world):
    """(2, 2): experts over seq (2 ranks), rows over head (2), expert
    gradients summed over head (2), aux statistics over seq (2); (1, 4):
    experts whole on every rank, rows over the 4 head ranks."""
    for r in world:
        for key in CASES[:2]:
            assert r[key]["groups"] == (2, 2, 2, 2), r[key]["groups"]
        assert r[CASES[2]]["groups"] == (None, 4, None, 1), \
            r[CASES[2]]["groups"]


@pytest.mark.parametrize("wrong", ["none", "twice"])
def test_expert_grads_summed_over_head_once(wrong, reference, world):
    """The routed experts' gradient shards summed over ``head`` not at all,
    or twice, miss the gradient bar, an expert leaf by half or all of its
    size (every case with a head sum)."""
    for key in CASES[:2]:
        want = _ref_grads(reference[0], key)
        for r in world:
            got = r[key]["wrong_sums"][wrong]
            assert _worst(got, want) > GRAD_TOL
            assert _worst_rel(got, want) > 0.4


def test_aux_statistics_reduced_over_head_miss_the_gradient_bar(reference,
                                                                world):
    """The aux loss's statistics reduced over ``head`` as well keep the
    loss (each head rank holds the same rows) but halve the aux loss's
    gradient, which the gradient bar rejects."""
    for key in CASES[:2]:
        ref = reference[0]
        want = _ref_grads(ref, key)
        for r in world:
            wrong = r[key]["aux_over_head"]
            assert abs(wrong["loss"] - float(ref[f"{key}/loss"])) <= FWD_TOL
            assert _worst(wrong["grads"], want) > GRAD_TOL, \
                _worst(wrong["grads"], want)


def test_fixed_slot_engine_on_a_2d_mesh_matches_reference(reference,
                                                          world):
    """(1, 2, 2): the whole-prompt prefill under the head scatter, the
    ``{"ckv"}`` cache sharded over the (seq, head) pair, the decode MoE
    summed over ``seq``: greedy tokens equal the reference's, last logits
    within 1e-4 × max |logit|."""
    ref = reference[0]
    for r in world:
        got = r["serve"]
        assert got["shards"] == 4
        np.testing.assert_array_equal(got["tokens"], ref["serve/tokens"])
        want = ref["serve/logits"]
        err = float(np.abs(got["logits"] - want).max())
        assert err <= LOGIT_REL * float(np.abs(want).max()), err


def test_latent_ring_on_a_2d_mesh_is_fault_37(reference, world):
    """ROADMAP fault 3.7: the reference's latent-ring prefill on (1, 2, 2)
    raises (its zigzag plan for r·u = 4 ranks runs over the seq axis's 2);
    the port refuses it, in ``DecoderLM`` and in
    ``dist_attn_fwd_latent``, naming the fault."""
    msg = str(reference[0]["ring/error"])
    assert msg.startswith("ValueError: ppermute sources and destinations"), \
        msg
    for r in world:
        for where, err in r["latent_ring"].items():
            assert err.startswith("ValueError: the latent ring on a 2D "
                                  "mesh"), (where, err)
            assert "fault 3.7" in err
