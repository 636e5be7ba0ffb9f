"""The SSM and hybrid decoders — smoke mamba2-2.7b and zamba2-2.7b — on a
2D sequence × head mesh in the port against the reference, on the CPU:
the loss and every gradient leaf on (1, 2, 2) and (1, 1, 4), the gradient
norm, zigzag (which falls back to balanced), and the prefill and the
recurrent decode on (1, 4) and (1, 2, 2).

The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, seq, head)`` meshes (ROADMAP fault 3.1): its
``ssm_apply`` relays the state over ``seq`` alone, each head rank
repeating its seq shard's rows.  The port relays over all r·u ranks of
the pair in sequence order, each rank scanning its own rows — the same
function of the sequence, which these bars hold.  Its prefill and decode
are the reference's one-device runs (a function of the prompt alone),
the decode fed the reference's greedy stream.  The port side is one
4-rank ``gloo`` world (``tests/_torch_ssm2d_cases.py``).

Bars: the distributed bars of ROADMAP item 1 — loss and logits 2e-5,
every gradient leaf 5e-5, the gradient norm 5e-5 of its size.  The SSM
leaves summed over ``head`` once more (each counted u times) must miss
the gradient bar.  The world and the reference process run under time
limits of their own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ssm2d_cases as C
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import load_reference_params

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_ssm2d_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens, cache_specs
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
devs = np.array(jax.devices())
def mesh_of(m):
    names = ("data", "model") if len(m) == 2 else ("data", "seq", "head")
    n = int(np.prod(m))
    return Mesh(devs[:n].reshape(m), names,
                axis_types=(AxisType.Auto,) * len(m))
def flat(tree, prefix):
    return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
shape = ShapeSpec("tt", C.T, C.B, "train")
out = {{}}
for arch in C.ARCHS:
    cfg = smoke_config(get_config(arch))
    one = mesh_of((1, 1))
    model = build_model(cfg, Runtime(mesh=one, par=make_parallel_config(
        one, shape), impl="ref"))
    params = model.init(jax.random.PRNGKey(0))
    np.savez({params_dir!r} + "/" + arch + ".npz", **flat(params, ""))
    for case in C.TRAIN:
        m, sched = case
        mesh = mesh_of(m)
        par = make_parallel_config(mesh, shape, schedule=sched,
                                   remat="none")
        model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
        batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
        (loss, met), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, batch)
        key = arch + "/" + C.train_name(case) + "/"
        out[key + "loss"] = np.asarray(loss)
        out.update(flat(grads, key + "g/"))
    dshape = ShapeSpec("dec", C.T_PROMPT + C.N_GEN, C.B, "decode")
    par = make_parallel_config(one, dshape)
    model = build_model(cfg, Runtime(mesh=one, par=par, impl="ref"))
    toks = jnp.asarray(C.prompts(cfg.vocab))
    lg, cache = jax.jit(model.prefill)(params, {{"tokens": toks}})
    out[arch + "/prefill"] = np.asarray(lg)
    specs, _ = cache_specs(cfg, dshape, par)
    cache = {{k: jnp.zeros(s.shape, s.dtype) for k, s in specs.items()}}
    dec = jax.jit(model.decode)
    rows, stream, tok = [], [np.asarray(toks)], None
    for t in range(C.T_PROMPT + C.N_GEN):
        if t >= C.T_PROMPT:
            stream.append(np.asarray(tok)[:, None])
        cur = toks[:, t:t + 1] if t < C.T_PROMPT else tok[:, None]
        lg, cache = dec(params, cache, {{"token": cur,
                                        "pos": jnp.full((C.B,), t,
                                                        jnp.int32)}})
        rows.append(np.asarray(lg[:, 0].astype(jnp.float32)))
        tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
    out[arch + "/decode"] = np.stack(rows)
    out[arch + "/stream"] = np.concatenate(stream, axis=1)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    path = str(tmp / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            tests=TESTS, path=path, params_dir=str(tmp))],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), str(tmp)


@pytest.fixture(scope="module")
def world(reference):
    streams = {a: reference[0][f"{a}/stream"] for a in C.ARCHS}
    return spawn(C.world, C.WORLD, (reference[1], streams), device="cpu",
                 timeout=180)


def _ref_grads(ref, arch, key):
    """The reference's gradients of case ``key`` in the port's leaf
    order."""
    pre = f"{arch}/{key}/g/"
    tree = {}
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    cfg = smoke_config(get_config(arch))
    return [t.numpy() for t in leaves(load_reference_params(cfg, tree,
                                                            "cpu"))]


def _worst(grads, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(grads, want))


CASES = [(a, c) for a in C.ARCHS for c in C.TRAIN]


@pytest.mark.parametrize("arch,case", CASES,
                         ids=[f"{a}-{C.train_name(c)}" for a, c in CASES])
def test_loss_and_grads_on_a_2d_mesh_match_reference(arch, case, reference,
                                                     world):
    """Every rank's loss within 2e-5 of the reference's on the same mesh
    and every summed gradient leaf within 5e-5 (the SSM leaves each one
    rank's share, summed once over the pair; zamba2's shared block through
    the 2D plan); the gradient norm within 5e-5 of its size.  Each rank
    scans T/4 = 32 rows and relays over all 4 ranks."""
    ref = reference[0]
    key = C.train_name(case)
    want = _ref_grads(ref, arch, key)
    gnorm = float(np.sqrt(sum(float(np.square(w.astype(np.float64)).sum())
                              for w in want)))
    for r in world:
        got = r[f"{arch}/{key}"]
        assert (got["cols"], got["group"]) == (C.T // C.WORLD, C.WORLD)
        assert abs(got["loss"] - float(ref[f"{arch}/{key}/loss"])) \
            <= FWD_TOL, (got["loss"], float(ref[f"{arch}/{key}/loss"]))
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            assert g.shape == w.shape
        assert _worst(got["grads"], want) <= GRAD_TOL, \
            _worst(got["grads"], want)
        assert abs(got["gnorm"] - gnorm) <= GRAD_TOL * gnorm


@pytest.mark.parametrize("arch,case", CASES,
                         ids=[f"{a}-{C.train_name(c)}" for a, c in CASES])
def test_ssm_leaves_counted_twice_over_head_miss_the_bar(arch, case,
                                                         reference, world):
    """The SSM leaves summed over ``head`` once more — each counted u = 2
    or 4 times, what replicating a seq shard's scan on its head ranks and
    summing every leaf over the pair would give — miss the gradient bar."""
    want = _ref_grads(reference[0], arch, C.train_name(case))
    for r in world:
        got = r[f"{arch}/{C.train_name(case)}"]
        assert got["n_ssm"] > 0
        assert _worst(got["twice"], want) > GRAD_TOL


@pytest.mark.parametrize("arch", C.ARCHS)
def test_zigzag_on_a_2d_mesh_falls_back_to_balanced(arch, reference, world):
    """zigzag on (1, 2, 2) is accepted (these families' tokens stay
    contiguous, fault 3.6 is a dense one) and gives the reference's
    balanced loss and gradients on that mesh."""
    key = C.train_name(C.TRAIN[0])
    want = _ref_grads(reference[0], arch, key)
    for r in world:
        got = r[f"{arch}/{C.train_name(C.ZIGZAG)}"]
        assert got["cols"] == C.T // C.WORLD
        assert abs(got["loss"] - float(reference[0][f"{arch}/{key}/loss"])) \
            <= FWD_TOL
        assert _worst(got["grads"], want) <= GRAD_TOL


@pytest.mark.parametrize("arch", C.ARCHS)
@pytest.mark.parametrize("mesh", C.SERVE_MESHES, ids=C.mesh_name)
def test_prefill_and_decode_across_ranks_match_reference(arch, mesh,
                                                         reference, world):
    """The prefill's last logits on 4 ranks, and every recurrent decode
    step's logits over the reference's greedy stream (the hybrid's shared
    K/V sharded over the 4 ranks), within 2e-5 of the reference's."""
    ref = reference[0]
    for r in world:
        got = r[f"{arch}/serve/{C.mesh_name(mesh)}"]
        np.testing.assert_allclose(got["prefill"], ref[f"{arch}/prefill"],
                                   atol=FWD_TOL)
        np.testing.assert_allclose(got["decode"], ref[f"{arch}/decode"],
                                   atol=FWD_TOL)
        if arch == "zamba2-2.7b":
            S = (C.T_PROMPT + C.N_GEN) // C.WORLD
            assert got["shared"]["shared_k"][2] == S
