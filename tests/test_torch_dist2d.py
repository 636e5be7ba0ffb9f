"""A dense decoder on a 2D sequence × head mesh: training and
``FixedSlotEngine`` in the port against the reference, on the CPU.

The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, seq, head)`` meshes: smoke ``llama-7b`` (4 query / 4 KV
heads: scatter mode) and ``llama-gqa`` (4 / 1: replicate mode) train 3
AdamW steps on (1, 2, 2) under balanced and on (1, 1, 4) under ring, and
``FixedSlotEngine`` serves ``llama-gqa`` on (1, 2, 2); it saves its
``DecoderLM.init`` weights for the port.  The port side is one 4-rank
``gloo`` world on ``make_seq2d_mesh`` (``tests/_torch_2d_cases.py``).
Bars: losses 5e-5 (ROADMAP item 1's distributed bar), tokens equal, last
logits within 1e-4 × max |logit|.

ROADMAP fault 3.6: the reference's model permutes the tokens for zigzag by
``zigzag_perm(T, r·u)`` where its 2D executor needs ``zigzag_perm(T, r)``,
so its 2D-zigzag loss is off its one-device loss; the port refuses zigzag
on a 2D mesh with u > 1.  The world and the reference process run under
time limits of their own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_2d_cases as C
from repro_torch.launch.world import spawn

LOSS_TOL = 5e-5
LOGIT_REL = 1e-4
FAULT_36 = 1e-2
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_2d_cases as C
from repro.core.config import (ShapeSpec, TrainConfig, get_config,
                               smoke_config)
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.optim import adamw
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import FixedSlotEngine
from repro.train.step import make_train_step
devs = np.array(jax.devices())
def mesh_of(d, r, u):
    return Mesh(devs[:d * r * u].reshape(d, r, u), ("data", "seq", "head"),
                axis_types=(AxisType.Auto,) * 3)
def flat(tree, prefix):
    return {{prefix + "/" + "/".join(str(getattr(k, "key", k))
                                   for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
shape = ShapeSpec("tt", C.TRAIN_T, C.TRAIN_B, "train")
out, saved, params = {{}}, {{}}, {{}}
for arch in C.ARCHS:
    cfg = smoke_config(get_config(arch))
    for m, sched in C.TRAIN_MESHES:
        mesh = mesh_of(*m)
        par = make_parallel_config(mesh, shape, schedule=sched)
        model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
        if arch not in params:
            params[arch] = model.init(jax.random.PRNGKey(0))
            saved.update(flat(params[arch], arch))
        step = jax.jit(make_train_step(model, TrainConfig(**C.TRAIN_TC)))
        p, opt = params[arch], adamw.init(params[arch])
        data = SyntheticTokens(cfg, shape, par, mesh)
        losses = []
        for i in range(C.TRAIN_STEPS):
            p, opt, met = step(p, opt, data.batch(i))
            losses.append(float(met["loss"]))
        out["%s/%s/%s" % (arch, C.mesh_name(m), sched)] = np.asarray(losses)
# fault 3.6: the first loss on one device and under 2D zigzag
cfg = smoke_config(get_config("llama-7b"))
for m, sched in (((1, 1, 1), "balanced"), ((1, 2, 2), "zigzag")):
    mesh = mesh_of(*m)
    par = make_parallel_config(mesh, shape, schedule=sched)
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
    out["first/%s/%s" % (C.mesh_name(m), sched)] = np.asarray(
        jax.jit(model.loss)(params["llama-7b"], batch)[0])
cfg = smoke_config(get_config("llama-gqa"))
mesh = mesh_of(*C.SERVE_MESH)
par = make_parallel_config(mesh, ShapeSpec("srv", C.T_PROMPT, C.TRAIN_B,
                                           "decode"))
model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
toks, logits = FixedSlotEngine(model, params["llama-gqa"]).generate(
    {{"tokens": jnp.asarray(C.prompts(cfg.vocab))}}, C.N_GEN)
out["serve/tokens"] = np.asarray(toks)
out["serve/logits"] = np.asarray(logits[:, -1], np.float32)
np.savez({params_path!r}, **saved)
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
    return spawn(C.model_world, 4, (reference[1],), device="cpu",
                 timeout=180)


TRAIN_CASES = [(a, m, s) for a in C.ARCHS for m, s in C.TRAIN_MESHES]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=[f"{a}-{C.mesh_name(m)}-{s}"
                              for a, m, s in TRAIN_CASES])
def test_training_on_a_2d_mesh_matches_reference(case, reference, world):
    arch, m, sched = case
    key = f"{arch}/{C.mesh_name(m)}/{sched}"
    want = reference[0][key]
    mode = "scatter" if arch == "llama-7b" else "replicate"
    for r in range(4):
        got = world[r][key]
        np.testing.assert_allclose(got["losses"], want, rtol=0,
                                   atol=LOSS_TOL)
        assert got["modes"] == [mode], got["modes"]
        assert got["seq_axes"] == ("seq", "head")
        assert (got["seq_size"], got["seq_rank"]) == (4, r)


def test_fixed_slot_engine_on_a_2d_mesh_matches_reference(reference,
                                                          world):
    ref = reference[0]
    for r in range(4):
        got = world[r]["serve"]
        assert got["shards"] == 4
        np.testing.assert_array_equal(got["tokens"], ref["serve/tokens"])
        want = ref["serve/logits"]
        err = float(np.abs(got["logits"] - want).max())
        assert err <= LOGIT_REL * float(np.abs(want).max()), err


def test_reference_2d_zigzag_is_off_and_the_port_refuses_it(reference,
                                                            world):
    """ROADMAP fault 3.6: the reference's 2D-zigzag loss is more than
    1e-2 off its one-device loss; the port raises and names the fault."""
    ref = reference[0]
    one, zz = ref["first/1x1x1/balanced"], ref["first/1x2x2/zigzag"]
    assert abs(float(zz) - float(one)) > FAULT_36, (zz, one)
    # the one-device loss is the 2D runs' first loss (fault only under
    # zigzag)
    assert abs(float(ref["llama-7b/1x2x2/balanced"][0]) - float(one)) \
        < LOSS_TOL
    for r in range(4):
        msg = world[r]["errors"]["zigzag"]
        assert msg.startswith("ValueError: zigzag on a 2D mesh"), msg
        assert "fault 3.6" in msg


def test_what_waits_on_a_2d_mesh_raises_naming_its_item(world):
    """Nothing waits on a 2D mesh any more: an MoE model (item 8.1,
    tests/test_torch_deepseek2d.py) and the paged Engine (item 8.2,
    tests/test_torch_engine2d.py) both build there, the Engine's pool
    sharded over the seq axis alone."""
    for r in range(4):
        err = world[r]["errors"]
        assert err["moe"] == "no error", err["moe"]
        assert err["engine"] == "no error", err["engine"]
        assert world[r]["engine_pool"] == ("blocks", 2), \
            world[r]["engine_pool"]
