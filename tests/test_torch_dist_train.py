"""Training across ranks: the port's smoke ``llama-gqa`` on 8-rank ``gloo``
worlds against the reference and against the port's own single process.

The reference side is one JAX process on 8 forced host devices with
Auto-axis meshes of shapes (data, model) = (1, 1), (1, 8) and (2, 4); it
saves its initial weights, which the port loads.  Bars are the
reference's: a first-batch loss on a mesh equals the single-device one
within ``5e-3·max(1, |loss|)`` (``tests/test_dist_attention.py``), and
3-step loss trajectories agree within 2e-3
(``tests/test_train_integration.py``).  The world and the reference
process each run under a time limit of their own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_dist_cases as C
from repro_torch.core.config import ParallelConfig, get_config, smoke_config
from repro_torch.launch.world import spawn

LOSS_REL = 5e-3
TRAJ_TOL = 2e-3
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import numpy as np
import jax
from jax.sharding import AxisType, Mesh
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
cfg = smoke_config(get_config("llama-gqa"))
shape = ShapeSpec("tt", {T}, {B}, "train")
devs = np.array(jax.devices())
for d, s in [(1, 1), (1, 8), (2, 4)]:
    mesh = Mesh(devs[:d * s].reshape(d, s), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    par = make_parallel_config(mesh, shape)
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    params = model.init(jax.random.PRNGKey(0))
    batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
    loss, _ = jax.jit(model.loss)(params, batch)
    print(f"LOSS {{d}}x{{s}} {{float(loss)!r}}")
    if (d, s) == (1, 1):
        flat = {{"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(x) for path, x in
                jax.tree_util.tree_flatten_with_path(params)[0]}}
        np.savez({path!r}, **flat)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(T=C.TRAIN_T, B=C.TRAIN_B,
                                                path=path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    losses = {}
    for line in run.stdout.splitlines():
        if line.startswith("LOSS "):
            _, mesh, val = line.split()
            losses[mesh] = float(val)
    return path, losses


@pytest.fixture(scope="module")
def world(reference):
    return spawn(C.train_world, 8, (reference[0],), device="cpu",
                 timeout=180)


@pytest.fixture(scope="module")
def single(reference):
    """The port on one process: first-batch loss and 3-step
    trajectories per checkpoint policy."""
    import torch
    from repro_torch.core.config import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    cfg = smoke_config(get_config("llama-gqa"))
    tree = C.load_tree(reference[0])
    shape = ShapeSpec("tt", C.TRAIN_T, C.TRAIN_B, "train")
    model = DecoderLM(cfg, "cpu")
    with torch.no_grad():
        loss = float(model.loss(load_reference_params(cfg, tree, "cpu"),
                                SyntheticTokens(cfg, shape, "cpu").batch(0)
                                )[0])
    traj = {r: C.train_losses(cfg, tree, ParallelConfig(remat=r), None,
                              C.TRAIN_STEPS) for r in C.REMATS}
    return loss, traj


def _close(a, b):
    return abs(a - b) <= LOSS_REL * max(1.0, abs(b))


@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
def test_mesh_loss_matches_reference_and_single_process(mesh, reference,
                                                        world, single):
    _, ref = reference
    assert _close(ref[mesh], ref["1x1"]), ref
    assert _close(single[0], ref["1x1"]), (single[0], ref)
    for sched in ("balanced", "ring", "zigzag"):
        vals = {r: world[r][f"loss/{mesh}/{sched}"] for r in range(8)}
        assert len(set(vals.values())) == 1, vals     # every rank agrees
        got = vals[0]
        assert _close(got, ref[mesh]), (sched, got, ref[mesh])
        assert _close(got, single[0]), (sched, got, single[0])


@pytest.mark.parametrize("remat", C.REMATS)
@pytest.mark.parametrize("sched", ["balanced", "ring"])
def test_three_steps_at_p8_follow_the_single_process(sched, remat, world,
                                                     single):
    want = single[1][remat]
    for r in range(8):
        got = world[r][f"train/{sched}/{remat}"]
        assert len(got) == C.TRAIN_STEPS
        np.testing.assert_allclose(got, want, atol=TRAJ_TOL)
    assert want[-1] < want[0]               # it trains


def test_irregular_heads_run_balanced_and_refuse_ulysses(world):
    """llama-33h's 33 heads: the sequence-parallel schedules split the
    sequence, not the heads, so balanced runs at P = 8; ulysses cannot
    split 33 heads over 8 ranks and refuses on every rank."""
    for r in range(8):
        assert np.isfinite(world[r]["33h/balanced"])
        assert world[r]["33h/ulysses"].startswith(
            "ValueError: ulysses needs heads % P == 0"), world[r]
