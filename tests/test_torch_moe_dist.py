"""Expert parallelism across ranks: the port's ``moe_apply`` and
``moe_decode_apply`` over the sequence axis against the reference's, on the
CPU.

The reference side is one JAX process on 8 forced host devices with
Auto-axis meshes (data, model) = (1, 4) and (2, 4); it draws the MoE
layer's weights (``moe_params``, the smoke config of
``deepseek-v2-lite-16b``: 4 routed experts, top 2, one shared) and saves
them for the port.  The port side is a 4-rank and an 8-rank ``gloo``
world (``tests/_torch_moe_cases.py``), each rank holding its rows of the
routed experts and of x.  At capacity factor 4.0 nothing drops; at 0.5
each rank's capacity (from its own rows) drops pairs.

Bars are the reference's: y and the decode rows 2e-5
(``tests/test_moe.py``); aux, and the gradients of ``sum(y · cot) + aux``
with respect to x and every leaf (the expert shards gathered), 1e-4.
The worlds and the reference process each run under a time limit of
their own.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import _torch_moe_cases as C
from repro_torch.core.config import get_config, smoke_config
from repro_torch.launch.world import spawn
from repro_torch.models import moe as M

Y_TOL = 2e-5
GRAD_TOL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_moe_cases as C
from repro.core.config import get_config, smoke_config
from repro.models import moe as M
devs = np.array(jax.devices())
base = smoke_config(get_config(C.ARCH))
p = M.moe_params(jax.random.PRNGKey(3), base, jnp.float32)
np.savez({params_path!r}, **{{k: np.asarray(v) for k, v in p.items()}})
x, cot, xd = (jnp.asarray(a) for a in C.moe_inputs(base.d_model))
out = {{}}
for shape in C.MESHES:
    d, s = shape
    mesh = Mesh(devs[:d * s].reshape(d, s), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    name = C.mesh_name(shape)
    for cf in C.CAPS:
        cfg = C.with_capacity(base, cf)
        def f(p, x):
            y, aux = M.moe_apply(p, x, cfg, mesh=mesh)
            return jnp.sum(y * cot) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
        key = "%s/%s/" % (name, cf)
        out[key + "y"], out[key + "aux"] = np.asarray(y), np.asarray(aux)
        out[key + "gx"] = np.asarray(gx)
        for k, v in gp.items():
            out[key + "g/" + k] = np.asarray(v)
        out[key + "dec"] = np.asarray(jax.jit(
            lambda p, x: M.moe_decode_apply(p, x, cfg, mesh=mesh))(p, xd))
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    path, params_path = str(d / "ref.npz"), str(d / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
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
def port(reference):
    """Every rank's results, by mesh name."""
    return {C.mesh_name(s): spawn(C.moe_world, s[0] * s[1],
                                  (reference[1], s), device="cpu",
                                  timeout=180)
            for s in C.MESHES}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _rows(coords, shape, n, t):
    """The (rows, cols) a rank at ``coords`` holds of a (n, t) batch."""
    d, s = shape
    dr, sr = coords
    return (slice(dr * n // d, (dr + 1) * n // d),
            slice(sr * t // s, (sr + 1) * t // s))


@pytest.mark.parametrize("cf", C.CAPS)
@pytest.mark.parametrize("shape", C.MESHES, ids=C.mesh_name)
def test_moe_apply_matches_reference(shape, cf, reference, port):
    """y (each rank's rows) within 2e-5, aux on every rank and the
    gradients of x and of every leaf (replicated leaves summed over the
    ranks, expert shards summed over data and gathered over the sequence
    axis) within 1e-4 of the reference's; at capacity 0.5 each rank's
    dispatch drops pairs."""
    ref = reference[0]
    key = f"{C.mesh_name(shape)}/{cf}/"
    for r in port[C.mesh_name(shape)]:
        got = r[cf]
        rows, cols = _rows(r["coords"], shape, C.MB, C.MT)
        _close(got["y"], ref[key + "y"][rows, cols], Y_TOL)
        _close(got["aux"], ref[key + "aux"], GRAD_TOL)
        _close(got["gx"], ref[key + "gx"][rows, cols], GRAD_TOL)
        for k, g in got["grads"].items():
            assert g.shape == ref[key + "g/" + k].shape, k
            _close(g, ref[key + "g/" + k], GRAD_TOL)
    dropped = [r[cf]["dropped"] for r in port[C.mesh_name(shape)]]
    assert (sum(dropped) > 0) == (cf < 1), dropped


@pytest.mark.parametrize("shape", C.MESHES, ids=C.mesh_name)
def test_moe_decode_apply_matches_reference(shape, reference, port):
    """Every rank runs its local experts on its rows and the float32 sums
    are all-reduced over the sequence axis: each rank's rows within 2e-5
    of the reference's, at both capacity factors (decode has none)."""
    for r in port[C.mesh_name(shape)]:
        rows, _ = _rows(r["coords"], shape, C.MB, C.MT)
        for cf in C.CAPS:
            want = reference[0][f"{C.mesh_name(shape)}/{cf}/dec"][rows]
            _close(r[cf]["dec"], want, Y_TOL)


def test_experts_that_do_not_shard_raise():
    """``n_routed % S != 0`` raises naming both numbers (the reference's
    ``n_routed // S`` would make 1 expert a rank of 4 over 3 and drop
    one), in the dispatch and in the decode form."""
    cfg = smoke_config(get_config(C.ARCH))
    three = types.SimpleNamespace(size=3, rank=0)
    x = np.zeros((1, 3, cfg.d_model), np.float32)
    import torch
    with pytest.raises(ValueError, match="4 routed experts do not shard "
                       "over 3 ranks"):
        M.moe_apply({}, torch.from_numpy(x), cfg, group=three)
    with pytest.raises(ValueError, match="4 .* 3"):
        M.moe_decode_apply({}, torch.from_numpy(x), cfg, group=three)


def test_autograd_all_to_all_backward_is_the_inverse(port):
    """On 4 ranks, ``comm.all_to_all(comm, x, 0, 1)`` equals the plain
    ``Comm.all_to_all`` and its backward is the inverse ``all_to_all``
    (split and concat dims swapped); its host seconds reach ``a2a_s``."""
    for r in port["1x4"]:
        a = r["a2a"]
        assert a["fwd"] and a["bwd"], a
        assert a["shape"] == (1, 12, 5)
        assert a["a2a_s"] > 0
