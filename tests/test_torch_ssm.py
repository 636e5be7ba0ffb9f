"""The Mamba2 mixer (``repro_torch/models/ssm.py``) against the reference's
``models/ssm.py`` on the CPU: the chunked SSD, the state carry, the
recurrent decode step, the mixer's gradients, the overflow trap, the
cross-rank state relay on 4 ranks, and the full configs' parameter counts.

Inputs come from seeded numpy and go to both packages.  Bars: the
reference's own (``tests/test_ssm.py:36`` chunked vs sequential 5e-5,
``:58-59`` the state carry 1e-4, ``:79`` decode vs training 5e-5); the
gradients 5e-5; across ranks the distributed bars of ROADMAP item 1 —
outputs 2e-5, gradients 5e-5 (``tests/test_dist_attention.py:407,432``) —
which each planted relay fault (every rank starting from a zero state; the
conv halo zeroed) must miss.  The reference's mixer across ranks runs in
one JAX process on 4 forced host devices with an Auto-axis mesh, the
port's in a 4-rank ``gloo`` world (``tests/_torch_hybrid_cases.py``), each
under a time limit of its own.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

import _torch_hybrid_cases as C
from repro.core import config as RC
from repro.models import ssm as RS
from repro_torch.core import config as PC
from repro_torch.launch.world import spawn
from repro_torch.models import ssm as S

SEQ_TOL = 5e-5       # tests/test_ssm.py:36 and :79
CARRY_TOL = 1e-4     # tests/test_ssm.py:58-59
GRAD_TOL = 5e-5
DIST_FWD_TOL = 2e-5  # tests/test_dist_attention.py:407
DIST_GRAD_TOL = 5e-5  # tests/test_dist_attention.py:432
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' many small operators run on one thread: the
    suite runs several files at once, and threads that wait for each
    other's parallel regions slow every file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(chunk=8, d_model=32):
    """The reference's and the port's test config (``tests/test_ssm.py``'s
    ``_cfg``)."""
    kw = dict(name="t", arch_type="ssm", n_layers=1, d_model=d_model,
              d_ff=0, vocab=16, dtype="float32")
    ssm = dict(d_state=16, d_conv=4, expand=2, head_dim=8, chunk=chunk)
    return (RC.ModelConfig(ssm=RC.SSMConfig(**ssm), **kw),
            PC.ModelConfig(ssm=PC.SSMConfig(**ssm), **kw))


def _params(cfg, seed):
    """Mixer parameters (numpy float32, the reference's names) with a
    small A, so that states carry far."""
    rng = np.random.default_rng(seed)
    s, d = cfg.ssm, cfg.d_model
    di, nh, N = s.d_inner(d), s.n_heads(d), s.d_state

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"ln": 1.0 + n(d, scale=0.1),
            "in_proj": n(d, 2 * di + 2 * N + nh, scale=d ** -0.5),
            "conv_w": n(di + 2 * N, s.d_conv, scale=0.2),
            "conv_b": n(di + 2 * N, scale=0.1),
            "A_log": np.log(rng.uniform(0.05, 1.0, nh)).astype(np.float32),
            "D": 1.0 + n(nh, scale=0.1), "dt_bias": n(nh, scale=0.1),
            "gln": 1.0 + n(di, scale=0.1),
            "out_proj": n(di, d, scale=di ** -0.5)}


def _mesh1():
    devs = np.array(jax.devices()[:1])
    return Mesh(devs.reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in tree.items()}


def _ssd_inputs(seed, b=2, t=64, nh=4, hd=8, N=16):
    """x, B, C, dt, adt and a carry-in (tests/test_ssm.py's scales)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, t, nh, hd)).astype(f)
    B = (rng.standard_normal((b, t, N)) * 0.3).astype(f)
    C = (rng.standard_normal((b, t, N)) * 0.3).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, nh)))).astype(f)
    s0 = (rng.standard_normal((b, nh, N, hd)) * 0.5).astype(f)
    return x, B, C, dt, (-0.5 * dt).astype(f), s0


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_ssd_chunked_matches_reference(chunk):
    """``_ssd_chunked``'s output and final state from a carried-in state
    within 5e-5 of the reference's (its associative scan over chunks is
    the port's loop over them)."""
    args = _ssd_inputs(chunk)
    yr, sr = jax.jit(RS._ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, args), chunk)
    y, s = S._ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=SEQ_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=SEQ_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_ssm_apply_matches_sequential_and_reference(chunk):
    """One rank's ``ssm_apply`` within 5e-5 of the token-by-token
    recurrence (``ssm_sequential_ref``) and of the reference's
    ``ssm_apply``."""
    rcfg, cfg = _cfgs(chunk=chunk)
    p = _params(cfg, chunk)
    x = (np.random.default_rng(chunk + 1).standard_normal((2, 64, 32))
         * 0.5).astype(np.float32)
    y = S.ssm_apply(_t(p), torch.from_numpy(x), cfg)
    y_seq = S.ssm_sequential_ref(_t(p), torch.from_numpy(x), cfg)
    mesh = _mesh1()
    y_ref = jax.jit(lambda p, x: RS.ssm_apply(p, x, rcfg, mesh=mesh))(
        _j(p), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), atol=SEQ_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=SEQ_TOL)


def test_ssd_state_carry_composes():
    """SSD over [first half; second half] with the carried state equals SSD
    over the whole sequence (the invariant the relay relies on), 1e-4."""
    x, B, C, dt, adt, _ = map(torch.from_numpy, _ssd_inputs(0, t=32))
    s0 = torch.zeros((2, 4, 16, 8))
    y_full, s_full = S._ssd_chunked(x, B, C, dt, adt, s0, chunk=8)
    h = 16
    y1, s1 = S._ssd_chunked(x[:, :h], B[:, :h], C[:, :h], dt[:, :h],
                            adt[:, :h], s0, chunk=8)
    y2, s2 = S._ssd_chunked(x[:, h:], B[:, h:], C[:, h:], dt[:, h:],
                            adt[:, h:], s1, chunk=8)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=CARRY_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=CARRY_TOL)


def test_decode_step_matches_training_forward():
    """The recurrent ``ssm_decode_step`` reproduces the training forward
    position by position (5e-5), and each step equals the reference's step
    on the same state (5e-5)."""
    rcfg, cfg = _cfgs()
    p = _params(cfg, 3)
    x = (np.random.default_rng(4).standard_normal((1, 24, 32))
         * 0.5).astype(np.float32)
    y_train = S.ssm_apply(_t(p), torch.from_numpy(x), cfg).numpy()
    s = cfg.ssm
    state = torch.zeros((1, s.n_heads(32), s.d_state, s.head_dim))
    tail = torch.zeros((1, s.d_conv - 1, s.d_inner(32) + 2 * s.d_state))
    rstate, rtail = jnp.asarray(state.numpy()), jnp.asarray(tail.numpy())
    pt, pj = _t(p), _j(p)
    step = jax.jit(lambda p, x, st, tl: RS.ssm_decode_step(p, x, st, tl,
                                                           rcfg))
    for i in range(24):
        y, state, tail = S.ssm_decode_step(pt, torch.from_numpy(
            x[:, i:i + 1]), state, tail, cfg)
        yr, rstate, rtail = step(pj, jnp.asarray(x[:, i:i + 1]), rstate,
                                 rtail)
        np.testing.assert_allclose(y.numpy(), y_train[:, i:i + 1],
                                   atol=SEQ_TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=SEQ_TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                                   atol=SEQ_TOL)


def test_ssm_apply_grads_match_reference():
    """The gradients of Σ ssm_apply(p, x) ⊙ w with respect to every
    parameter and to x within 5e-5 of ``jax.grad`` of the reference's."""
    rcfg, cfg = _cfgs(chunk=16)
    p = _params(cfg, 11)
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 64, 32)) * 0.5).astype(np.float32)
    w = rng.standard_normal((2, 64, 32)).astype(np.float32)
    mesh = _mesh1()
    gp_r, gx_r = jax.jit(jax.grad(lambda p, x: jnp.sum(RS.ssm_apply(
        p, x, rcfg, mesh=mesh) * w), argnums=(0, 1)))(_j(p), jnp.asarray(x))
    pt = _t(p, grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    g = torch.autograd.grad((S.ssm_apply(pt, xt, cfg)
                             * torch.from_numpy(w)).sum(),
                            [xt, *pt.values()])
    np.testing.assert_allclose(g[0].numpy(), np.asarray(gx_r), atol=GRAD_TOL)
    for (name, _), got in zip(pt.items(), g[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(gp_r[name]),
                                   atol=GRAD_TOL, err_msg=name)


def test_overflowing_decay_gives_finite_grads():
    """With a steep decay (A = −e⁵, dt ≈ 1) exp(cum_i − cum_j) above the
    diagonal overflows to inf: masking the differences before the
    exponential keeps the mixer's output and gradients finite, where the
    unmasked form (exp, then zero the upper triangle) gives NaN
    gradients."""
    _, cfg = _cfgs(chunk=16)
    p = _params(cfg, 5)
    p["A_log"][:] = 5.0
    p["dt_bias"][:] = 1.0
    x = (np.random.default_rng(6).standard_normal((1, 32, 32))
         * 0.5).astype(np.float32)
    pt = _t(p, grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = S.ssm_apply(pt, xt, cfg)
    g = torch.autograd.grad(y.sum(), [xt, *pt.values()])
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(t).all() for t in g)
    # the control: the same weights formed after the exponential
    xin, B, C, dt, adt, _ = map(torch.from_numpy, _ssd_inputs(6, t=16))
    adt = (-148.0 * dt).requires_grad_()
    cum = adt.cumsum(dim=1)
    dd = cum[:, :, None, :] - cum[:, None, :, :]
    causal = torch.ones(16, 16, dtype=torch.bool).tril()[None, :, :, None]
    assert torch.isinf(torch.exp(dd)).any()
    w = torch.where(causal, torch.exp(dd), torch.zeros(()))
    (gw,) = torch.autograd.grad(w.sum(), [adt])
    assert torch.isnan(gw).any()


def test_param_counts_match_reference():
    """The full configs' parameter counts equal the reference's
    ``_param_count`` and fall in ``tests/test_models_smoke.py:94,97``'s
    ranges; so do the smoke configs'."""
    ranges = {"mamba2-2.7b": (2.2e9, 3.2e9), "zamba2-2.7b": (2.0e9, 3.3e9)}
    for arch, (lo, hi) in ranges.items():
        cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
        assert cfg.param_count() == rcfg.param_count()
        assert lo <= cfg.param_count() <= hi
        assert (PC.smoke_config(cfg).param_count()
                == RC.smoke_config(rcfg).param_count())
        for f in ("n_layers", "d_model", "d_ff", "vocab", "hybrid_period",
                  "citation"):
            assert getattr(cfg, f) == getattr(rcfg, f), f
        assert cfg.ssm.__dict__ == rcfg.ssm.__dict__
        assert cfg.uses_attention == rcfg.uses_attention


# ------------------------------------------------------ the relay, 4 ranks

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_hybrid_cases as C
from repro.core.config import get_config, smoke_config
from repro.models import ssm as S
cfg = smoke_config(get_config(C.MIX_ARCH))
mesh = Mesh(np.array(jax.devices()[:C.WORLD]).reshape(1, C.WORLD),
            ("data", "model"), axis_types=(AxisType.Auto,) * 2)
p, x, cot = C.mixer_inputs(cfg)
p = {{k: jnp.asarray(v) for k, v in p.items()}}
f = jax.jit(lambda p, x: S.ssm_apply(p, x, cfg, mesh=mesh))
y = f(p, jnp.asarray(x))
gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) * cot),
                          argnums=(0, 1)))(p, jnp.asarray(x))
out = {{"y": np.asarray(y), "dx": np.asarray(gx)}}
out.update({{"dp/" + k: np.asarray(v) for k, v in gp.items()}})
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def relay_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "mix.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(tests=TESTS, path=path)],
        env=env, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def relay_world():
    return spawn(C.mixer_world, C.WORLD, (), device="cpu", timeout=120)


def _gathered(world, key):
    return np.concatenate([r[key] for r in world], axis=1)


def test_relay_across_ranks_matches_reference(relay_reference, relay_world):
    """The mixer on 4 ranks (each its 32 tokens; the state relayed by the
    Hillis–Steele prefix over shifts, the conv halo from the previous
    rank) against the reference's on 4 devices: the output within 2e-5,
    the gradients with respect to x (each rank's shard) and to every
    parameter (the ranks' shares summed) within 5e-5."""
    ref = relay_reference
    np.testing.assert_allclose(_gathered(relay_world, "y"), ref["y"],
                               atol=DIST_FWD_TOL)
    np.testing.assert_allclose(_gathered(relay_world, "dx"), ref["dx"],
                               atol=DIST_GRAD_TOL)
    for name in relay_world[0]["dp"]:
        got = sum(r["dp"][name] for r in relay_world)
        np.testing.assert_allclose(got, ref["dp/" + name],
                                   atol=DIST_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("fault", C.FAULTS)
def test_relay_faults_miss_the_bar(fault, relay_reference, relay_world):
    """Every rank starting from a zero state, or the conv halo zeroed,
    moves the output past the 2e-5 bar (by far: the carried state and the
    halo weigh at every shard's start)."""
    err = float(np.abs(_gathered(relay_world, fault)
                       - relay_reference["y"]).max())
    assert err > 100 * DIST_FWD_TOL, (fault, err)
