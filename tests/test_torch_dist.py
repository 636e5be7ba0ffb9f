"""The port's multi-rank attention against the reference's, on the CPU.

The reference side is one JAX process on 8 forced host devices whose meshes
have Auto axes (``AxisType.Auto``; jax 0.9's default Explicit axes break the
reference's shard_map code); it runs ``dist_attn_fwd`` and the gradients of
``sum(o²)`` through ``dist_flash_attn``.  The port side is one 8-rank
``gloo`` world (5-rank cases run on a sub-group of it), every rank holding
its shard.  Both sides read the same seeded numpy inputs
(``tests/_torch_dist_cases.py``).  Bars are the reference's: forward 2e-5,
gradients 5e-5 (``tests/test_dist_attention.py``).  Every world and the
reference process run under a time limit of their own and are killed on
expiry.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_dist_cases as C
from repro_torch.launch.world import spawn

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
import _torch_dist_cases as C
from repro.core import mask as rmk
from repro.core.dist_attention import (DistAttnSpec, dist_attn_fwd,
                                       dist_flash_attn)
devs = np.array(jax.devices())
out = {{}}
for case in C.CASES:
    name, sched, spec, P, H, grads = case
    mesh = Mesh(devs[:P].reshape(1, P), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    q, k, v, seg = C.laid_out(case)
    dspec = DistAttnSpec(axis="model", axis_size=P, schedule=sched,
                         mask=C.make_mask(rmk, spec, C.seq_len(P)))
    segs = jnp.asarray(seg) if C.uses_segments(spec) else None
    if grads:
        def loss(a, b, c):
            o, lse = dist_flash_attn(a, b, c, mesh, dspec, None, segs)
            return jnp.sum(o.astype(jnp.float32) ** 2), (o, lse)
        g, (o, lse) = jax.jit(jax.grad(loss, (0, 1, 2), has_aux=True))(
            q, k, v)
        for key, x in zip(("dq", "dk", "dv"), g):
            out[name + "/" + key] = np.asarray(x)
    else:
        o, lse = jax.jit(lambda a, b, c: dist_attn_fwd(
            a, b, c, mesh=mesh, spec=dspec, batch_axes=None,
            segments=segs))(q, k, v)
    out[name + "/o"], out[name + "/lse"] = np.asarray(o), np.asarray(lse)
mesh = Mesh(devs.reshape(1, 8), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
q3 = jnp.zeros((C.B, C.N, 3, C.D))
try:
    dist_attn_fwd(q3, q3, q3, mesh=mesh, batch_axes=None,
                  spec=DistAttnSpec(axis="model", axis_size=8,
                                    schedule="ulysses"))
    print("ULYSSES-3 no error")
except ValueError:
    print("ULYSSES-3 ValueError")
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(tests=TESTS, path=path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), run.stdout


@pytest.fixture(scope="module")
def port():
    return spawn(C.port_world, 8, (C.NAMES,), device="cpu", timeout=180)


def _gathered(port, name, P, key):
    return np.concatenate([port[r][name][key] for r in range(P)], axis=1)


@pytest.mark.parametrize("case", C.CASES, ids=C.NAMES)
def test_dist_attention_matches_reference(case, reference, port):
    name, sched, spec, P, H, grads = case
    ref, _ = reference
    for key in ("o", "lse") + (("dq", "dk", "dv") if grads else ()):
        got = _gathered(port, name, P, key)
        want = ref[f"{name}/{key}"]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        tol = FWD_TOL if key in ("o", "lse") else GRAD_TOL
        err = float(np.abs(got - want).max())
        assert err < tol, (name, key, err)
    if P == 5:
        assert all(port[r][name] is None for r in range(5, 8))


def test_ulysses_refuses_indivisible_heads_and_auto_waits(reference, port):
    """ulysses refuses 3 heads over 8 ranks, as the reference does;
    ``schedule="auto"`` resolves at P = 8 — the same name on every rank,
    ``choose_schedule``'s with the backward's horizon (ulysses where 8
    heads divide 8 ranks; ring at 4 query / 2 kv heads, where balanced's
    shipped queries cost more link bytes at this size) — and runs:
    its outputs, gradients and loss equal the named schedule's bit for
    bit."""
    from repro_torch.core import mask as tmk
    from repro_torch.core.schedule import choose_schedule
    _, stdout = reference
    assert "ULYSSES-3 ValueError" in stdout
    picks = {}
    for name in C.AUTO_CASES:
        case = C.CASES[C.NAMES.index(name)]
        (B, Tl, H, D), (_, _, Hkv, _) = port[0]["auto"][name]["shapes"]
        picks[name] = choose_schedule(
            C.make_mask(tmk, case[2], C.seq_len(case[3])), case[3], Tl=Tl,
            B=B, Hq=H, Hkv=Hkv, Dqk=D, bpe=4, include_bwd=True)
    assert picks == {"ulysses-causal": "ulysses",
                     "balanced-causal": "ring"}, picks
    for r in range(8):
        assert port[r]["ulysses-3-heads"].startswith(
            "ValueError: ulysses needs heads % P == 0"), port[r]
        for name, pick in picks.items():
            got = port[r]["auto"][name]
            assert got["name"] == pick, (r, name, got["name"])
            assert got["same"], (r, name)
            assert np.isfinite(got["loss"])


@pytest.mark.parametrize("sched", ["balanced", "ring", "zigzag"])
def test_shift_is_issued_before_and_waited_after_each_steps_kernels(sched):
    """The paper's overlap, as the reference's dataflow expresses it: the
    shift bringing step t + 1's containers is issued before step t's
    kernels are launched and waited on only after them (the first one
    before the local step's).  Every rank launches the plan's active items
    and nothing else; the last rank has work at every step, so its order
    shows the overlap step by step."""
    from repro_torch.core.mask import causal
    from repro_torch.core.schedule import build_plan
    plan = build_plan(sched, causal(), 4, 16)
    steps = len(plan.steps) - 1
    for r, (fwd, bwd) in enumerate(spawn(C.order_world, 4, (sched,),
                                         device="cpu", timeout=120)):
        for events, kind in ((fwd, "fwd"), (bwd, "bwd")):
            kernels = [i for i, e in enumerate(events) if e[0] == kind]
            assert len(kernels) == plan.kernel_calls_on(r, kind == "bwd")
            tags = [e[1] for e in events if e[0] == "issue"]
            n_of = {t: n + 1 for n, t in enumerate(tags)}
            issue = {n_of[e[1]]: i for i, e in enumerate(events)
                     if e[0] == "issue"}
            wait = {n_of[e[1]]: i for i, e in enumerate(events)
                    if e[0] == "wait"}
            assert sorted(issue) == sorted(wait) == list(range(1, steps + 1))
            if r != 3:
                continue
            for n in range(1, steps + 1):
                assert issue[n] < wait[n]
                # kernels of the step before n run while shift n is out
                assert any(issue[n] < i < wait[n] for i in kernels), \
                    (kind, n, events)
                if n > 1:
                    assert wait[n - 1] < issue[n]
