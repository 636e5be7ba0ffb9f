"""The 2D sequence × head plans of the port against the reference's, on the
CPU.

Static, in process: ``build_plan2d`` (the inner plan field by field, the
KV mode), ``plan2d_head_map``, ``plan2d_capable``, ``plan_capable`` and
``ulysses_capable`` equal the reference's over the cases of
``tests/test_schedule_plan.py``'s 2D tests, and ``Mesh2DSpec`` /
``DistAttnSpec(mesh2d=)`` refuse what the reference refuses.

Executors: one JAX process on 8 forced host devices with Auto-axis
``(data, seq, head)`` meshes runs the reference's ``dist_flash_attn`` (o,
lse, and the gradients of sum(o · do)); one 8-rank ``gloo`` world runs the
port's on ``make_seq2d_mesh`` (``tests/_torch_2d_cases.py``): MHA and GQA
in scatter and replicate mode, causal / window / document masks at
(r, u) = (2, 4) and (4, 2), prefix_lm and a non-causal window at r = 1,
and 2D zigzag under ``zigzag_perm(T, r)``.  Bars are the reference's:
forward 2e-5, gradients 5e-5.  The world and the reference process run
under time limits of their own.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_2d_cases as C
from repro.core import dist_attention as rda
from repro.core import mask as rmk
from repro.core import schedule as rsp
from repro_torch.core import dist_attention as tda
from repro_torch.core import mask as tmk
from repro_torch.core import schedule as tsp
from repro_torch.launch.world import spawn
from repro_torch.parallel.comm import Comm

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")


def _fields(x):
    """A plan as nested tuples of plain values (MaskSpecs by fields)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _fields(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_fields(v) for v in x)
    return x


def _factorizations(P):
    return [(r, P // r) for r in range(1, P + 1) if P % r == 0]


def _masks(mk, T):
    return {"causal": mk.causal(),
            "windowed": mk.sliding_window(max(3, T // 8)),
            "document": mk.document(boundaries=mk.doc_boundaries(T, 3))}


TL_DEV = 8


@pytest.mark.parametrize("heads", [(8, 8), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("mcase", ["causal", "windowed", "document"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_plan2d_equals_reference(P, mcase, heads):
    """Every factorization r·u = P and ring-family schedule: capability,
    the inner plan field by field, the KV mode and each head rank's map
    equal the reference's."""
    Hq, Hkv = heads
    for r, u in _factorizations(P):
        T = r * u * TL_DEV
        rm, tm = _masks(rmk, T)[mcase], _masks(tmk, T)[mcase]
        for sched in ("ring", "balanced", "zigzag"):
            cap = tsp.plan2d_capable(sched, tm, r=r, u=u, Hq=Hq, Hkv=Hkv)
            assert cap == rsp.plan2d_capable(sched, rm, r=r, u=u, Hq=Hq,
                                             Hkv=Hkv), (sched, r, u)
            if not cap:
                continue
            tp = tsp.build_plan2d(sched, tm, r, u, TL_DEV, Hq=Hq, Hkv=Hkv)
            rp = rsp.build_plan2d(sched, rm, r, u, TL_DEV, Hq=Hq, Hkv=Hkv)
            assert _fields(tp.inner) == _fields(rp.inner), (sched, r, u)
            assert (tp.name, tp.P, tp.r, tp.u, tp.Hq, tp.Hkv, tp.kv_mode) \
                == (rp.name, rp.P, rp.r, rp.u, rp.Hq, rp.Hkv, rp.kv_mode)
            for j in range(u):
                for a, b in zip(tsp.plan2d_head_map(tp, j),
                                rsp.plan2d_head_map(rp, j)):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sched", ["ring", "balanced"])
def test_plan2d_windowed_pruning_equals_reference(sched):
    """A small window on the inner plan at r = 4 executes fewer steps than
    causal, exactly as the reference's."""
    pc = tsp.build_plan2d(sched, tmk.causal(), 4, 2, 16, Hq=8, Hkv=8)
    pw = tsp.build_plan2d(sched, tmk.sliding_window(5), 4, 2, 16, Hq=8,
                          Hkv=8)
    rw = rsp.build_plan2d(sched, rmk.sliding_window(5), 4, 2, 16, Hq=8,
                          Hkv=8)
    assert pw.inner.exec_steps < pc.inner.exec_steps
    assert _fields(pw.inner) == _fields(rw.inner)


CAPABILITY = [
    ("ring", ("causal",), 2, 4, 6, 2),
    ("ring", ("causal",), 2, 4, 8, 3),
    ("ring", ("prefix", 8), 1, 8, 8, 2),
    ("ring", ("noncausal-window", 9), 1, 8, 8, 8),
    ("ring", ("prefix", 8), 2, 4, 8, 8),
    ("balanced", ("full",), 4, 2, 8, 8),
    ("ring", ("full",), 4, 2, 8, 8),
    ("zigzag", ("causal",), 1, 8, 8, 8),
    ("ulysses", ("causal",), 2, 4, 8, 8),
    ("ring", ("causal",), 2, 4, 6, 6),
]


def _mask(mk, spec):
    kind = spec[0]
    if kind == "causal":
        return mk.causal()
    if kind == "full":
        return mk.full()
    if kind == "prefix":
        return mk.prefix_lm(spec[1])
    return mk.sliding_window(spec[1], causal=False)


@pytest.mark.parametrize("case", CAPABILITY,
                         ids=[f"{c[0]}-{c[1][0]}-r{c[2]}u{c[3]}-{c[4]}/"
                              f"{c[5]}" for c in CAPABILITY])
def test_plan2d_capability_and_build_errors_equal_reference(case):
    sched, mspec, r, u, Hq, Hkv = case
    tm, rm = _mask(tmk, mspec), _mask(rmk, mspec)
    cap = tsp.plan2d_capable(sched, tm, r=r, u=u, Hq=Hq, Hkv=Hkv)
    assert cap == rsp.plan2d_capable(sched, rm, r=r, u=u, Hq=Hq, Hkv=Hkv)
    if cap:
        return
    for sp_, m in ((tsp, tm), (rsp, rm)):
        with pytest.raises(ValueError, match="factorization"):
            sp_.build_plan2d(sched, m, r, u, 8, Hq=Hq, Hkv=Hkv)


def test_plan_and_ulysses_capability_equal_reference():
    masks = [("causal",), ("full",), ("prefix", 8), ("noncausal-window", 9)]
    extra = [lambda mk: mk.sliding_window(9),
             lambda mk: mk.document(boundaries=(0, 10, 20))]
    pairs = [(_mask(tmk, s), _mask(rmk, s)) for s in masks]
    pairs += [(f(tmk), f(rmk)) for f in extra]
    for tm, rm in pairs:
        for sched in ("ring", "balanced", "zigzag", "ulysses"):
            assert tsp.plan_capable(sched, tm) == rsp.plan_capable(sched,
                                                                   rm)
        for P, Hq, Hkv in ((4, 8, 8), (4, 8, 2), (8, 8, 8), (3, 6, 6)):
            for bwd in (True, False):
                assert tsp.ulysses_capable(tm, P, Hq, Hkv,
                                           include_bwd=bwd) == \
                    rsp.ulysses_capable(rm, P, Hq, Hkv, include_bwd=bwd)


SPEC_ERRORS = [
    ("must equal", dict(axis_size=8), (2, 2)),
    ("ring-family plans only", dict(axis_size=8, schedule="ulysses"),
     (4, 2)),
    ("ring-family plans only", dict(axis_size=8, schedule="rsa"), (4, 2)),
    ("prefix_lm", dict(axis_size=8, schedule="ring", mask=("prefix", 8)),
     (4, 2)),
    ("causal-kind", dict(axis_size=8, schedule="balanced",
                         mask=("full",)), (4, 2)),
    ("non-causal sliding window", dict(
        axis_size=8, schedule="ring", mask=("noncausal-window", 9)), (2, 4)),
]


@pytest.mark.parametrize("case", SPEC_ERRORS,
                         ids=[c[0].replace(" ", "-") + f"-{i}"
                              for i, c in enumerate(SPEC_ERRORS)])
def test_mesh2d_spec_refusals_equal_reference(case):
    match, kw, (r, u) = case
    for da, mk in ((tda, tmk), (rda, rmk)):
        k = dict(kw)
        if "mask" in k:
            k["mask"] = _mask(mk, k["mask"])
        with pytest.raises(ValueError, match=match):
            da.DistAttnSpec(mesh2d=da.Mesh2DSpec(r=r, u=u), **k)


def test_mesh2d_spec_checks_and_r1_masks():
    for da, mk in ((tda, tmk), (rda, rmk)):
        with pytest.raises(ValueError, match="distinct"):
            da.Mesh2DSpec(r=2, u=4, seq_axis="x", head_axis="x")
        with pytest.raises(ValueError, match="r, u >= 1"):
            da.Mesh2DSpec(r=0, u=4)
        # prefix_lm and a non-causal window are served at r == 1
        da.DistAttnSpec(axis_size=8, schedule="ring", mask=mk.prefix_lm(8),
                        mesh2d=da.Mesh2DSpec(r=1, u=8))
        da.DistAttnSpec(axis_size=8, schedule="ring",
                        mask=mk.sliding_window(9, causal=False),
                        mesh2d=da.Mesh2DSpec(r=1, u=8))


def test_auto_and_one_group_are_refused_on_a_2d_spec(port):
    """``auto`` on a 2D spec resolves the inner schedule
    (``choose_inner_schedule`` with the backward's horizon; nothing
    raises) and runs in the 8-rank world: every rank resolves the same
    name, and its loss, outputs and gradients equal the named schedule's
    bit for bit; a 2D call given one group raises."""
    import torch
    from repro_torch.core.schedule import choose_inner_schedule
    x = torch.zeros(1, 8, 4, 32)
    auto = tda.DistAttnSpec(axis="seq", axis_size=4, schedule="auto",
                            mesh2d=tda.Mesh2DSpec(r=2, u=2))
    assert tda.resolve_schedule(auto, x, x, x, for_bwd=True) == \
        choose_inner_schedule(tmk.causal(), 2, 2, Tl_dev=8, Hq=4, Hkv=4,
                              Dqk=32, bpe=4, include_bwd=True)
    for name in C.AUTO_CASES:
        _, _, kind, r, u, _, _ = C.EXEC_CASES[C.EXEC_NAMES.index(name)]
        (B, Tl, Hq, D), (_, _, Hkv, _) = port[0]["auto"][name]["shapes"]
        want = choose_inner_schedule(C.make_mask(tmk, kind), r, u,
                                     Tl_dev=Tl, B=B, Hq=Hq, Hkv=Hkv, Dqk=D,
                                     bpe=4, include_bwd=True)
        for p in range(8):
            got = port[p]["auto"][name]
            assert got["name"] == want, (name, p, got["name"])
            assert got["same"], (name, p)
    spec = dataclasses.replace(auto, schedule="balanced")
    one = Comm([0], "local", "cpu")
    with pytest.raises(ValueError, match=r"group=\(seq, head\)"):
        tda.dist_attn_fwd(x, x, x, spec=spec, group=one)
    with pytest.raises(ValueError, match="groups of 1 and 1 ranks"):
        tda.dist_attn_fwd(x, x, x, spec=spec, group=(one, one))


# ------------------------------------------------------------- executors

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_2d_cases as C
from repro.core import mask as rmk
from repro.core.dist_attention import (DistAttnSpec, Mesh2DSpec,
                                       dist_flash_attn)
devs = np.array(jax.devices())
out = {{}}
for case in C.EXEC_CASES:
    name, sched, kind, r, u, hq, hkv = case
    mesh = Mesh(devs.reshape(1, r, u), ("data", "seq", "head"),
                axis_types=(AxisType.Auto,) * 3)
    spec = DistAttnSpec(axis="seq", axis_size=8, schedule=sched,
                        mask=C.make_mask(rmk, kind),
                        mesh2d=Mesh2DSpec(r=r, u=u))
    q, k, v, do = (jnp.asarray(a) for a in C.inputs(case))
    def loss(a, b, c):
        o, lse = dist_flash_attn(a, b, c, mesh, spec, batch_axes=None)
        return jnp.sum(o * do), (o, lse)
    g, (o, lse) = jax.jit(jax.grad(loss, (0, 1, 2), has_aux=True))(q, k, v)
    for key, x in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + tuple(g)):
        out[name + "/" + key] = np.asarray(x)
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
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port():
    return spawn(C.exec_world, 8, (C.EXEC_NAMES,), device="cpu",
                 timeout=180)


@pytest.mark.parametrize("case", C.EXEC_CASES, ids=C.EXEC_NAMES)
def test_2d_executors_match_reference(case, reference, port):
    name, _, _, r, u, hq, hkv = case
    for key in ("o", "lse", "dq", "dk", "dv"):
        got = np.concatenate([port[p][name][key] for p in range(8)],
                             axis=1)
        want = reference[f"{name}/{key}"]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        tol = FWD_TOL if key in ("o", "lse") else GRAD_TOL
        err = float(np.abs(got - want).max())
        assert err < tol, (name, key, err)
    # scatter mode when the KV heads divide u, else replicate; r == 1
    # still runs the 2D plan (u = 8 > 1)
    mode = "scatter" if hkv % u == 0 else "replicate"
    for p in range(8):
        assert set(port[p][name]["modes"]) == {mode}, port[p][name]["modes"]


def test_2d_spec_refuses_one_comm(port):
    """A 2D call given one Comm (the pair's) raises on every rank."""
    for p in range(8):
        assert port[p]["one_comm"].startswith("ValueError: a 2D spec"), \
            port[p]["one_comm"]
