"""The paged ``Engine`` on a 2D (seq × head) mesh in the port against the
reference, on the CPU.

The reference side is one JAX process on 4 forced host devices with an
Auto-axis ``(data, seq, head)`` mesh of (1, 2, 2) and ``REPRO_TUNE=off``:
its paged ``Engine(use_mesh_sharding=True)`` serves three requests that
share a prefix (``_torch_mesh_cases.pool_subs``) for smoke
``deepseek-v2-lite-16b`` at 3 layers — a corrupted block at capacity 4.0,
and n-gram verify at depth 3 and capacity 0.5 with 32-token chunks — and
for smoke ``llama-7b`` — a corrupted block, and n-gram verify at depth 3.
GSPMD shards each pool over ``seq`` alone and replicates it over
``head``.  It saves its weights for the port.

The port side is one 4-rank ``gloo`` world on ``make_seq2d_mesh``
(``tests/_torch_engine2d_cases.py``).  Bars: streams, terminal states,
the fault log and the fork / quarantine / prefix-hit counters equal the
reference's on every rank; the ranks' logits checksums equal on every
step; each rank's pool shard within 1e-4 of the reference pool's part
(``tests/test_torch_deepseek.py``'s pool bar), past the null block; the
two head ranks of a seq shard hold bitwise-equal pools.  The world and the
reference process run under time limits of their own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_engine2d_cases as C
from repro_torch.launch.world import spawn

POOL_TOL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_engine2d_cases as C
from _torch_mesh_cases import _drive, pool_subs
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine
from repro.serve.faults import FaultEvent, FaultInjector
from repro.serve.speculative import SpecConfig
mesh = Mesh(np.array(jax.devices()[:4]).reshape(C.MESH),
            ("data", "seq", "head"), axis_types=(AxisType.Auto,) * 3)
par = make_parallel_config(mesh, ShapeSpec("srv", 32, 2, "prefill"))
def flat(tree, prefix):
    return {{prefix + "/" + "/".join(str(getattr(k, "key", k))
                                   for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
saved, params, out = {{}}, {{}}, {{}}
for arch, (name, cf, depth, corrupt, chunk) in C.RUNS:
    cfg = C.config(arch, get_config, smoke_config, cf)
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    if arch not in params:
        params[arch] = model.init(jax.random.PRNGKey(0))
        saved.update(flat(params[arch], arch))
    inj = FaultInjector([] if corrupt is None else [
        FaultEvent(step=corrupt, kind="corrupt_block")])
    spec = SpecConfig(depth=depth, mode="ngram") if depth else None
    eng = Engine(model, params[arch], faults=inj, spec=spec,
                 prefill_chunk_tokens=chunk, **C.ENGINE)
    rids, streams, _ = _drive(eng, pool_subs(cfg.vocab), C.STAGGER)
    st = eng.stats()
    key = arch + "/" + name + "/"
    out[key + "rids"] = np.asarray(rids)
    for r in rids:
        out[key + "stream%d" % r] = np.asarray(streams[r])
        out[key + "state%d" % r] = np.asarray(
            [eng.requests[r].state, str(eng.requests[r].finish_reason)])
    out[key + "log"] = np.asarray([repr((int(s), str(k), str(d)))
                                   for s, k, d in inj.log], dtype=str)
    out[key + "counters"] = np.asarray(
        [st[k] for k in ("forks", "quarantined", "hit_tokens")])
    for k in C.POOLS[arch]:
        out[key + k] = np.asarray(eng.cache.pools[k])
        out[key + k + "/pspec"] = np.asarray(
            str(eng.cache.pools[k].sharding.spec))
np.savez({params_path!r}, **saved)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine2d_ref")
    path, params_path = str(d / "ref.npz"), str(d / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_TUNE="off",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            tests=TESTS, path=path, params_path=params_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), params_path


@pytest.fixture(scope="module")
def world(reference):
    return spawn(C.world, 4, (reference[1],), device="cpu", timeout=240)


@pytest.mark.parametrize("run", C.RUNS,
                         ids=[C.run_name(a, c) for a, c in C.RUNS])
def test_paged_engine_on_a_2d_mesh_serves_the_reference(run, reference,
                                                        world):
    """Every rank of (1, 2, 2) serves the reference's streams, terminal
    states, fault log and counters, with equal logits checksums on every
    step; its pool is the seq shard's part (blocks of the latent pool,
    kv heads of llama's) within 1e-4 of the reference's, whose GSPMD
    placement is over ``seq`` alone."""
    ref = reference[0]
    arch, case = run
    name = C.run_name(arch, case)
    key = name + "/"
    rids = ref[key + "rids"].tolist()
    r_seq = C.MESH[1]
    for k in C.POOLS[arch]:
        assert ref[key + k + "/pspec"].item() == C.PSPEC[arch]
    zero = world[0][name]
    assert zero["sums"]
    for w in world:
        got = w[name]
        assert got["sharding"] == C.SHARDING[arch]
        assert got["group"] == r_seq
        assert got["free"]
        np.testing.assert_array_equal(got["sums"], zero["sums"])
        assert got["rids"] == rids
        for r, s, st in zip(rids, got["streams"], got["states"]):
            np.testing.assert_array_equal(s, ref[key + f"stream{r}"])
            assert [st[0], str(st[1])] == ref[key + f"state{r}"].tolist()
        assert [repr((int(s), str(k), str(d))) for s, k, d in got["log"]] \
            == ref[key + "log"].tolist()
        assert got["counters"] == ref[key + "counters"].tolist()
        seq = w["coords"][1]
        for k in C.POOLS[arch]:
            want = C.shard_of(ref[key + k], C.SHARDING[arch], seq, r_seq)
            mine = got["pools"][k]
            assert mine.shape == want.shape
            lo = 1 if C.SHARDING[arch] == "heads" or seq == 0 else 0
            np.testing.assert_allclose(mine[:, lo:], want[:, lo:],
                                       atol=POOL_TOL, rtol=POOL_TOL)
    forks, quarantined, _ = ref[key + "counters"].tolist()
    assert forks >= 1
    assert quarantined == int(case[3] is not None)


@pytest.mark.parametrize("run", C.RUNS,
                         ids=[C.run_name(a, c) for a, c in C.RUNS])
def test_head_replicas_hold_bitwise_equal_pools(run, world):
    """The two head ranks of each seq shard hold the same pool bit for bit
    (NaN where a corrupted block was not scrubbed, alike), and the two seq
    shards hold different parts."""
    name = C.run_name(*run)
    by = {w["coords"]: w[name]["pools"] for w in world}
    for k in C.POOLS[run[0]]:
        for s in range(C.MESH[1]):
            a, b = by[(0, s, 0)][k], by[(0, s, 1)][k]
            assert a.tobytes() == b.tobytes(), (k, s)
        assert by[(0, 0, 0)][k].tobytes() != by[(0, 1, 0)][k].tobytes()


def test_moe_chunks_split_over_the_seq_axis(world):
    """An MoE model's fixed chunk must divide by the expert group's 2 seq
    ranks, not by the 4 ranks of the (seq, head) pair: 6 builds, 5 raises
    naming 2."""
    for w in world:
        assert w["chunks"][6] == "no error", w["chunks"][6]
        assert w["chunks"][5].startswith(
            "ValueError: prefill_chunk_tokens=5 does not split over the 2 "), \
            w["chunks"][5]
