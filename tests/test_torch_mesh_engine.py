"""The paged ``Engine`` across sequence ranks against the reference's, on
the CPU.

The reference side is one JAX process on 8 forced host devices whose meshes
have Auto axes; it replays ``tests/test_serving_engine.py::
test_engine_8dev_batch_invariance`` (smoke qwen3-8b on a (1, 8) mesh, its
pool block-sharded by GSPMD) and serves ``_torch_mesh_cases.POOL_CASES`` on
a (1, 4) mesh: smoke qwen1.5-32b, whose 4 kv heads shard head-parallel (with
n-gram speculation), and smoke qwen3-8b, whose one kv head leaves the pool
blocks to shard.  Three requests share a prefix (a copy-on-write fork, here
across two ranks' blocks) and a ``corrupt_block`` fault quarantines a
request and scrubs its blocks.  Biases and qk-norm weights are perturbed
from their init in numpy and the trees saved for the port.

The port side is a ``gloo`` world of 8 ranks and one of 4
(``tests/_torch_mesh_cases.py``), each rank running the same engine in
lockstep.  Bars: streams equal the reference's token for token, terminal
states and the fault log equal, and on every step the ranks emit the same
tokens from logits whose checksums agree bit for bit.  The world and the
reference process each run under a time limit of their own.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_mesh_cases as C
from repro_torch.launch.world import spawn

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_mesh_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine
from repro.serve.faults import FaultEvent, FaultInjector
from repro.serve.speculative import SpecConfig
devs = np.array(jax.devices())
def mesh_of(n):
    return Mesh(devs[:n].reshape(1, n), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
def model_of(arch, n):
    cfg = smoke_config(get_config(arch))
    mesh = mesh_of(n)
    shape = ShapeSpec("srv", 32, 2, "prefill")
    par = make_parallel_config(mesh, shape)
    return cfg, mesh, shape, par, build_model(
        cfg, Runtime(mesh=mesh, par=par, impl="ref"))
def save(path, tree):
    np.savez(path, **{{
        "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}})
out = {{}}
cfg, mesh, shape, par, model = model_of("qwen3-8b", 8)
params = model.init(jax.random.PRNGKey(0))
save({dir!r} + "/inv.npz", params)
prompts = np.asarray(SyntheticTokens(cfg, shape, par, mesh).batch(0)["tokens"])
np.save({dir!r} + "/inv_prompts.npy", prompts)
eng = Engine(model, params, **C.INV_ENGINE)
subs = [dict(prompt=p, max_new_tokens=C.INV_NEW) for p in prompts]
_, streams, _ = C._drive(eng, subs, C.INV_STAGGER)
solo = []
for p in prompts:
    e = Engine(model, params, **C.INV_ENGINE)
    r = e.submit(p, max_new_tokens=C.INV_NEW)
    solo.append(e.run()[r].tolist())
out["inv"] = dict(streams=[streams[r].tolist() for r in sorted(streams)],
                  solo=solo)
for name, arch, _, depth, corrupt in C.POOL_CASES:
    cfg, mesh, shape, par, model = model_of(arch, 4)
    tree = C.perturb(jax.tree.map(np.asarray,
                                  model.init(jax.random.PRNGKey(0))))
    save({dir!r} + "/" + name + ".npz", tree)
    inj = FaultInjector([] if corrupt is None else [
        FaultEvent(step=corrupt, kind="corrupt_block")])
    spec = SpecConfig(depth=depth, mode="ngram") if depth else None
    eng = Engine(model, jax.tree.map(jnp.asarray, tree), faults=inj,
                 spec=spec, **C.ENGINE)
    rids, streams, _ = C._drive(eng, C.pool_subs(cfg.vocab), C.STAGGER)
    st = eng.stats()
    out[name] = dict(
        rids=rids, streams=[streams[r].tolist() for r in rids],
        log=[list(e) for e in inj.log],
        states=[[eng.requests[r].state, eng.requests[r].finish_reason]
                for r in rids],
        counters={{k: st[k] for k in ("forks", "quarantined",
                                      "hit_tokens")}})
json.dump(out, open({dir!r} + "/ref.json", "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_ref"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(tests=TESTS, dir=d)],
        env=env, capture_output=True, text=True, timeout=420)
    assert run.returncode == 0, run.stderr[-3000:]
    return d, json.load(open(os.path.join(d, "ref.json")))


def _agree(ranks):
    """Every rank emitted the same tokens on every step, from logits with
    the same checksum."""
    for r in ranks[1:]:
        assert r["steps"] == ranks[0]["steps"]
        np.testing.assert_array_equal(r["sums"], ranks[0]["sums"])
    assert ranks[0]["sums"]


def test_8_ranks_replay_the_reference_batch_invariance(reference):
    """Smoke qwen3-8b on 8 ranks, its 32-block pool block-sharded (4
    blocks a rank): two staggered requests stream what the reference's
    8-device engine streams, and what each streams alone; so do they on a
    (2, 4) mesh."""
    d, ref = reference
    prompts = np.load(os.path.join(d, "inv_prompts.npy"))
    ranks = spawn(C.invariance_world, 8,
                  (os.path.join(d, "inv.npz"), prompts), device="cpu",
                  timeout=180)
    _agree(ranks)
    for r in ranks:
        assert r["sharding"] == "blocks"
        assert r["local"][1] == C.INV_ENGINE["n_blocks"] // 8
        assert [s.tolist() for s in r["streams"]] == ref["inv"]["streams"]
        assert [s.tolist() for s in r["solo"]] == ref["inv"]["solo"]
        # (2, 4): the model shards its batch over data; the engine runs a
        # batch-replicated copy over a pool block-sharded on model
        assert r["grid24"] == (True, True, "blocks")
        assert [s.tolist() for s in r["streams24"]] == ref["inv"]["streams"]
    assert ref["inv"]["streams"] == ref["inv"]["solo"]


@pytest.fixture(scope="module")
def pool_world(reference):
    d, _ = reference
    trees = {name: os.path.join(d, name + ".npz")
             for name, *_ in C.POOL_CASES}
    return spawn(C.pool_world, 4, (trees,), device="cpu", timeout=180)


@pytest.mark.parametrize("case", C.POOL_CASES,
                         ids=[c[0] for c in C.POOL_CASES])
def test_4_ranks_serve_the_reference_streams(case, reference, pool_world):
    """A head-parallel pool (speculating) and a block-sharded one on 4
    ranks: the reference's streams, terminal states and fault log; a
    prefix-cache fork happened in both, a quarantine with its scrub in the
    block-sharded one, and every rank took the same steps."""
    name, arch, sharding, _, corrupt = case
    ref = reference[1][name]
    ranks = [r[name] for r in pool_world]
    _agree(ranks)
    for r in ranks:
        assert r["sharding"] == sharding
        assert r["rids"] == ref["rids"]
        assert [s.tolist() for s in r["streams"]] == ref["streams"]
        assert [list(s) for s in r["states"]] == ref["states"]
        assert [list(e) for e in r["log"]] == ref["log"]
        assert r["counters"] == ref["counters"]
        assert not r["nan_left"]         # the corrupted block was scrubbed
        whole, streams = r["whole"]      # use_mesh_sharding=False
        assert whole is None
        assert [s.tolist() for s in streams] == ref["streams"]
    assert ref["counters"]["forks"] >= 1
    n_failed = int(corrupt is not None)
    assert ref["counters"]["quarantined"] == n_failed
    assert sum(s == ["failed", "nan_logits"] for s in ref["states"]) \
        == n_failed
