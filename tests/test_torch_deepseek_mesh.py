"""DeepSeek-V2-Lite (MLA + MoE) served across sequence ranks: the paged
``Engine`` over a block-sharded latent pool, and the MLA latent ring of the
whole-prompt prefill, in the port against the reference, on the CPU.

The smoke config of ``deepseek-v2-lite-16b`` at 3 layers (the dense layer 0
and two MoE layers of 4 routed + 1 shared experts, top 2; MLA q/k 48, v 32,
latent 32 + rope 16; float32).  The reference side is one JAX process on 8 forced host
devices with Auto-axis meshes.  On (1, 4) it serves three requests that
share a prefix (a copy-on-write fork across two ranks' blocks) through its
paged ``Engine(use_mesh_sharding=True)``, whose 24-block latent pool GSPMD
shards by blocks: once with a ``corrupt_block`` fault, once with n-gram
speculation at depth 3 (verify across the ranks) at capacity factor 0.5,
where each chunk's MoE rows split over the ranks decide which pairs drop.
On (2, 4) it replays ``tests/test_dist_attention.py::
test_mla_latent_ring_prefill``: 64 tokens × batch 4 prefilled under the
balanced schedule and under zigzag with the latent ring.  It saves its
weights and the ring batch for the port.

The port side is a 4-rank and an 8-rank ``gloo`` world
(``tests/_torch_deepseek_mesh_cases.py``), each rank holding its rows of
the routed experts.  Bars: streams equal token for token, terminal states
and the fault log equal, the ranks' logits checksums equal on every step;
the gathered ``ckv_pool`` (past the null block) within 1e-4 of the
reference's (``tests/test_torch_deepseek.py``'s pool bar); the latent ring's
logits and ``{"ckv"}`` cache within 5e-5 of the reference's
(``test_mla_latent_ring_prefill``'s bar) and of the port's own balanced
prefill.  The worlds and the reference process each run under a time
limit of their own.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import _torch_deepseek_mesh_cases as C
from repro_torch.core import mask as mk
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core.dist_attention import (DistAttnSpec,
                                             dist_attn_fwd_latent,
                                             zigzag_perm)
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.engine import Engine

POOL_TOL = 1e-4
RING_TOL = 5e-5
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_deepseek_mesh_cases as C
from _torch_mesh_cases import _drive, pool_subs
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine
from repro.serve.faults import FaultEvent, FaultInjector
from repro.serve.speculative import SpecConfig
devs = np.array(jax.devices())
def mesh_of(d, s):
    return Mesh(devs[:d * s].reshape(d, s), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
def flat(tree):
    return {{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
base = C.smoke(get_config, smoke_config)
mesh = mesh_of(*C.SERVE_MESH)
par = make_parallel_config(mesh, ShapeSpec("srv", 32, 2, "prefill"))
params = build_model(base, Runtime(mesh=mesh, par=par, impl="ref")).init(
    jax.random.PRNGKey(0))
np.savez({params_path!r}, **flat(params))
out = {{}}
for name, cf, depth, corrupt, chunk in C.CASES:
    model = build_model(C.with_capacity(base, cf),
                        Runtime(mesh=mesh, par=par, impl="ref"))
    inj = FaultInjector([] if corrupt is None else [
        FaultEvent(step=corrupt, kind="corrupt_block")])
    spec = SpecConfig(depth=depth, mode="ngram") if depth else None
    eng = Engine(model, params, faults=inj, spec=spec,
                 prefill_chunk_tokens=chunk, **C.ENGINE)
    rids, streams, _ = _drive(eng, pool_subs(base.vocab), C.STAGGER)
    st = eng.stats()
    key = name + "/"
    out[key + "rids"] = np.asarray(rids)
    for r in rids:
        out[key + "stream%d" % r] = np.asarray(streams[r])
        out[key + "state%d" % r] = np.asarray(
            [eng.requests[r].state, str(eng.requests[r].finish_reason)])
    out[key + "log"] = np.asarray([repr((int(s), str(k), str(d)))
                                   for s, k, d in inj.log], dtype=str)
    out[key + "counters"] = np.asarray(
        [st[k] for k in ("forks", "quarantined", "hit_tokens")])
    out[key + "pool"] = np.asarray(eng.cache.pools["ckv_pool"])
    out[key + "pspec"] = np.asarray(
        str(eng.cache.pools["ckv_pool"].sharding.spec))
rmesh = mesh_of(*C.RING_MESH)
shape = ShapeSpec("z", C.RING_T, C.RING_B, "prefill")
for name, sched, lat in C.RING_RUNS:
    par = make_parallel_config(rmesh, shape, schedule=sched)
    model = build_model(base, Runtime(mesh=rmesh, par=par, impl="ref",
                                      latent_ring=lat))
    batch = SyntheticTokens(base, shape, par, rmesh).batch(0)
    logits, cache = jax.jit(model.prefill)(params, batch)
    out["ring/" + name + "/logits"] = np.asarray(logits)
    out["ring/" + name + "/ckv"] = np.asarray(cache["ckv"])
    out["ring/tokens"] = np.asarray(batch["tokens"])
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds_mesh_ref")
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
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), params_path


@pytest.fixture(scope="module")
def engines(reference):
    return spawn(C.engine_world, 4, (reference[1],), device="cpu",
                 timeout=180)


@pytest.fixture(scope="module")
def ring(reference):
    return spawn(C.ring_world, 8, (reference[1],
                                   reference[0]["ring/tokens"]),
                 device="cpu", timeout=180)


def _pool(ranks, name):
    """The ranks' blocks of the latent pool, in rank order: the whole
    (L, N, bs, kv_lora + rope) pool."""
    return np.concatenate([r[name]["pool"] for r in sorted(
        ranks, key=lambda r: r["rank"])], axis=1)


def _same_run(ref, name, got):
    """One rank's run of CASES ``name`` against the reference's."""
    key = name + "/"
    rids = ref[key + "rids"].tolist()
    assert got["rids"] == rids
    for r, s, st in zip(rids, got["streams"], got["states"]):
        np.testing.assert_array_equal(s, ref[key + f"stream{r}"])
        assert [st[0], str(st[1])] == ref[key + f"state{r}"].tolist()
    assert [repr((int(s), str(k), str(d))) for s, k, d in got["log"]] \
        == ref[key + "log"].tolist()
    assert [got["counters"][k] for k in ("forks", "quarantined",
                                         "hit_tokens")] \
        == ref[key + "counters"].tolist()


@pytest.mark.parametrize("case", C.CASES, ids=[c[0] for c in C.CASES])
def test_paged_engine_across_4_ranks_serves_the_reference(case, reference,
                                                          engines):
    """Smoke deepseek through the paged Engine on 4 ranks, its 24-block
    latent pool block-sharded (6 a rank, as the reference's GSPMD places
    it): the reference's streams, terminal states, fault log and
    counters on every rank; the ranks' logits checksums equal on every
    step; the blocks conserved; the ranks' blocks, put together, within
    1e-4 of the reference's pool past the null block.  The fault case
    forks a prefix block and quarantines the corrupted block's owner
    only; the speculative case verifies at capacity 0.5."""
    ref = reference[0]
    name = case[0]
    assert ref[name + "/pspec"].item() == "PartitionSpec(None, 'model')"
    ranks = [r[name] for r in engines]
    for r in ranks:
        assert r["sharding"] == "blocks"
        assert r["pool"].shape[1] == C.ENGINE["n_blocks"] // 4
        assert r["free"]
        assert r["sums"]
        np.testing.assert_array_equal(r["sums"], ranks[0]["sums"])
        _same_run(ref, name, r)
    got = _pool(engines, name)
    want = ref[name + "/pool"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=POOL_TOL,
                               rtol=POOL_TOL)
    forks, quarantined, _ = ref[name + "/counters"].tolist()
    assert forks >= 1
    assert quarantined == int(case[3] is not None)
    failed = sum(ref[name + f"/state{r}"].tolist() == ["failed",
                                                       "nan_logits"]
                 for r in ref[name + "/rids"].tolist())
    assert failed == quarantined


def test_whole_chunk_dispatch_is_rejected(reference, engines):
    """At capacity 0.5 the same engine whose chunk MoE dispatches every
    replicated row on every rank (capacity from the chunk's 32 rows, 8 an
    expert, instead of each rank's 8 rows, 4 an expert) leaves a pool
    beyond the 1e-4 bar of the reference's, which the rows split over the
    ranks meets."""
    ref = reference[0]
    name = next(c[0] for c in C.CASES if c[1] < 1)
    want = ref[name + "/pool"][:, 1:]
    good = _pool(engines, name)[:, 1:]
    bad = np.concatenate([r[name + "/whole"]["pool"] for r in sorted(
        engines, key=lambda r: r["rank"])], axis=1)[:, 1:]
    err = lambda x: float(np.nanmax(np.abs(x - want)))
    assert err(good) <= POOL_TOL
    assert err(bad) > 10 * POOL_TOL, err(bad)


def _global_ckv(ranks, name):
    """The ranks' ``{"ckv"}`` shards as the global (L, B, T, ·) cache in
    stored order (rank (d, m): rows of data replica d, positions of shard
    m)."""
    d_n, m_n = C.RING_MESH
    grid = {r["coords"]: r[name]["ckv"] for r in ranks}
    return np.concatenate([np.concatenate([grid[(d, m)] for m in range(m_n)],
                                          axis=2) for d in range(d_n)],
                          axis=1)


def test_latent_ring_prefill_matches_reference(reference, ring):
    """On (2, 4): the zigzag prefill with the latent on the ring gives the
    reference's last logits (every rank, gathered over data) and its
    permuted ``{"ckv"}`` cache within 5e-5, and so does the balanced
    prefill; un-permuted, the latent ring's cache and its logits are the
    port's balanced prefill's within 5e-5."""
    ref = reference[0]
    for name, _, _ in C.RING_RUNS:
        for r in ring:
            assert r[name]["rows"]          # the batch shards over data
            np.testing.assert_allclose(r[name]["logits"],
                                       ref[f"ring/{name}/logits"],
                                       atol=RING_TOL, rtol=RING_TOL)
        np.testing.assert_allclose(_global_ckv(ring, name),
                                   ref[f"ring/{name}/ckv"], atol=RING_TOL,
                                   rtol=RING_TOL)
    lat, base = _global_ckv(ring, "latent"), _global_ckv(ring, "base")
    perm = zigzag_perm(C.RING_T, C.RING_MESH[1])
    unperm = np.empty_like(lat)
    unperm[:, :, perm] = lat
    np.testing.assert_allclose(unperm, base, atol=RING_TOL, rtol=RING_TOL)
    for r in ring:
        np.testing.assert_allclose(r["latent"]["logits"],
                                   r["base"]["logits"], atol=RING_TOL,
                                   rtol=RING_TOL)


def test_latent_ring_ships_only_latent_rows(ring):
    """Every tensor the sequence group's shifts carry during the latent
    ring's prefill is a (B, Tl, kv_lora + rope) latent block — 48 wide at
    smoke size (576 at full size), never a per-head K/V; the balanced
    prefill ships per-head K/V (and its helpers' partials)."""
    a = C.smoke(get_config, smoke_config).attn
    lat = a.kv_lora_rank + a.qk_rope_head_dim
    Bl, Tl = C.RING_B // C.RING_MESH[0], C.RING_T // C.RING_MESH[1]
    for r in ring:
        shapes = r["latent"]["shifted"]
        assert shapes and set(shapes) == {(Bl, Tl, lat)}, shapes
        assert any(len(s) == 4 and s[2] == a.n_heads
                   for s in r["base"]["shifted"])


def test_error_paths():
    """The latent ring takes plain causal masks only; ``_pool_sharding``
    never shards a latent pool (rank 4) by heads, blocks when N divides,
    else replicates; an MoE engine whose fixed chunk does not split over
    its sequence ranks raises, naming both numbers."""
    t = torch.zeros((1, 8, 4, 8))
    spec = DistAttnSpec(axis_size=4, schedule="zigzag",
                        mask=mk.sliding_window(4))
    with pytest.raises(ValueError, match="plain causal"):
        dist_attn_fwd_latent(t, t, t, t[:, :, 0], None, None, spec=spec)
    lat = (2, 24, 8, 48)
    assert PagedKVCache._pool_sharding(lat, 4) == "blocks"
    assert PagedKVCache._pool_sharding((2, 24, 8, 4, 32), 4) == "heads"
    assert PagedKVCache._pool_sharding((2, 26, 8, 48), 4) is None
    cfg = C.smoke(get_config, smoke_config)
    model = DecoderLM(cfg, device="cpu")
    model.seq_size = 4
    with pytest.raises(ValueError, match="prefill_chunk_tokens=6 .* 4 "):
        Engine(model, DecoderLM(cfg, device="cpu").init(0),
               prefill_chunk_tokens=6)
    sh = types.SimpleNamespace(size=4, rank=0)
    mesh = types.SimpleNamespace(size=lambda ax: 4, comms={"model": sh})
    cache = PagedKVCache.create(cfg, block_size=8, n_blocks=24, mesh=mesh,
                                device="cpu")
    assert cache.sharding == "blocks" and cache.shard.n_local == 6
    assert tuple(cache.pools["ckv_pool"].shape) == (C.LAYERS, 6, 8, 48)


def test_latent_pool_attends_through_the_sharded_helpers():
    """``sharded_paged_decode_attn`` on a latent pool is kernel B over the
    pool as one kv head with v its first kv_lora columns (what
    ``DecoderLM._paged_layers`` runs), and ``gather_pool`` leaves a pool
    that is not block-sharded as it is."""
    from repro_torch.core.attention import paged_decode_attn
    from repro_torch.serve.cache import gather_pool, sharded_paged_decode_attn
    cfg = C.smoke(get_config, smoke_config)
    a = cfg.attn
    cache = PagedKVCache.create(cfg, block_size=8, n_blocks=6, device="cpu")
    gen = torch.Generator().manual_seed(0)
    pool = cache.pools["ckv_pool"]
    pool.copy_(torch.randn(pool.shape, generator=gen))
    q = torch.randn((2, 1, a.n_heads, pool.shape[-1]), generator=gen)
    bt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    lens = torch.tensor([20, 11], dtype=torch.int32)
    got = sharded_paged_decode_attn(q, cache, 1, bt, lens, scale=0.1)
    kv = pool[1][:, :, None]
    want = paged_decode_attn(q, kv, kv[..., :a.kv_lora_rank], bt, lens,
                             scale=0.1)
    assert got.shape == (2, 1, a.n_heads, a.kv_lora_rank)
    assert torch.equal(got, want)
    layer = pool[1]
    assert gather_pool(layer, cache.shard) is layer
