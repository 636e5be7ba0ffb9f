"""Long-context serving across sequence ranks: the port's sequence-sharded
decode against the reference's, on the CPU.

The reference side is one JAX process on 8 forced host devices whose meshes
have Auto axes; it runs ``dist_decode_attn``, ``_cache_write``,
``FixedSlotEngine.generate`` (llama-gqa's smoke config, float32, its
initial weights saved for the port) and a one-device ``paged_decode_attn``.
The port side is one 8-rank ``gloo`` world holding the same shards
(``tests/_torch_long_cases.py``).  Bars are the reference's: decode
attention and the sharded pools 2e-5 (``tests/test_paged_cache.py``),
tokens equal (``tests/test_chunked_prefill.py``), last logits within
1e-4 × max |logit|.  The world and the reference process each run under a
time limit of their own.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import _torch_long_cases as C
from repro_torch.launch.world import spawn

TOL = 2e-5
LOGIT_REL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_long_cases as C
from repro.core import mask as rmk
from repro.core.attention import paged_decode_attn
from repro.core.config import (ParallelConfig, ShapeSpec, get_config,
                               smoke_config)
from repro.core.dist_attention import dist_decode_attn
from repro.models.transformer import Runtime, _cache_write, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import FixedSlotEngine
devs = np.array(jax.devices())
def mesh_of(shape):
    d, s = shape
    return Mesh(devs[:d * s].reshape(d, s), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
out = {{}}
q, kc, vc, k1, v1 = (jnp.asarray(a) for a in C.decode_inputs())
for name, mshape, axes, w, has_pos in C.DECODE_CASES:
    m = rmk.sliding_window(w) if w else rmk.causal()
    pos = jnp.asarray(C.DPOS, jnp.int32) if has_pos else None
    o = dist_decode_attn(q, kc, vc, k1, v1, mesh=mesh_of(mshape),
                         seq_axes=axes, batch_axes=None, mask=m, pos=pos)
    out["decode/" + name] = np.asarray(o)
for mshape, axes in (((1, 8), ("model",)), ((2, 4), ("data", "model"))):
    par = ParallelConfig(batch_axes=(), seq_axis="model",
                         extra_seq_axes=axes[:-1])
    rt = Runtime(mesh=mesh_of(mshape), par=par, impl="ref")
    out["write/%dx%d" % mshape] = np.asarray(_cache_write(
        kc, k1, jnp.asarray(C.WRITE_POS, jnp.int32), rt))
base = smoke_config(get_config("llama-gqa"))
params = None
for name, mshape, sched, B, window, temp in C.ENGINE_CASES:
    cfg = base if not window else base.replace(
        attn=dataclasses.replace(base.attn, window=window))
    mesh = mesh_of(mshape)
    par = make_parallel_config(mesh, ShapeSpec("srv", C.T_PROMPT, B,
                                               "decode"), schedule=sched)
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    if params is None:
        params = model.init(jax.random.PRNGKey(0))
        np.savez({params_path!r}, **{{
            "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}})
    rng = jax.random.PRNGKey(C.SAMPLE_SEED) if temp else None
    toks, logits = FixedSlotEngine(model, params).generate(
        {{"tokens": jnp.asarray(C.prompts(B))}}, C.N_GEN, rng=rng,
        temperature=temp)
    out["engine/" + name + "/tokens"] = np.asarray(toks)
    out["engine/" + name + "/logits"] = np.asarray(logits[:, -1],
                                                   np.float32)
    print("SEQ_AXES", name, ",".join(par.seq_axes))
for name, Hq, Hkv in C.POOL_CASES:
    q, kp, vp, bt, lens = (jnp.asarray(a) for a in C.pool_inputs(Hq, Hkv))
    out["pool/" + name] = np.asarray(paged_decode_attn(
        q, kp, vp, bt, lens, mask=rmk.sliding_window(C.PWINDOW),
        impl="ref"))
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
        env=env, capture_output=True, text=True, timeout=420)
    assert run.returncode == 0, run.stderr[-3000:]
    axes = {}
    for line in run.stdout.splitlines():
        if line.startswith("SEQ_AXES "):
            _, name, val = line.split()
            axes[name] = tuple(val.split(","))
    return dict(np.load(path)), params_path, axes


@pytest.fixture(scope="module")
def port(reference):
    return spawn(C.port_world, 8, (reference[1],), device="cpu",
                 timeout=180)


@pytest.mark.parametrize("case", C.DECODE_CASES,
                         ids=[c[0] for c in C.DECODE_CASES])
def test_dist_decode_attn_matches_reference(case, reference, port):
    """Every rank returns the whole decode output, equal to the
    reference's within 2e-5, and the ranks agree bit for bit."""
    want = reference[0]["decode/" + case[0]]
    outs = [port[r]["decode/" + case[0]] for r in range(8)]
    for o in outs:
        assert o.shape == want.shape
        assert float(np.abs(o - want).max()) < TOL, case
        np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
def test_cache_write_writes_the_owner_shard(mesh, reference, port):
    """Slot pos % S of each request is written on its owner shard only
    (request 1's position 70 wraps to slot 6)."""
    want = reference[0]["write/" + mesh]
    got = np.concatenate([port[r]["write/" + mesh] for r in range(8)], 1)
    np.testing.assert_array_equal(got, want)
    q, kc, vc, k1, v1 = C.decode_inputs()
    changed = np.nonzero((got != kc).any(axis=(2, 3)))
    assert sorted(zip(*changed)) == [(0, 3), (1, 6), (2, 63)]


@pytest.mark.parametrize("case", C.ENGINE_CASES,
                         ids=[c[0] for c in C.ENGINE_CASES])
def test_fixed_slot_engine_matches_reference(case, reference, port):
    """The same tokens as the reference on every rank, and the last
    logits within 1e-4 of max |logit|: prefill across the ranks (balanced,
    ring, zigzag; zigzag under a window falls back to balanced), the cache
    resharded with headroom, decode reduced over the shards — on the 2-D
    layout over (data, model) for batch 1, while a batch that divides over
    data is split between the data replicas (each caches its rows)."""
    name, mesh, sched, B, window, temp = case
    ref, _, axes = reference
    want_t = ref[f"engine/{name}/tokens"]
    want_l = ref[f"engine/{name}/logits"]
    ranks = [0] if mesh == (1, 1) else range(8)
    split = mesh[0] > 1 and axes[name] == ("model",)
    for r in ranks:
        toks, logits, seq_axes, shards, rows = port[r]["engine/" + name]
        np.testing.assert_array_equal(toks, want_t)
        err = float(np.abs(logits - want_l).max())
        assert err <= LOGIT_REL * float(np.abs(want_l).max()), (name, err)
        assert seq_axes == axes[name]
        assert shards == (mesh[1] if split else mesh[0] * mesh[1])
        assert rows == (B // mesh[0] if split else B)
    if mesh == (2, 4):
        assert axes[name] == (("model",) if B % mesh[0] == 0
                              else ("data", "model"))


@pytest.mark.parametrize("case", C.POOL_CASES,
                         ids=[c[0] for c in C.POOL_CASES])
def test_sharded_pool_matches_one_rank_decode(case, reference, port):
    """A pool sharded over 8 ranks — block-sharded (2 kv heads) or
    head-parallel (8 kv heads) — decodes to the reference's one-device
    result within 2e-5 on every rank; each rank holds its part only."""
    name, Hq, Hkv = case
    want = reference[0]["pool/" + name]
    for r in range(8):
        o, shape = port[r]["pool/" + name]
        assert float(np.abs(o - want).max()) < TOL, (name, r)
        if name == "heads":
            assert shape == (1, C.PN, C.PBS, Hkv // 8, C.PD)
        else:
            assert shape == (1, C.PN // 8, C.PBS, Hkv, C.PD)
        assert port[r]["roundtrip/" + name] < 1e-6


# ------------------------------------------------------------- in process

def test_page_in_gather_roundtrip():
    """The reference's round trip (``tests/test_paged_cache.py``): two
    fragmented slots page in and gather back; release returns every
    block."""
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.serve.cache import PagedKVCache
    cfg = smoke_config(get_config("llama-gqa"))
    cache = PagedKVCache.create(cfg, block_size=8, n_blocks=16, max_reqs=2,
                                device="cpu")
    assert cache.sharding is None and cache.layout == "mha"
    rng = np.random.default_rng(0)
    a, L = cfg.attn, cfg.n_layers
    T0, T1 = 19, 10
    cache.assign(0, rid=0, n_tokens=T0)
    cache.assign(1, rid=1, n_tokens=T1)
    for slot, T in ((0, T0), (1, T1)):
        dense = {k: torch.from_numpy(rng.standard_normal(
            (L, 1, T, a.n_kv_heads, a.head_dim)).astype(np.float32))
            for k in ("k", "v")}
        cache.page_in(slot, dense, T)
        got = cache.gather(slot, T)
        for key in ("k", "v"):
            assert float((got[key] - dense[key][:, 0]).abs().max()) < 1e-6
    cache.release(0, 0)
    cache.release(1, 1)
    cache.allocator.check_conservation()
    assert cache.allocator.n_free == cache.allocator.n_usable


def test_pool_sharding_choice_and_block_size(monkeypatch):
    """The reference's ``_pool_pspec`` choice: heads when they divide the
    axis, else blocks, else replicated; ``REPRO_TUNE_BLOCK_SIZE`` sets the
    default block size (else 16)."""
    from repro_torch.serve.cache import PagedKVCache
    s = (2, 32, 16, 8, 64)
    assert PagedKVCache._pool_sharding(s, 1) is None
    assert PagedKVCache._pool_sharding(s, 4) == "heads"
    assert PagedKVCache._pool_sharding(s, 16) == "blocks"
    assert PagedKVCache._pool_sharding((2, 30, 16, 8, 64), 16) is None
    monkeypatch.delenv("REPRO_TUNE_BLOCK_SIZE", raising=False)
    assert PagedKVCache.default_block_size() == 16
    monkeypatch.setenv("REPRO_TUNE_BLOCK_SIZE", "32")
    assert PagedKVCache.default_block_size() == 32


def test_make_parallel_config_folds_data_into_decode_sequence():
    """``long_500k``: batch 1 cannot shard over data = 2, so a decode
    shape folds data into the cache's sequence axes; a train shape does
    not, and a divisible batch shards over data."""
    from repro_torch.core.config import ShapeSpec
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import make_parallel_config
    mesh = Mesh(axis_names=("data", "model"), shape=(2, 4), coords=(0, 0),
                comms={}, world=None, transport="gloo")
    par = make_parallel_config(mesh, ShapeSpec("l", 64, 1, "decode"))
    assert par.batch_axes == () and par.seq_axes == ("data", "model")
    par = make_parallel_config(mesh, ShapeSpec("l", 64, 1, "train"))
    assert par.seq_axes == ("model",)
    par = make_parallel_config(mesh, ShapeSpec("l", 64, 4, "decode"))
    assert par.batch_axes == ("data",) and par.seq_axes == ("model",)


def test_dist_decode_attn_argument_errors():
    from repro_torch.core import mask as mk
    from repro_torch.core.dist_attention import dist_decode_attn
    z, zc = torch.zeros(2, 1, 2, 4), torch.zeros(2, 8, 2, 4)
    with pytest.raises(TypeError, match="window="):
        dist_decode_attn(z, zc, zc, z, z, window=4)
    with pytest.raises(ValueError, match="causal/sliding_window"):
        dist_decode_attn(z, zc, zc, z, z, mask=mk.document())
    with pytest.raises(ValueError, match="offset-free"):
        dist_decode_attn(z, zc, zc, z, z, mask=mk.causal(rel_offset=3))


def test_scalar_pos_warns_once_and_broadcasts():
    from repro_torch.core import mask as mk
    from repro_torch.core.dist_attention import dist_decode_attn
    site = "dist_decode_attn(pos=<scalar>)"
    mk._DEPRECATION_WARNED.discard(site)
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.standard_normal((2, 1, 2, 4)).astype(
        np.float32))
    zc = torch.from_numpy(rng.standard_normal((2, 8, 2, 4)).astype(
        np.float32))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        a = dist_decode_attn(z, zc, zc, z, z, pos=torch.tensor(5))
        dist_decode_attn(z, zc, zc, z, z, pos=torch.tensor(5))
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)
           and site in str(x.message)]
    assert len(dep) == 1
    b = dist_decode_attn(z, zc, zc, z, z, pos=torch.tensor([5, 5]))
    assert torch.equal(a, b)


def test_split_matches_jax():
    """``prng.split`` gives ``jax.random.split``'s keys bit for bit."""
    import jax
    from repro_torch.serve import prng
    for seed in (0, 3, 12345):
        for n in (2, 3, 5):
            want = np.asarray(jax.random.key_data(
                jax.random.split(jax.random.PRNGKey(seed), n)))
            np.testing.assert_array_equal(
                prng.split(prng.prng_key(seed), n), want)
