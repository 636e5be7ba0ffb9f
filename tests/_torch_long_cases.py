"""Cases shared by ``tests/test_torch_long_serve.py``'s two sides: the
reference (one JAX process on 8 forced host devices, Auto-axis meshes) and
the port (one 8-rank ``gloo`` world).  Plain numpy and the port only: this
module is imported by the world's ranks, which must not import jax.
"""
import numpy as np

# ------------------------------------------------ dist_decode_attn inputs
DB, DS, DHQ, DHKV, DD = 3, 64, 4, 2, 16       # batch, global slots, heads
DPOS = (5, 37, 64)                            # per-request context lengths
DECODE_CASES = []          # (name, mesh, seq_axes, window, per-request pos)
for _mesh, _axes in (((1, 8), ("model",)), ((2, 4), ("data", "model"))):
    for _w in (0, 13):
        for _pos in (True, False):
            DECODE_CASES.append(
                (f"{_mesh[0]}x{_mesh[1]}-w{_w}-{'pos' if _pos else 'whole'}",
                 _mesh, _axes, _w, _pos))
WRITE_POS = (3, 70, 63)                       # 70 wraps to slot 6


def decode_inputs():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((DB, 1, DHQ, DD)).astype(np.float32)
    kc = rng.standard_normal((DB, DS, DHKV, DD)).astype(np.float32)
    vc = rng.standard_normal((DB, DS, DHKV, DD)).astype(np.float32)
    k1 = rng.standard_normal((DB, 1, DHKV, DD)).astype(np.float32)
    v1 = rng.standard_normal((DB, 1, DHKV, DD)).astype(np.float32)
    return q, kc, vc, k1, v1


# ------------------------------------------------- FixedSlotEngine cases
T_PROMPT, N_GEN = 32, 6
# (name, mesh (data, model), schedule, batch, window, temperature)
ENGINE_CASES = (
    ("1x1", (1, 1), "balanced", 2, 0, 0.0),
    ("1x8-balanced", (1, 8), "balanced", 2, 0, 0.0),
    ("1x8-ring", (1, 8), "ring", 2, 0, 0.0),
    ("1x8-zigzag", (1, 8), "zigzag", 2, 0, 0.0),
    ("1x8-zigzag-w11", (1, 8), "zigzag", 2, 11, 0.0),
    ("2x4-b1", (2, 4), "balanced", 1, 0, 0.0),
    ("2x4-b2", (2, 4), "balanced", 2, 0, 0.0),
    ("1x8-sampled", (1, 8), "balanced", 2, 0, 0.8),
)
SAMPLE_SEED = 3


def prompts(batch):
    return np.random.default_rng(5).integers(
        0, 512, (batch, T_PROMPT)).astype(np.int32)


# ------------------------------------------------------ sharded pools
PB, PBS, PNB, PN, PD = 4, 8, 4, 32, 16        # batch, block, blocks/req, pool, D
PLENS = (3, 9, 17, 31)
PWINDOW = 13
POOL_CASES = (("blocks", 4, 2), ("heads", 16, 8))   # (name, Hq, Hkv)


def pool_inputs(Hq, Hkv):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((PB, 1, Hq, PD)).astype(np.float32)
    kp = rng.standard_normal((PN, PBS, Hkv, PD)).astype(np.float32)
    vp = rng.standard_normal((PN, PBS, Hkv, PD)).astype(np.float32)
    bt = rng.permutation(np.arange(1, PN))[:PB * PNB].reshape(
        PB, PNB).astype(np.int32)
    return q, kp, vp, bt, np.asarray(PLENS, np.int32)


# ------------------------------------------------------------ port side

def _decode_world(rank, meshes):
    import torch
    from repro_torch.core import mask as tmk
    from repro_torch.core.dist_attention import dist_decode_attn
    from repro_torch.models.transformer import _cache_write
    q, kc, vc, k1, v1 = (torch.from_numpy(a) for a in decode_inputs())
    out = {}
    for name, mesh, axes, w, has_pos in DECODE_CASES:
        grp = meshes[mesh].comm(axes)
        n = grp.size
        S_loc = DS // n
        sl = slice(grp.rank * S_loc, (grp.rank + 1) * S_loc)
        m = tmk.sliding_window(w) if w else tmk.causal()
        pos = torch.tensor(DPOS, dtype=torch.int32) if has_pos else None
        o = dist_decode_attn(q, kc[:, sl], vc[:, sl], k1, v1, group=grp,
                             mask=m, pos=pos)
        out["decode/" + name] = o.numpy()
    for mesh, axes in (((1, 8), ("model",)), ((2, 4), ("data", "model"))):
        grp = meshes[mesh].comm(axes)
        S_loc = DS // grp.size
        shard = kc[:, grp.rank * S_loc:(grp.rank + 1) * S_loc].clone()
        _cache_write(shard, k1, torch.tensor(WRITE_POS), grp)
        out[f"write/{mesh[0]}x{mesh[1]}"] = shard.numpy()
    return out


def _cache_rows(prefill, rows):
    """``prefill`` that also appends its cache shard's batch rows to
    ``rows``."""
    def run(p, tokens):
        logits, cache = prefill(p, tokens)
        rows.append(cache["k"].shape[1])
        return logits, cache
    return run


def _engine_world(rank, meshes, tree):
    import dataclasses
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve import prng
    from repro_torch.serve.engine import FixedSlotEngine
    base = smoke_config(get_config("llama-gqa"))
    params = load_reference_params(base, tree, device="cpu")
    out = {}
    for name, mesh_shape, sched, B, window, temp in ENGINE_CASES:
        cfg = base if not window else base.replace(
            attn=dataclasses.replace(base.attn, window=window))
        if mesh_shape == (1, 1):
            if rank:
                continue
            mesh = None
        else:
            mesh = meshes[mesh_shape]
        shape = ShapeSpec("srv", T_PROMPT, B, "decode")
        par = make_parallel_config(mesh, shape, schedule=sched)
        model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
        rng = prng.prng_key(SAMPLE_SEED) if temp else None
        rows = []
        model.prefill = _cache_rows(model.prefill, rows)
        toks, logits = FixedSlotEngine(model, params).generate(
            {"tokens": prompts(B)}, N_GEN, rng=rng, temperature=temp)
        out[f"engine/{name}"] = (toks.numpy(), logits[:, -1].numpy(),
                                 par.seq_axes,
                                 1 if model.decode_group is None
                                 else model.decode_group.size, rows[0])
    return out


def _pool_world(rank, meshes):
    import dataclasses

    import torch
    from repro_torch.core import mask as tmk
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.serve.cache import (PagedKVCache,
                                         sharded_paged_decode_attn)
    out = {}
    mesh = meshes[(1, 8)]
    for name, Hq, Hkv in POOL_CASES:
        base = smoke_config(get_config("llama-gqa"))
        cfg = base.replace(n_layers=1, attn=dataclasses.replace(
            base.attn, n_heads=Hq, n_kv_heads=Hkv, head_dim=PD))
        q, kp, vp, bt, lens = (torch.from_numpy(a)
                               for a in pool_inputs(Hq, Hkv))
        cache = PagedKVCache.create(cfg, block_size=PBS, n_blocks=PN,
                                    max_reqs=PB, device="cpu", mesh=mesh)
        assert cache.sharding == name, (cache.sharding, name)
        # this rank's part of the pool
        for key, full in (("k_pool", kp), ("v_pool", vp)):
            pool = cache.pools[key][0]
            if name == "heads":
                h = pool.shape[2]
                pool.copy_(full[:, :, rank * h:(rank + 1) * h])
            else:
                n = pool.shape[0]
                pool.copy_(full[rank * n:(rank + 1) * n])
        o = sharded_paged_decode_attn(q, cache, 0, bt, lens,
                                      mask=tmk.sliding_window(PWINDOW))
        out[f"pool/{name}"] = (o.numpy(), tuple(cache.pools["k_pool"].shape))
        # page_in / gather round trip through the sharded pool
        T0 = 19
        cache.assign(0, rid=0, n_tokens=T0)
        rng = np.random.default_rng(7)
        dense = {k: torch.from_numpy(rng.standard_normal(
            (1, 1, T0, Hkv, PD)).astype(np.float32)) for k in ("k", "v")}
        cache.page_in(0, dense, T0)
        got = cache.gather(0, T0)
        out[f"roundtrip/{name}"] = max(
            float((got[k] - dense[k][:, 0]).abs().max()) for k in ("k", "v"))
    return out


def port_world(rank, params_path):
    """One rank of the 8-rank world: every case's result on this rank."""
    from _torch_dist_cases import load_tree
    from repro_torch.launch.mesh import make_local_mesh
    meshes = {(1, 8): make_local_mesh(seq=8, device="cpu"),
              (2, 4): make_local_mesh(seq=4, data=2, device="cpu")}
    out = _decode_world(rank, meshes)
    out.update(_engine_world(rank, meshes, load_tree(params_path)))
    out.update(_pool_world(rank, meshes))
    return out


# --------------------------------------- head-parallel pool on the card

def head_parallel_world(rank, n_ranks):
    """One rank of a world sharing one GPU: llama-7b's 32 kv heads × 128
    in a bf16 pool sharded head-parallel over the ranks, at the serving
    step's shape (4 requests, block 16).  Returns whether the gathered
    output of kernel B over this rank's heads equals one B over every
    head bit for bit (rank 0 compares), and this rank's B launches."""
    import torch
    from repro_torch.core.config import get_config
    from repro_torch.core.attention import paged_decode_attn
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.cache import (PagedKVCache,
                                         sharded_paged_decode_attn)
    dev = torch.device("cuda", 0)
    cfg = get_config("llama-7b").replace(n_layers=1)
    a, B, bs, nb = cfg.attn, 4, 16, 64
    mesh = make_local_mesh(seq=n_ranks, device=dev)
    cache = PagedKVCache.create(cfg, block_size=bs, n_blocks=4 * nb + 1,
                                max_reqs=B, device=dev, mesh=mesh)
    assert cache.sharding == "heads"
    gen = torch.Generator(device=dev).manual_seed(0)
    full = {k: torch.randn((1, 4 * nb + 1, bs, a.n_kv_heads, a.head_dim),
                           generator=gen, device=dev).bfloat16()
            for k in ("k_pool", "v_pool")}
    h = a.n_kv_heads // n_ranks
    for k, pool in cache.pools.items():
        pool.copy_(full[k][:, :, :, rank * h:(rank + 1) * h])
    q = torch.randn((B, 1, a.n_heads, a.head_dim), generator=gen,
                    device=dev).bfloat16()
    bt = (1 + torch.arange(B * nb, device=dev, dtype=torch.int32)).view(
        B, nb)
    lens = torch.tensor([1000, 700, 513, 64], dtype=torch.int32, device=dev)
    build.reset_launches()
    o = sharded_paged_decode_attn(q, cache, 0, bt, lens)
    launches = build.LAUNCHES["paged_decode"]
    same = None
    if rank == 0:
        one = paged_decode_attn(q, full["k_pool"][0], full["v_pool"][0],
                                bt, lens)
        same = bool(torch.equal(o, one))
    return same, launches, mesh.transport
