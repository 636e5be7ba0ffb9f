"""Cases shared by the two sides of ``tests/test_torch_engine2d.py``: the
paged ``Engine`` on a 2D (data, seq, head) mesh of (1, 2, 2).  The
reference side is one JAX process on 4 forced host devices (Auto axes);
the port side a 4-rank ``gloo`` world on ``launch.mesh.make_seq2d_mesh``.
Plain numpy and the port only: the world's ranks import this module and
must not import jax.

Two models, both at smoke size, float32:
  * ``deepseek-v2-lite-16b`` at 3 layers (``_torch_deepseek_mesh_cases``:
    the dense layer 0 and two MoE layers of 4 routed + 1 shared experts,
    top 2; a latent pool of 48 columns), its routed experts 2 a seq rank,
    the latent pool block-sharded over ``seq`` (12 of 24 blocks a seq
    rank), each of that module's ``CASES``;
  * ``llama-7b`` (4 query and 4 kv heads of 32), its k / v pools
    head-parallel over ``seq`` (2 of 4 kv heads a seq rank): a corrupted
    block, and n-gram verify at depth 3.
"""
import numpy as np

from _torch_deepseek_mesh_cases import CASES as DS_CASES
from _torch_deepseek_mesh_cases import ENGINE, LAYERS, STAGGER
from _torch_mesh_cases import _StepLog, _drive, pool_subs

MESH = (1, 2, 2)                  # (data, seq, head)
DS_ARCH = "deepseek-v2-lite-16b"
DENSE_ARCH = "llama-7b"
# (name, capacity factor or None, n-gram depth, step of a corrupt_block
# fault or None, prefill chunk)
DENSE_CASES = (("fault", None, 0, 9, 8), ("spec", None, 3, None, 8))
# (arch, case) of every run, deepseek's first
RUNS = tuple((DS_ARCH, c) for c in DS_CASES) + tuple(
    (DENSE_ARCH, c) for c in DENSE_CASES)
# the pool each arch keeps, and how the reference's GSPMD places it
POOLS = {DS_ARCH: ("ckv_pool",), DENSE_ARCH: ("k_pool", "v_pool")}
SHARDING = {DS_ARCH: "blocks", DENSE_ARCH: "heads"}
PSPEC = {DS_ARCH: "PartitionSpec(None, 'seq')",
         DENSE_ARCH: "PartitionSpec(None, None, None, 'seq')"}


def run_name(arch, case):
    return f"{arch}/{case[0]}"


def config(arch, get_config, smoke_config, cf=None):
    """A run's config, from either package's config functions."""
    import dataclasses
    cfg = smoke_config(get_config(arch))
    if arch == DS_ARCH:
        cfg = cfg.replace(n_layers=LAYERS)
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    return cfg


def shard_of(pool, sharding, seq, r):
    """Seq shard ``seq`` of ``r`` of a whole pool (L, N, bs, ...): its
    blocks, or its kv heads."""
    if sharding == "blocks":
        n = pool.shape[1] // r
        return pool[:, seq * n:(seq + 1) * n]
    h = pool.shape[3] // r
    return pool[:, :, :, seq * h:(seq + 1) * h]


# ------------------------------------------------------------ port side

def world(rank, params_path):
    """One rank of the (1, 2, 2) world: every RUNS engine (its streams,
    states, fault log, counters, the logits checksum of each decode /
    verify step, this rank's pool shard), and the MoE chunk check."""
    from _torch_2d_cases import load_tree
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.launch.mesh import make_seq2d_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.faults import FaultEvent, FaultInjector
    from repro_torch.serve.speculative import SpecConfig
    mesh = make_seq2d_mesh(*MESH[1:], data=MESH[0], device="cpu")
    par = make_parallel_config(mesh, ShapeSpec("srv", 32, 2, "prefill"))
    out = {"rank": rank, "coords": mesh.coords}
    for arch, case in RUNS:
        name, cf, depth, corrupt, chunk = case
        cfg = config(arch, get_config, smoke_config, cf)
        model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
        params = load_reference_params(cfg, load_tree(params_path, arch),
                                       "cpu", experts=model.expert_group)
        inj = FaultInjector([] if corrupt is None else [
            FaultEvent(step=corrupt, kind="corrupt_block")])
        spec = SpecConfig(depth=depth, mode="ngram") if depth else None
        eng = Engine(model, params, faults=inj, spec=spec,
                     prefill_chunk_tokens=chunk, **ENGINE)
        log = _StepLog(model)
        rids, streams, _ = _drive(eng, pool_subs(cfg.vocab), STAGGER)
        eng.cache.allocator.check_conservation()
        st = eng.stats()
        out[run_name(arch, case)] = dict(
            rids=rids, streams=[streams[r] for r in rids], sums=log.sums,
            log=list(inj.log),
            states=[(eng.requests[r].state, eng.requests[r].finish_reason)
                    for r in rids],
            counters=[st[k] for k in ("forks", "quarantined",
                                      "hit_tokens")],
            sharding=eng.cache.sharding, group=eng.cache.group.size,
            pools={k: eng.cache.pools[k].numpy().copy()
                   for k in POOLS[arch]},
            free=eng.cache.allocator.n_free + eng.cache.n_cache_blocks
            == eng.cache.allocator.n_usable)
    # a chunk's MoE rows split over the 2 seq ranks (the expert group),
    # not the 4 of the (seq, head) pair: 6 rows build, 5 raise
    cfg = config(DS_ARCH, get_config, smoke_config)
    model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
    params = load_reference_params(cfg, load_tree(params_path, DS_ARCH),
                                   "cpu", experts=model.expert_group)
    out["chunks"] = {}
    for n in (6, 5):
        try:
            Engine(model, params, prefill_chunk_tokens=n, **ENGINE)
            out["chunks"][n] = "no error"
        except ValueError as e:
            out["chunks"][n] = f"ValueError: {e}"
    return out
