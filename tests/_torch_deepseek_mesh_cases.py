"""Cases shared by ``tests/test_torch_deepseek_mesh.py``'s two sides: the
reference (one JAX process on 8 forced host devices, Auto-axis meshes) and
the port (a 4-rank and an 8-rank ``gloo`` world).  Plain numpy and the port
only: the worlds' ranks import this module and must not import jax.

The model is ``deepseek-v2-lite-16b``'s smoke config at 3 layers (the dense
layer 0 and two MoE layers of 4 routed + 1 shared experts, top 2; MLA
latent 32 + rope 16; float32), its routed experts 1 a rank on 4 sequence
ranks.
"""
import numpy as np

from _torch_mesh_cases import _StepLog, _drive, pool_subs

ARCH = "deepseek-v2-lite-16b"
# the smoke config at 3 layers: the dense layer 0 and two MoE layers, so
# that a chunk's MoE output reaches a later layer's latent rows and the
# pool (at 2 layers the last layer's chunk rows feed nothing: a chunk
# computes no logits)
LAYERS = 3

# ------------------------------------------- the paged Engine on (1, 4)
# (name, capacity factor, n-gram depth, step of a corrupt_block fault or
# None, prefill chunk): the fork and the corrupted block at the smoke
# capacity (nothing dropped); n-gram verify steps across the ranks at
# capacity 0.5 with 32-token chunks, whose 8 rows a rank (bucket padding
# included) overflow the per-rank capacity of 4 (a whole chunk's would
# be 8), so which rank holds which rows decides the drops
CASES = (("fault", 4.0, 0, 9, 8),
         ("spec_cap", 0.5, 3, None, 32))
ENGINE = dict(max_batch=3, block_size=8, n_blocks=24, audit=True)
STAGGER = 3                # steps after each submission
SERVE_MESH = (1, 4)

# --------------------------------------------- the latent ring on (2, 4)
# ``tests/test_dist_attention.py::test_mla_latent_ring_prefill``: 64
# tokens × batch 4 (the batch over data, the sequence over model),
# ``SyntheticTokens`` batch 0; the balanced prefill, then the zigzag one
# with the latent on the ring
RING_MESH = (2, 4)
RING_T, RING_B = 64, 4
RING_RUNS = (("base", "balanced", False), ("latent", "zigzag", True))


def smoke(get_config, smoke_config):
    """The cases' config, from either package's config functions."""
    return smoke_config(get_config(ARCH)).replace(n_layers=LAYERS)


def with_capacity(cfg, cf):
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


# ------------------------------------------------------------ port side

def _model(mesh, params_path, cf=None, latent_ring=False, shape=(32, 2),
           **kw):
    from _torch_dist_cases import load_tree
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    from repro_torch.parallel.sharding import make_parallel_config
    cfg = smoke(get_config, smoke_config)
    if cf is not None:
        cfg = with_capacity(cfg, cf)
    par = make_parallel_config(mesh, ShapeSpec("srv", *shape, "prefill"),
                               **kw)
    model = DecoderLM(cfg, "cpu", par=par, mesh=mesh,
                      latent_ring=latent_ring)
    return model, load_reference_params(cfg, load_tree(params_path), "cpu",
                                        experts=model.expert_group)


def _whole_chunk_moe(self, p, h):
    """The planted fault: every rank dispatches all of the chunk's
    replicated rows (capacity from C rows, not C/S)."""
    from repro_torch.models.moe import moe_apply
    return moe_apply(p, h, self.cfg, group=self.expert_group)[0]


def _serve(model, params, case, split=True):
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.faults import FaultEvent, FaultInjector
    from repro_torch.serve.speculative import SpecConfig
    name, cf, depth, corrupt, chunk = case
    inj = FaultInjector([] if corrupt is None else [
        FaultEvent(step=corrupt, kind="corrupt_block")])
    spec = SpecConfig(depth=depth, mode="ngram") if depth else None
    eng = Engine(model, params, faults=inj, spec=spec,
                 prefill_chunk_tokens=chunk, **ENGINE)
    log = _StepLog(model)
    base = TF.DecoderLM._split_moe
    if not split:
        TF.DecoderLM._split_moe = _whole_chunk_moe
    try:
        rids, streams, _ = _drive(eng, pool_subs(model.cfg.vocab), STAGGER)
    finally:
        TF.DecoderLM._split_moe = base
        for k in ("decode", "verify"):
            model.__dict__.pop(k, None)
    eng.cache.allocator.check_conservation()
    return dict(
        rids=rids, streams=[streams[r] for r in rids], sums=log.sums,
        log=list(inj.log),
        states=[(eng.requests[r].state, eng.requests[r].finish_reason)
                for r in rids],
        counters={k: v for k, v in eng.stats().items()
                  if k in ("forks", "quarantined", "hit_tokens")},
        sharding=eng.cache.sharding,
        pool=eng.cache.pools["ckv_pool"].numpy().copy(),
        free=eng.cache.allocator.n_free + eng.cache.n_cache_blocks
        == eng.cache.allocator.n_usable)


def engine_world(rank, params_path):
    """One rank of the (1, 4) world: each CASES engine over a latent pool
    block-sharded on 4 ranks (this rank's blocks of it returned), and the
    capacity case again with the chunk's MoE dispatching every replicated
    row on every rank."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(seq=SERVE_MESH[1], data=SERVE_MESH[0],
                           device="cpu")
    out = {"rank": mesh.coord("model")}
    for case in CASES:
        model, params = _model(mesh, params_path, case[1])
        out[case[0]] = _serve(model, params, case)
        if case[1] < 1:
            out[case[0] + "/whole"] = _serve(model, params, case,
                                             split=False)
    return out


def ring_world(rank, params_path, tokens):
    """One rank of the (2, 4) world: the whole-prompt prefill of the
    global ``tokens`` (RING_B, RING_T) under each RING_RUNS schedule — last
    logits (gathered over data) and this rank's ``{"ckv"}`` shard — and
    the shape of every tensor the sequence group's ``shift`` carried
    during it."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(seq=RING_MESH[1], data=RING_MESH[0],
                           device="cpu")
    out = {"coords": mesh.coords}
    grp = mesh.comms["model"]
    shift = grp.shift
    for name, sched, lat in RING_RUNS:
        model, params = _model(mesh, params_path, latent_ring=lat,
                               shape=(RING_T, RING_B), schedule=sched)
        seen = []

        def noted(tensors, hops):
            seen.extend(tuple(t.shape) for t in tensors)
            return shift(tensors, hops)
        grp.shift = noted
        try:
            logits, cache = model.prefill(params, torch.from_numpy(tokens))
        finally:
            del grp.shift
        out[name] = dict(logits=logits.numpy(), ckv=cache["ckv"].numpy(),
                         shifted=seen, rows=model.batch_group is not None)
    return out
