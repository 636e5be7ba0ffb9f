"""Cases shared by ``tests/test_torch_mesh_engine.py``'s two sides: the
reference (one JAX process on 8 forced host devices, Auto-axis meshes) and
the port (``gloo`` worlds of 8 and 4 ranks).  Plain numpy and the port
only: the worlds' ranks import this module and must not import jax.
"""
import numpy as np

# ------------------------------------------------------ 8 ranks, qwen3-8b
# ``tests/test_serving_engine.py::test_engine_8dev_batch_invariance``:
# smoke qwen3-8b (1 kv head), mesh (1, 8), its pool of 32 blocks
# block-sharded; two staggered requests of 4 tokens, and each alone
INV_ENGINE = dict(max_batch=2, block_size=8, n_blocks=32)
INV_NEW, INV_STAGGER = 4, 2

# ------------------------------------------------------ 4 ranks, two pools
# (name, arch, expected pool sharding on 4 ranks, speculative depth,
# step of a corrupt_block fault or None): qwen1.5-32b's 4 kv heads split
# head-parallel; qwen3-8b's one kv head leaves the 24 blocks to shard (6 a
# rank).  No fault meets the speculating engine: a verify step's rows past
# n_write spread a corrupted request's NaN through the null block to every
# request on the CPU's plain paged attention, in both packages alike.
POOL_CASES = (("heads", "qwen1.5-32b", "heads", 2, None),
              ("blocks", "qwen3-8b", "blocks", 0, 9))
ENGINE = dict(max_batch=3, block_size=8, n_blocks=24, prefill_chunk_tokens=8,
              audit=True)
STAGGER = 3                # steps after each submission


def pool_subs(vocab):
    """Three requests: a 29-token prompt, one that shares its first two
    blocks and three tokens of its third (a prefix-cache hit whose partial
    tail block is forked on write), and an unrelated one."""
    rng = np.random.default_rng(21)
    a = rng.integers(0, vocab, 29).astype(np.int32)
    b = np.concatenate([a[:19], rng.integers(0, vocab, 6)]).astype(np.int32)
    c = rng.integers(0, vocab, 14).astype(np.int32)
    return [dict(prompt=a, max_new_tokens=8),
            dict(prompt=b, max_new_tokens=7),
            dict(prompt=c, max_new_tokens=9)]


def perturb(tree, seed=0):
    """q/k/v biases from N(0, 0.5²) and qk-norm weights from U[0.5, 1.5), in
    place (the reference initializes them to zeros and ones)."""
    rng = np.random.default_rng(seed)
    attn = tree["layers"]["attn"]
    for k in ("bq", "bk", "bv"):
        if k in attn:
            attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(
                attn[k].dtype)
    for k in ("q_norm", "k_norm"):
        if k in attn:
            attn[k] = rng.uniform(0.5, 1.5, attn[k].shape).astype(
                attn[k].dtype)
    return tree


# ------------------------------------------------------------ port side

class _StepLog:
    """Every decode / verify of ``model``: a float64 checksum of its logits
    (the ranks must agree on it each step; NaN where a row is poisoned)."""

    def __init__(self, model):
        self.sums = []
        for name in ("decode", "verify"):
            fn = getattr(model, name)
            setattr(model, name, self._wrap(fn))

    def _wrap(self, fn):
        def run(*a):
            out = fn(*a)
            self.sums.append(float(out.double().sum()))
            return out
        return run


def _drive(eng, subs, stagger):
    """Submit ``subs`` with ``stagger`` steps after each, then run dry;
    returns (rids, streams, every step's emitted tokens)."""
    steps, rids = [], []
    for s in subs:
        s = dict(s)
        rids.append(eng.submit(s.pop("prompt"), **s))
        for _ in range(stagger):
            steps.append(eng.step())
    while not eng.sched.idle:
        steps.append(eng.step())
    eng.release_faults()
    return rids, {r: np.asarray(eng.requests[r].emitted) for r in rids}, \
        steps


def _model(arch, mesh, tree):
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    from repro_torch.parallel.sharding import make_parallel_config
    cfg = smoke_config(get_config(arch))
    par = make_parallel_config(mesh, ShapeSpec("srv", 32, 2, "prefill"))
    return (DecoderLM(cfg, "cpu", par=par, mesh=mesh),
            load_reference_params(cfg, tree, device="cpu"))


def invariance_world(rank, params_path, prompts):
    """One rank of the 8-rank world: the staggered pair and each request
    alone, on a (1, 8) mesh; the pair again on a (2, 4) mesh whose model
    shards its batch over ``data`` (the engine runs it batch-replicated)."""
    from _torch_dist_cases import load_tree
    from repro_torch.core.config import ShapeSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import Engine
    mesh = make_local_mesh(seq=8, device="cpu")
    model, params = _model("qwen3-8b", mesh, load_tree(params_path))
    eng = Engine(model, params, **INV_ENGINE)
    log = _StepLog(model)
    subs = [dict(prompt=p, max_new_tokens=INV_NEW) for p in prompts]
    _, out, steps = _drive(eng, subs, INV_STAGGER)
    solo = []
    for p in prompts:
        e = Engine(model, params, **INV_ENGINE)
        r = e.submit(p, max_new_tokens=INV_NEW)
        solo.append(e.run()[r])
    eng.cache.allocator.check_conservation()
    mesh24 = make_local_mesh(seq=4, data=2, device="cpu")
    par = make_parallel_config(mesh24, ShapeSpec("srv", 32, 2, "decode"))
    m24 = DecoderLM(model.cfg, "cpu", par=par, mesh=mesh24)
    e24 = Engine(m24, params, **INV_ENGINE)
    _, out24, _ = _drive(e24, subs, INV_STAGGER)
    return dict(streams=[out[r] for r in sorted(out)], solo=solo,
                steps=steps, sums=log.sums, sharding=eng.cache.sharding,
                local=tuple(eng.cache.pools["k_pool"].shape),
                grid24=(m24.batch_group is not None,
                        e24.model.batch_group is None, e24.cache.sharding),
                streams24=[out24[r] for r in sorted(out24)])


def pool_world(rank, trees):
    """One rank of the 4-rank world: each POOL_CASES engine on a (1, 4)
    mesh."""
    from _torch_dist_cases import load_tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.faults import FaultEvent, FaultInjector
    from repro_torch.serve.speculative import SpecConfig
    mesh = make_local_mesh(seq=4, device="cpu")
    out = {}
    for name, arch, _, depth, corrupt in POOL_CASES:
        model, params = _model(arch, mesh, load_tree(trees[name]))
        inj = FaultInjector([] if corrupt is None else [
            FaultEvent(step=corrupt, kind="corrupt_block")])
        spec = SpecConfig(depth=depth, mode="ngram") if depth else None
        eng = Engine(model, params, faults=inj, spec=spec, **ENGINE)
        log = _StepLog(model)
        rids, streams, steps = _drive(eng, pool_subs(model.cfg.vocab),
                                      STAGGER)
        eng.cache.allocator.check_conservation()
        out[name] = dict(
            rids=rids, streams=[streams[r] for r in rids], steps=steps,
            sums=log.sums, log=list(inj.log),
            states=[(eng.requests[r].state, eng.requests[r].finish_reason)
                    for r in rids],
            counters={k: v for k, v in eng.stats().items()
                      if k in ("forks", "quarantined", "hit_tokens")},
            sharding=eng.cache.sharding,
            local=tuple(eng.cache.pools["k_pool"].shape),
            nan_left=any(bool(p.isnan().any())
                         for p in eng.cache.pools.values()))
        # the same run over a whole pool on every rank
        whole = Engine(model, params, use_mesh_sharding=False, spec=spec,
                       faults=FaultInjector(inj.events), **ENGINE)
        w_rids, w_streams, _ = _drive(whole, pool_subs(model.cfg.vocab),
                                      STAGGER)
        out[name]["whole"] = (whole.cache.sharding,
                              [w_streams[r] for r in w_rids])
    return out
