"""Shared set-up of the speculative and fault-injection parity tests
(``tests/test_torch_spec.py``, ``tests/test_torch_chaos.py``): a smoke model
in both packages with the reference's weights carried into the port, and a
helper that runs one submission list through an engine of either package.
"""
import dataclasses

import jax
import numpy as np
from jax.sharding import AxisType

from repro.core.config import ShapeSpec
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro_torch.core.config import get_config, smoke_config
from repro_torch.models.transformer import DecoderLM, load_reference_params

LOGIT_TOL = 1e-4   # float32 matmul summation order (XLA against PyTorch)


@dataclasses.dataclass
class Pair:
    """One smoke config in both packages, with the same weights."""
    r_model: object
    r_params: dict
    t_model: DecoderLM
    t_params: dict

    @property
    def vocab(self) -> int:
        return self.t_model.cfg.vocab


def pair(arch: str, *, window: int = 0, vocab: int = 0,
         seed: int = 0) -> Pair:
    """``arch``'s smoke config (2 layers, 4 heads of 32, float32), with an
    optional sliding ``window`` and ``vocab``; reference weights from
    ``PRNGKey(seed)`` on an Auto-axis (1, 1) mesh."""
    r_cfg = r_smoke_config(r_get_config(arch))
    t_cfg = smoke_config(get_config(arch))
    kw = {}
    if vocab:
        kw["vocab"] = vocab
    if window:
        r_cfg = r_cfg.replace(attn=dataclasses.replace(r_cfg.attn,
                                                       window=window))
        t_cfg = t_cfg.replace(attn=dataclasses.replace(t_cfg.attn,
                                                       window=window))
    r_cfg, t_cfg = r_cfg.replace(**kw), t_cfg.replace(**kw)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    par = make_parallel_config(mesh, ShapeSpec("srv", 32, 4, "prefill"))
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    r_params = r_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, r_params)
    t_model = DecoderLM(t_cfg, device="cpu")
    return Pair(r_model, r_params, t_model,
                load_reference_params(t_cfg, tree, device="cpu"))


def prompts(vocab: int, lens, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def drive(engine_cls, model, params, subs, *, stagger: int = 0, **kw):
    """Submit ``subs`` (dicts of ``prompt`` and ``submit`` keywords) to a
    fresh ``engine_cls(model, params, **kw)``, stepping ``stagger`` times
    after each, and run it dry.  Returns (engine, rids, {rid: stream})."""
    eng = engine_cls(model, params, **kw)
    rids = []
    for s in subs:
        s = dict(s)
        rids.append(eng.submit(s.pop("prompt"), **s))
        for _ in range(stagger):
            eng.step()
    out = eng.run()
    return eng, rids, {r: np.asarray(out[r]) for r in rids}


def shared_stats(r_stats: dict, t_stats: dict) -> dict:
    """The reference's ``stats()`` keys, with the port's values: every one
    must be present and equal."""
    missing = set(r_stats) - set(t_stats)
    assert not missing, f"port stats lack {sorted(missing)}"
    return {k: t_stats[k] for k in r_stats}


def assert_same_run(r_eng, r_rids, r_out, t_eng, t_rids, t_out):
    """Same rids, terminal states, finish reasons, streams and counters
    (and the same fault log when the engines carry injectors)."""
    assert r_rids == t_rids
    for rid in r_rids:
        rr, tr = r_eng.requests[rid], t_eng.requests[rid]
        assert (tr.state, tr.finish_reason) == (rr.state, rr.finish_reason), \
            rid
        np.testing.assert_array_equal(t_out[rid], r_out[rid])
    if r_eng.injector is not None:
        assert t_eng.injector.log == r_eng.injector.log
        assert t_eng.injector.counts == r_eng.injector.counts
    rs = r_eng.stats()
    assert shared_stats(rs, t_eng.stats()) == rs
