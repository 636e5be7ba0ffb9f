"""Parity of the port's fault injection with the JAX reference, on the CPU.

``FaultInjector.seeded`` draws the reference's schedules; under the same
schedule and the same submissions both engines write the same fault log
and end with the same terminal states, finish reasons, streams and
``stats()`` counters — for seeded storms over a mixed trace, for one fault
kind at a time (the reference chaos suite's engineered scenarios), and for
a storm over a speculating engine.  Smoke smollm-360m in float32, the
reference's weights carried across with ``load_reference_params``.
"""
import dataclasses

import numpy as np
import pytest

from repro.serve import faults as rfaults
from repro.serve.engine import Engine as REngine
from repro.serve.speculative import SpecConfig as RSpecConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.faults import (FAULT_OWNER, KINDS, FaultEvent,
                                      FaultInjector)
from repro_torch.serve.scheduler import TERMINAL_STATES
from repro_torch.serve.speculative import SpecConfig

from _torch_serve_cases import assert_same_run, drive, pair, prompts


@pytest.fixture(scope="module")
def served():
    pr = pair("smollm-360m")
    return pr, prompts(pr.vocab, [24] * 4, seed=5)


def _both(served, subs, events=None, seeded=None, spec=None, **kw):
    """The same submissions under the same fault schedule (an event list,
    or ``FaultInjector.seeded`` keywords) through both engines; asserts
    the runs are the same and returns the port's (engine, rids, out)."""
    pr, _ = served
    if seeded is not None:
        r_inj = rfaults.FaultInjector.seeded(**seeded)
        t_inj = FaultInjector.seeded(**seeded)
    else:
        r_inj = rfaults.FaultInjector(
            [rfaults.FaultEvent(**dataclasses.asdict(e)) for e in events])
        t_inj = FaultInjector(events)
    r = drive(REngine, pr.r_model, pr.r_params, subs, faults=r_inj,
              spec=None if spec is None else RSpecConfig(**spec), **kw)
    t = drive(Engine, pr.t_model, pr.t_params, subs, faults=t_inj,
              spec=None if spec is None else SpecConfig(**spec), **kw)
    assert_same_run(*r, *t)
    eng = t[0]
    eng.cache.allocator.check_conservation()
    assert eng.sched.idle
    assert not eng.cache.allocator.owned(FAULT_OWNER)
    assert eng.cache.allocator.n_free + eng.cache.n_cache_blocks \
        == eng.cache.allocator.n_usable
    for rid in t[1]:
        assert eng.requests[rid].state in TERMINAL_STATES
    return t


def _engine(n_blocks=28, max_batch=3, chunk=8, **kw):
    """The reference chaos suite's engine settings."""
    return dict(max_batch=max_batch, block_size=8, n_blocks=n_blocks,
                prefill_chunk_tokens=chunk, audit=True, **kw)


# ==========================================================================
# the injector
# ==========================================================================

@pytest.mark.parametrize("seed", [0, 7, 123, 4242])
def test_seeded_schedule_matches_reference(seed):
    for kw in (dict(n_steps=50, rate=0.4),
               dict(n_steps=20, rate=0.5, kinds=("squeeze", "drop_step"),
                    max_magnitude=5, max_duration=1)):
        t = FaultInjector.seeded(seed, **kw)
        r = rfaults.FaultInjector.seeded(seed, **kw)
        assert [dataclasses.astuple(e) for e in t.events] \
            == [dataclasses.astuple(e) for e in r.events]
        assert t.horizon == r.horizon
    assert KINDS == rfaults.KINDS and FAULT_OWNER == rfaults.FAULT_OWNER


def test_fault_event_validation_and_pick():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(step=0, kind="gamma_ray")
    with pytest.raises(ValueError, match="malformed"):
        FaultEvent(step=-1, kind="squeeze")
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultInjector.seeded(0, kinds=("squeeze", "nope"))
    e = FaultEvent(step=0, kind="nan_logits", target=5)
    assert FaultInjector().pick(e, ["a", "b", "c"]) == "c"
    assert FaultInjector().pick(e, []) is None


# ==========================================================================
# seeded storms over a mixed trace
# ==========================================================================

def _trace(vocab, prompts_, trace_seed, n_reqs=5):
    """The reference chaos suite's trace: varied prompt lengths, budgets,
    temperatures and a few deadlines."""
    rng = np.random.default_rng(trace_seed)
    subs = []
    for i in range(n_reqs):
        p = prompts_[i % len(prompts_)]
        plen = int(rng.integers(3, len(p)))
        deadline = int(rng.integers(25, 120)) if rng.random() < 0.3 else None
        subs.append(dict(prompt=p[:plen],
                         max_new_tokens=int(rng.integers(3, 8)),
                         temperature=float(rng.choice([0.0, 0.8])), seed=i,
                         deadline_steps=deadline))
    return subs


STORM = dict(max_retries=4, watchdog_window=4, watchdog_threshold=3)


@pytest.mark.parametrize("fault_seed,trace_seed", [(0, 0), (11, 3),
                                                   (2024, 9)])
def test_storm_matches_reference(served, fault_seed, trace_seed):
    """A seeded storm: the same log, terminal states, reasons, streams and
    counters as the reference; every stream a prefix of the port's
    zero-fault stream, and requests finished under the storm complete."""
    pr, ps = served
    subs = _trace(pr.vocab, ps, trace_seed)
    eng, rids, out = _both(served, subs,
                           seeded=dict(seed=fault_seed, n_steps=20,
                                       rate=0.5), **_engine(**STORM))
    calm = drive(Engine, pr.t_model, pr.t_params, subs,
                 **_engine(**STORM))[2]
    for rid in rids:
        n = out[rid].size
        np.testing.assert_array_equal(out[rid], calm[rid][:n])
        if eng.requests[rid].state == "finished":
            np.testing.assert_array_equal(out[rid], calm[rid])


def test_storm_replays_exactly(served):
    """The same seed twice: the same log, states, streams and counters
    (the phase seconds aside)."""
    pr, ps = served
    subs = _trace(pr.vocab, ps, 5)
    runs = [drive(Engine, pr.t_model, pr.t_params, subs,
                  faults=FaultInjector.seeded(77, n_steps=20, rate=0.5),
                  **_engine(**STORM)) for _ in range(2)]
    (a, rids, out_a), (b, _, out_b) = runs
    assert a.injector.log == b.injector.log and a.injector.log
    for rid in rids:
        assert a.status(rid) == b.status(rid)
        np.testing.assert_array_equal(out_a[rid], out_b[rid])
    sa, sb = a.stats(), b.stats()
    for s in (sa, sb):
        s.pop("prefill_seconds")
        s.pop("decode_seconds")
    assert sa == sb


@pytest.mark.parametrize("chaos_seed", [3, 4321])
def test_spec_storm_matches_reference(served, chaos_seed):
    """A storm over a speculating engine (n-gram, depth 2; prompts over 6
    token ids, so n-grams recur and drafts are proposed): rollbacks and
    fault recovery together, the reference's run exactly."""
    ps = prompts(6, [24] * 4, seed=5)
    subs = [dict(prompt=ps[i % 4][:(9 + 5 * i) % 24 + 4],
                 max_new_tokens=4 + i % 3, temperature=[0.0, 0.8][i % 2],
                 seed=i) for i in range(4)]
    eng = _both(served, subs, seeded=dict(seed=chaos_seed, n_steps=16,
                                          rate=0.5),
                spec=dict(depth=2, mode="ngram"),
                **_engine(n_blocks=24, max_retries=6))[0]
    assert eng.stats()["spec_proposed"] > 0


# ==========================================================================
# engineered scenarios: one fault kind at a time
# ==========================================================================

def _one(ps, i, n, plen, **kw):
    return dict(prompt=ps[i][:plen], max_new_tokens=n, seed=kw.pop("seed", 0),
                **kw)


SCENARIOS = {
    # a NaN-logit fault fails exactly that row; its batchmate streams on
    "nan_logits": dict(
        events=[FaultEvent(step=4, kind="nan_logits", target=0)],
        subs=lambda ps: [_one(ps, 0, 8, 10), _one(ps, 1, 8, 10, seed=1)],
        engine=_engine(chunk=0)),
    # a corrupted block quarantines its owner and is scrubbed
    "corrupt_block": dict(
        events=[FaultEvent(step=5, kind="corrupt_block", target=0)],
        subs=lambda ps: [_one(ps, 0, 10, 12)], engine=_engine(chunk=0)),
    # dropped steps retry with backoff; the stream is unchanged
    "drop_step": dict(
        events=[FaultEvent(step=3, kind="drop_step"),
                FaultEvent(step=6, kind="drop_step")],
        subs=lambda ps: [_one(ps, 0, 8, 10)], engine=_engine(chunk=0)),
    # endless drops exhaust the retries into FAILED
    "retries_exhausted": dict(
        events=[FaultEvent(step=s, kind="drop_step") for s in range(40)],
        subs=lambda ps: [_one(ps, 0, 6, 8)],
        engine=_engine(chunk=0, max_retries=3)),
    # preemption storms trip the watchdog into serial admission
    "preempt_storm": dict(
        events=[FaultEvent(step=s, kind="preempt_storm", magnitude=2)
                for s in range(10)],
        subs=lambda ps: [_one(ps, 0, 5, 20)],
        engine=dict(max_batch=2, block_size=8, n_blocks=28,
                    prefill_chunk_tokens=4, prefix_cache=False, audit=True,
                    watchdog_window=3, watchdog_threshold=2)),
    # squeezes park blocks under FAULT_OWNER and return them
    "squeeze": dict(
        events=[FaultEvent(step=1, kind="squeeze", magnitude=12,
                           duration=6),
                FaultEvent(step=3, kind="squeeze", magnitude=8,
                           duration=2)],
        subs=lambda ps: [_one(ps, i, 5, 12) for i in range(3)],
        engine=_engine(n_blocks=24, chunk=4)),
    # slow steps burn clock ticks and expire a deadline
    "slow_step": dict(
        events=[FaultEvent(step=s, kind="slow_step", magnitude=5)
                for s in range(2, 12)],
        subs=lambda ps: [_one(ps, 0, 30, 10, deadline_steps=25)],
        engine=_engine(chunk=0)),
}

# each scenario's own effect on the port's stats(), as the reference chaos
# suite asserts it
EXPECT = {
    "nan_logits": lambda s: s["quarantined"] == 1,
    "corrupt_block": lambda s: s["quarantined"] == 1,
    "drop_step": lambda s: (s["retried"] >= 2 and s["backoff_steps"] > 0
                            and s["faults"]["drop_step"] == 2),
    "retries_exhausted": lambda s: s["failed"] == 1 and s["steps"] < 20,
    "preempt_storm": lambda s: (s["watchdog_trips"] >= 1
                                and s["storm_preempts"] > 0),
    "squeeze": lambda s: s["faults"]["squeeze"] == 2,
    "slow_step": lambda s: s["expired"] == 1,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(served, name):
    sc = SCENARIOS[name]
    eng, rids, out = _both(served, sc["subs"](served[1]), events=sc["events"],
                           **sc["engine"])
    assert EXPECT[name](eng.stats()), eng.stats()
    if name == "corrupt_block":
        fired = [d for _, k, d in eng.injector.log if k == "corrupt_block"]
        block = int(fired[0].split("block=")[1])
        for pool in eng.cache.pools.values():
            assert bool(pool[:, block].isfinite().all())
