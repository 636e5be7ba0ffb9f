"""The port's autotuner sweeps (``tune/sweep.py``) on the CPU against the
reference's table, calibration and microtrace.

``run_sweep(smoke=True, device="cpu")`` runs once for the module: the
``ref`` backend's kernel rows (``block_q = block_kv = T``, a one-entry
``sweep`` map), a 4-rank ``gloo`` schedule sweep (its own time limit; one
torch thread a rank) and smoke ``smollm-360m`` at block sizes 8 and 16.
The table it writes must pass both packages' ``TuningTable.validate``,
both packages' lookups must return the same winners, and calibrating its
rows must give the reference's coefficients.  The port's copy of the
reference's serving microtrace must give the reference's arrivals,
lengths, budgets and temperatures, and its pool sizes the reference
sweep's ``n_blocks`` at every block size.
"""
import os
import sys

import numpy as np
import pytest

from repro.tune import calibrate as rcal
from repro.tune import sweep as rsweep
from repro.tune import table as rtt
from repro_torch.tune import calibrate as tcal
from repro_torch.tune import sweep as tsw
from repro_torch.tune import table as ttt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def swept():
    return tsw.run_sweep(smoke=True, device="cpu", timeout=180,
                         log=lambda *a: None)


def test_smoke_sweep_rows(swept):
    """The document's sections: ref kernel rows at T × T tiles over the
    four mask kinds and both ops, a 4-rank gloo schedule row per (mask
    kind, seq) with its whole wall map, a paged row for smollm-360m."""
    d = swept
    assert d["schema_version"] == 1
    assert d["host"]["platform"] == "cpu"
    assert d["host"]["schedule_transport"] == "gloo"
    ker = d["kernel"]
    assert len(ker) == 2 * 4 * 2
    for r in ker:
        assert r["backend"] == "ref" and r["platform"] == "cpu"
        assert r["block_q"] == r["block_kv"] == r["seq"]
        assert list(r["sweep"]) == [f"{r['seq']}x{r['seq']}"]
        assert r["wall_us"] > 0
    assert {r["mask_kind"] for r in ker} == {"causal", "sliding_window",
                                             "document", "full"}
    sch = d["schedule"]
    assert {(r["mask_kind"], r["seq"]) for r in sch} == {
        ("causal", 256), ("sliding_window", 256)}
    for r in sch:
        assert r["P"] == 4 and set(r["wall_us"]) == {"ring", "balanced",
                                                      "ulysses"}
        assert r["best"] == min(r["wall_us"], key=r["wall_us"].get)
    pg, = d["paged"]
    assert (pg["arch"], pg["layout"], pg["sharding"]) == ("smollm-360m",
                                                           "mha", "none")
    assert set(pg["sweep"]) == {"8", "16"} and pg["block_size"] in (8, 16)


def test_table_validates_and_looks_up_alike_in_both_packages(swept,
                                                              tmp_path):
    """Both packages' TuningTable accept the document (from disk) and
    return the same winner for every row; the port's round trip holds."""
    path = tmp_path / "t.json"
    ttt.TuningTable(swept).save(str(path))
    mine, ref = ttt.TuningTable.load(str(path)), rtt.TuningTable.load(
        str(path))
    assert ttt.TuningTable.validate(swept) == [] == \
        rtt.TuningTable.validate(swept)
    for r in swept["kernel"]:
        kw = dict(backend=r["backend"], platform=r["platform"],
                  mask_kind=r["mask_kind"], head_dim=r["head_dim"],
                  seq=r["seq"], op=r["op"])
        assert mine.best_blocks(**kw) == ref.best_blocks(**kw) == (
            r["block_q"], r["block_kv"])
    for r in swept["schedule"]:
        kw = dict(mask_kind=r["mask_kind"], P=r["P"], seq=r["seq"])
        assert mine.best_schedule(**kw) == ref.best_schedule(**kw) == \
            r["best"]
    for r in swept["paged"]:
        kw = dict(layout=r["layout"], sharding=r["sharding"])
        assert mine.best_block_size(**kw) == ref.best_block_size(**kw) == \
            r["block_size"]
    tsw.check_roundtrip(mine, log=lambda *a: None)


def test_calibration_matches_the_reference(swept):
    """calibrate() on the swept schedule rows: the port's coefficients
    equal the reference's within 1e-6 (relative, or absolute at zero)."""
    mine = tcal.calibrate(swept["schedule"])["coeffs"]
    ref = rcal.calibrate(swept["schedule"])["coeffs"]
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert abs(mine[k] - v) <= 1e-6 * max(abs(v), 1e-30) or \
            mine[k] == v, (k, mine[k], v)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trace_equals_the_references(seed):
    """The port's microtrace (its own copy) gives the reference's
    ``benchmarks/serving_bench._trace`` arrivals, prompt lengths, budgets
    and temperatures, at the full and the smoke settings."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks.serving_bench import _trace
    for kw in (dict(n_requests=8, prompt_lens=(16, 24, 32),
                    budgets=(6, 10, 14), mean_gap=1),
               dict(n_requests=3, prompt_lens=(8, 12), budgets=(3, 5),
                    mean_gap=1)):
        got = tsw.trace(np.random.default_rng(seed), **kw)
        assert got == _trace(np.random.default_rng(seed), **kw)


def test_pool_sizes_equal_the_reference_sweeps(monkeypatch):
    """The reference's sweep_paged (its run_trace recorded, not run) asks
    for the same n_blocks at each block size as the port's
    ``trace_blocks``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import benchmarks.serving_bench as sb
    seen = []

    def record(*, arch, block_size, n_blocks, **kw):
        seen.append((block_size, n_blocks))
        return {"tokens_per_s": 1.0}
    monkeypatch.setattr(sb, "run_trace", record)
    rsweep.sweep_paged({"paged": []}, smoke=False, log=lambda *a: None)
    assert seen and all(n == tsw.trace_blocks(bs) for bs, n in seen)
    assert {bs for bs, _ in seen} == {4, 8, 16, 32}
