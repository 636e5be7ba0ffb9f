"""``schedule="auto"`` in the port against the reference, on the CPU, with
no world: the static cost model (``core/schedule``: ``plan_cost``,
``ulysses_cost``, ``plan2d_cost``), the choices (``choose_schedule``, with
``factorize=True`` too, and ``choose_inner_schedule``), the roofline
arithmetic (``analysis/roofline``) and the tuning table
(``tune/table``, ``tune/calibrate``, ``tune/timing``).

The grid is ``tests/test_auto_consistency.py``'s: every head shape of the
reference's config zoo × every mask kind × P ∈ {2, 4, 8} × both cost
horizons.  Costs must equal the reference's field for field (the same
float operations in the same order).  Choices are compared under the
reference's TPU constants, patched into the port's ``analysis.roofline``
for the test, with no table and with the reference's bundled CPU table
(``src/repro/tune/tables/default_cpu.json``, read only) given to both by
path.  The port's own choices at its H100 constants are pinned at the
shapes the card runs.  The table tests mirror ``tests/test_autotune.py``'s
behaviours for the port's consumers.
"""
import dataclasses
import json
import logging
import os

import numpy as np
import pytest

from repro.analysis import roofline as rrl
from repro.core import mask as rmk
from repro.core import schedule as rsp
from repro.core.config import ARCH_IDS, PAPER_ARCH_IDS
from repro.core.config import get_config as r_get_config
from repro.tune import calibrate as rcal
from repro.tune import table as rtt
from repro_torch.analysis import roofline as trl
from repro_torch.core import mask as tmk
from repro_torch.core import schedule as tsp
from repro_torch.tune import calibrate as tcal
from repro_torch.tune import table as ttt
from repro_torch.tune import timing as ttm

TESTS = os.path.dirname(os.path.abspath(__file__))
CPU_TABLE = os.path.join(TESTS, "..", "src", "repro", "tune", "tables",
                         "default_cpu.json")
PS = (2, 4, 8)


@pytest.fixture(autouse=True)
def _clean_tuning_state(monkeypatch):
    """No tuning variables; both packages' tables resolved afresh."""
    for var in ("REPRO_TUNE", "REPRO_TUNE_TABLE", "REPRO_TUNE_BLOCK_SIZE"):
        monkeypatch.delenv(var, raising=False)
    rtt.reset()
    ttt.reset()
    yield
    rtt.reset()
    ttt.reset()


@pytest.fixture
def tpu_constants(monkeypatch):
    """The reference's roofline constants in the port's module."""
    monkeypatch.setattr(trl, "PEAK_FLOPS", rrl.PEAK_FLOPS)
    monkeypatch.setattr(trl, "HBM_BW", rrl.HBM_BW)
    monkeypatch.setattr(trl, "LINK_BW", rrl.ICI_BW)


def _head_shapes():
    """(arch, Hq, Hkv, Dqk) of every reference config with attention."""
    out = []
    for a in ARCH_IDS + PAPER_ARCH_IDS:
        at = r_get_config(a).attn
        if at is not None:
            out.append((a, at.n_heads, at.n_kv_heads, at.head_dim))
    assert len(out) >= 10
    return out


def _masks(mk, T):
    """One MaskSpec of each kind, from either package's ``core.mask``, with
    whether its segments are dynamic."""
    return {
        "causal": (mk.causal(), False),
        "full": (mk.full(), False),
        "window": (mk.sliding_window(max(3, T // 4)), False),
        "noncausal-window": (mk.sliding_window(max(3, T // 4),
                                               causal=False), False),
        "prefix": (mk.prefix_lm(max(2, T // 4)), False),
        "doc-static": (mk.document(boundaries=(0, T // 2)), False),
        "doc-dynamic": (mk.document(), True),
    }


def _grid(P):
    T = P * 32
    for arch, Hq, Hkv, D in _head_shapes():
        rm, tm = _masks(rmk, T), _masks(tmk, T)
        for mname in rm:
            yield arch, Hq, Hkv, D, T, mname, rm[mname], tm[mname]


def _fields(cost):
    return dataclasses.asdict(cost)


# ------------------------------------------------------------------ costs

@pytest.mark.parametrize("P", PS)
def test_costs_equal_the_reference_field_for_field(P):
    """plan_cost of every capable plan, ulysses_cost, and plan2d_cost of
    every capable (schedule, r, u) with u > 1, on the zoo × mask grid at
    both element sizes: every field equal to the reference's."""
    n = 0
    for arch, Hq, Hkv, D, T, mname, (rm, dyn), (tm, _) in _grid(P):
        Tl = T // P
        for bpe in (2, 4):
            kw = dict(B=2, Hq=Hq, Hkv=Hkv, Dqk=D, bpe=bpe)
            for name in ("balanced", "ring", "zigzag"):
                assert rsp.plan_capable(name, rm) == tsp.plan_capable(name,
                                                                      tm)
                if not rsp.plan_capable(name, rm):
                    continue
                want = rsp.plan_cost(rsp.build_plan(name, rm, P, Tl),
                                     dynamic_seg=dyn, **kw)
                got = tsp.plan_cost(tsp.build_plan(name, tm, P, Tl),
                                    dynamic_seg=dyn, **kw)
                assert _fields(got) == _fields(want), (arch, mname, name)
                n += 1
            assert _fields(tsp.ulysses_cost(tm, P, Tl=Tl, **kw)) == \
                _fields(rsp.ulysses_cost(rm, P, Tl=Tl, **kw)), (arch, mname)
            for r, u in tsp.factorizations(P):
                assert (r, u) in rsp.factorizations(P)
                for name in ("balanced", "ring"):
                    ok = rsp.plan2d_capable(name, rm, r=r, u=u, Hq=Hq,
                                            Hkv=Hkv)
                    assert ok == tsp.plan2d_capable(name, tm, r=r, u=u,
                                                    Hq=Hq, Hkv=Hkv)
                    if u == 1 or not ok:
                        continue
                    want = rsp.plan2d_cost(
                        rsp.build_plan2d(name, rm, r, u, Tl, Hq=Hq,
                                         Hkv=Hkv),
                        B=2, Dqk=D, bpe=bpe, dynamic_seg=dyn)
                    got = tsp.plan2d_cost(
                        tsp.build_plan2d(name, tm, r, u, Tl, Hq=Hq,
                                         Hkv=Hkv),
                        B=2, Dqk=D, bpe=bpe, dynamic_seg=dyn)
                    assert _fields(got) == _fields(want), (arch, mname,
                                                           name, r, u)
                    n += 1
    assert n > 100


# ---------------------------------------------------------------- choices

def _choices(sp, mask, P, Tl, Hq, Hkv, D, dyn, bwd):
    """Every choice of one call site (a raise as its message's head)."""
    out = []
    for call in (
            lambda: sp.choose_schedule(mask, P, Tl=Tl, Hq=Hq, Hkv=Hkv,
                                       Dqk=D, dynamic_seg=dyn,
                                       include_bwd=bwd),
            lambda: sp.choose_schedule(mask, P, Tl=Tl, Hq=Hq, Hkv=Hkv,
                                       Dqk=D, dynamic_seg=dyn,
                                       include_bwd=bwd, factorize=True),
            *(lambda r=r, u=u: sp.choose_inner_schedule(
                mask, r, u, Tl_dev=Tl, Hq=Hq, Hkv=Hkv, Dqk=D,
                dynamic_seg=dyn, include_bwd=bwd)
              for r, u in sp.factorizations(P) if u > 1)):
        try:
            out.append(call())
        except ValueError as e:
            out.append("ValueError: " + str(e).split(" — ")[0])
    return out


@pytest.mark.parametrize("table", ["none", "reference-cpu"])
@pytest.mark.parametrize("P", PS)
def test_choices_equal_the_reference_under_its_constants(P, table,
                                                         tpu_constants):
    """choose_schedule (1D and factorized) and choose_inner_schedule on
    every (r, u) of P equal the reference's on the whole grid and both
    horizons, under the reference's constants: with no table (the
    roofline), and with the reference's CPU table given to both by path
    (its P = 8 rows decide where they match, its calibrated coefficients
    elsewhere)."""
    if table == "none":
        rtt.set_table(None)
        ttt.set_table(None)
    else:
        rtt.set_table(CPU_TABLE)
        ttt.set_table(CPU_TABLE)
        assert ttt.active_table().coeffs() == rtt.active_table().coeffs()
    n = 0
    for arch, Hq, Hkv, D, T, mname, (rm, dyn), (tm, _) in _grid(P):
        for bwd in (False, True):
            want = _choices(rsp, rm, P, T // P, Hq, Hkv, D, dyn, bwd)
            got = _choices(tsp, tm, P, T // P, Hq, Hkv, D, dyn, bwd)
            assert got == want, (arch, mname, bwd)
            n += 1
    assert n > 100


def test_h100_picks():
    """The port's own picks at its H100 constants (989.4 TFLOP/s, NVLink
    450 GB/s a direction), at the shapes the card runs: phase 7's cell
    (causal, P 4, Tl 8192, 32 / 32 heads of 128, bf16) picks ulysses for
    the forward and with the backward (compute / collective bound 7.78 /
    1.35 ms; balanced 9.72 / 4.93, ring 13.61 / 4.77); deepseek's pair
    shape (Tl 4096, 16 heads, q/k 192, v 128) ulysses; the inner schedule
    on (2, 2) balanced; factorized at P 4 ("ring", 1, 4); at a 16 GB/s
    link (four ranks sharing a card over CUDA IPC) the inner pick on
    (2, 2) becomes ring."""
    ttt.set_table(None)
    m = tmk.causal()
    kw = dict(B=1, Hq=32, Hkv=32, Dqk=128, Dv=128, bpe=2)
    for bwd in (False, True):
        assert tsp.choose_schedule(m, 4, Tl=8192, include_bwd=bwd,
                                   **kw) == "ulysses"
    bound = {"ulysses": tsp.ulysses_cost(m, 4, Tl=8192, **kw)}
    for name in ("balanced", "ring"):
        bound[name] = tsp.plan_cost(tsp.build_plan(name, m, 4, 8192), **kw)
    ms = {k: tuple(round(1e3 * c.time_estimate(True)[t], 2)
                   for t in ("compute_s", "collective_s"))
          for k, c in bound.items()}
    assert ms == {"ulysses": (7.78, 1.35), "balanced": (9.72, 4.93),
                  "ring": (13.61, 4.77)}, ms
    assert tsp.choose_schedule(m, 4, Tl=4096, B=1, Hq=16, Hkv=16, Dqk=192,
                               Dv=128, bpe=2) == "ulysses"
    assert tsp.choose_inner_schedule(m, 2, 2, Tl_dev=8192, **kw) == \
        "balanced"
    assert tsp.choose_schedule(m, 4, Tl=8192, factorize=True, **kw) == \
        ("ring", 1, 4)
    assert trl.LINK_BW == 450e9
    try:
        trl.LINK_BW = 16e9
        assert tsp.choose_inner_schedule(m, 2, 2, Tl_dev=8192, **kw) == \
            "ring"
    finally:
        trl.LINK_BW = 450e9


def test_resolve_schedule_matches_choose_schedule():
    """``resolve_schedule`` reads the call's shapes: named schedules pass
    through; ``auto`` is choose_schedule's pick (the element size from
    the dtype, dynamic segments when given), on a 2D spec
    choose_inner_schedule's; P = 1 stays the local kernel."""
    import torch
    from repro_torch.core import dist_attention as da
    ttt.set_table(None)
    q = torch.zeros(1, 8192, 32, 128, dtype=torch.bfloat16)
    auto = da.DistAttnSpec(axis_size=4, schedule="auto")
    for bwd in (False, True):
        assert da.resolve_schedule(auto, q, q, q, for_bwd=bwd) == "ulysses"
    assert da.resolve_schedule(dataclasses.replace(auto, schedule="ring"),
                               q, q, q) == "ring"
    q3 = torch.zeros(1, 64, 3, 32)
    assert da.resolve_schedule(auto, q3, q3, q3, for_bwd=True) == \
        tsp.choose_schedule(tmk.causal(), 4, Tl=64, Hq=3, Dqk=32, bpe=4)
    two = da.DistAttnSpec(axis="seq", axis_size=4, schedule="auto",
                          mesh2d=da.Mesh2DSpec(r=2, u=2))
    assert da.resolve_schedule(two, q, q, q, for_bwd=True) == "balanced"
    doc = da.DistAttnSpec(axis_size=8, schedule="auto", mask=tmk.document())
    seg = torch.zeros(1, 64, dtype=torch.int32)
    assert da.resolve_schedule(doc, q3, q3, q3, seg) == \
        tsp.choose_schedule(tmk.document(), 8, Tl=64, Hq=3, Dqk=32, bpe=4,
                            dynamic_seg=True, include_bwd=False)


# --------------------------------------------------------------- roofline

ARCHS = ("llama-7b", "qwen3-8b", "smollm-360m", "deepseek-v2-lite-16b")


def test_roofline_arithmetic_equals_the_reference(tpu_constants):
    """model_flops, attention_analytic, paged_decode_terms,
    speculative_terms and prefix_cache_terms of the port's models equal
    the reference's under its constants; a2a / allgather bytes and the
    two- and three-term times too."""
    from repro.core.config import ShapeSpec as RShape
    from repro_torch.core.config import ShapeSpec as TShape
    from repro_torch.core.config import get_config as t_get_config
    for arch in ARCHS:
        rc, tc = r_get_config(arch), t_get_config(arch)
        for kind, T, B in (("train", 4096, 8), ("prefill", 8192, 2),
                           ("decode", 32768, 4), ("decode", 65536, 1)):
            rs, ts = RShape("x", T, B, kind), TShape("x", T, B, kind)
            assert trl.model_flops(tc, ts, chips=4) == \
                rrl.model_flops(rc, rs, chips=4)
            assert trl.attention_analytic(tc, ts, seq_shards=4,
                                          batch_shards=2) == \
                rrl.attention_analytic(rc, rs, seq_shards=4,
                                       batch_shards=2), (arch, kind)
        kw = dict(batch=4, mean_len=700, block_size=16)
        assert trl.paged_decode_terms(tc, **kw) == \
            rrl.paged_decode_terms(rc, **kw)
        draft = r_get_config("smollm-360m"), t_get_config("smollm-360m")
        for depth, acc in ((0, 0.5), (4, 0.7), (3, 1.0)):
            assert trl.speculative_terms(
                tc, depth=depth, acceptance=acc, draft_cfg=draft[1],
                **kw) == rrl.speculative_terms(
                    rc, depth=depth, acceptance=acc, draft_cfg=draft[0],
                    **kw)
        assert trl.prefix_cache_terms(tc, prompt_len=1000, hit_rate=0.4,
                                      chunk_tokens=256) == \
            rrl.prefix_cache_terms(rc, prompt_len=1000, hit_rate=0.4,
                                   chunk_tokens=256)
    assert trl.a2a_bytes(1000.0, 4) == rrl.a2a_bytes(1000.0, 4) == 750.0
    assert trl.allgather_bytes(1000.0, 4) == 3000.0
    assert trl.schedule_cost_terms(flops=3e12, comm_bytes=1e9) == \
        rrl.schedule_cost_terms(flops=3e12, comm_bytes=1e9)
    assert trl.roofline_terms(3e12, 1e9, 1e8) == \
        rrl.roofline_terms(3e12, 1e9, 1e8)
    with pytest.raises(ValueError, match="acceptance"):
        trl.speculative_terms(t_get_config("llama-7b"), batch=1,
                              mean_len=8, depth=2, acceptance=1.5,
                              block_size=16)


def test_h100_constants():
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.LINK_BW) == (989.4e12, 3.35e12,
                                                        450e9)
    t = trl.schedule_cost_terms(flops=989.4e12, comm_bytes=225e9)
    assert t["compute_s"] == 1.0 and t["collective_s"] == 0.5
    assert t["bound"] == "compute"


# ------------------------------------------------------------------ table

def sample_table(**over):
    """``tests/test_autotune.py``'s minimal valid table."""
    data = dict(
        schema_version=ttt.SCHEMA_VERSION,
        generated_by="tests",
        host=dict(platform="cpu"),
        kernel=[
            dict(backend="cuda", platform="cuda", mask_kind="causal",
                 head_dim=64, seq=256, op="fwd", block_q=256, block_kv=32,
                 wall_us=10.0),
            dict(backend="cuda", platform="cuda", mask_kind="causal",
                 head_dim=64, seq=1024, op="fwd", block_q=1024,
                 block_kv=128, wall_us=40.0),
        ],
        schedule=[
            dict(mask_kind="causal", P=8, seq=2048, Hq=8, Hkv=8, Dqk=64,
                 B=1, bpe=4, best="balanced",
                 wall_us=dict(zigzag=90.0, balanced=100.0, ring=200.0,
                              ulysses=300.0)),
        ],
        paged=[
            dict(layout="mha", sharding="none", block_size=32,
                 tokens_per_s=100.0),
        ],
        calibration=dict(
            coeffs=dict(s_per_flop=0.0, s_per_byte=0.0, s_per_hop=3e-2,
                        s_per_elem=2e-7, base_s=0.0),
            fit=dict(n_points=15, spearman=0.97, spearman_roofline=-0.07),
        ),
    )
    data.update(over)
    return data


def test_valid_table_roundtrip(tmp_path):
    p = tmp_path / "t.json"
    tab = ttt.TuningTable(sample_table())
    tab.save(str(p))
    back = ttt.TuningTable.load(str(p))
    assert back.data == tab.data and back.path == str(p)
    ref = rtt.TuningTable.load(str(p))          # the same document
    assert ref.data == back.data


def test_validate_rejects_bad_shapes():
    assert ttt.TuningTable.validate([1, 2]) != []
    assert ttt.TuningTable.validate(sample_table(schema_version=99)) != []
    bad = sample_table(kernel=[dict(backend="cuda")])
    assert any("missing" in e for e in ttt.TuningTable.validate(bad))
    bad = sample_table(calibration=dict(coeffs=dict(s_per_flop="x")))
    assert any("coeffs" in e for e in ttt.TuningTable.validate(bad))
    with pytest.raises(ttt.TableError, match="schema_version"):
        ttt.TuningTable(sample_table(schema_version=99))
    for data in (sample_table(), [1], sample_table(paged=[{}]),
                 sample_table(schedule="x")):
        assert ttt.TuningTable.validate(data) == \
            rtt.TuningTable.validate(data)


def test_nearest_bucket_lookups_equal_the_reference():
    """best_blocks (no consumer in the port), best_schedule and
    best_block_size: nearest bucket in log2 space, exact categorical keys,
    the candidates restriction and the sharding fallback — each lookup
    the reference's on the same document."""
    data = sample_table()
    tab, ref = ttt.TuningTable(data), rtt.TuningTable(data)
    blocks = dict(backend="cuda", platform="cuda", mask_kind="causal",
                  head_dim=64)
    assert tab.best_blocks(seq=256, **blocks) == (256, 32)
    assert tab.best_blocks(seq=384, **blocks) == (256, 32)
    assert tab.best_blocks(seq=768, **blocks) == (1024, 128)
    assert tab.best_blocks(seq=256, op="bwd", **blocks) is None
    assert tab.best_blocks(seq=256, **{**blocks, "backend": "ref"}) is None
    for seq in (64, 256, 384, 768, 4096):
        assert tab.best_blocks(seq=seq, **blocks) == \
            ref.best_blocks(seq=seq, **blocks)
    assert tab.best_schedule(mask_kind="causal", P=8, seq=2048) == "zigzag"
    assert tab.best_schedule(mask_kind="causal", P=8, seq=2048,
                             candidates=("balanced", "ring",
                                         "ulysses")) == "balanced"
    assert tab.best_schedule(mask_kind="causal", P=8, seq=4096,
                             candidates=("ring",)) == "ring"
    assert tab.best_schedule(mask_kind="causal", P=4, seq=2048) is None
    assert tab.best_schedule(mask_kind="document", P=8, seq=2048) is None
    assert tab.best_block_size(layout="mha", sharding="none") == 32
    assert tab.best_block_size(layout="mha", sharding="pool") == 32
    assert tab.best_block_size(layout="mla") is None
    cpu = json.load(open(CPU_TABLE))
    tab, ref = ttt.TuningTable(cpu), rtt.TuningTable(cpu)
    for kind in ("causal", "document", "sliding_window", "full"):
        for seq in (512, 1024, 1536, 4096):
            assert tab.best_schedule(mask_kind=kind, P=8, seq=seq) == \
                ref.best_schedule(mask_kind=kind, P=8, seq=seq)
    for layout in ("mha", "mla"):
        for sh in ("none", "pool"):
            assert tab.best_block_size(layout=layout, sharding=sh) == \
                ref.best_block_size(layout=layout, sharding=sh)
    assert tab.coeffs() == ref.coeffs() and tab.fit() == ref.fit()


def test_schema_mismatch_degrades_with_one_warning(tmp_path, caplog,
                                                   monkeypatch):
    p = tmp_path / "future.json"
    p.write_text(json.dumps(sample_table(schema_version=99)))
    monkeypatch.setenv("REPRO_TUNE_TABLE", str(p))
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.table"):
        assert ttt.active_table() is None
        ttt.reset()
        assert ttt.active_table() is None   # no second warning
    warned = [r for r in caplog.records if str(p) in r.getMessage()]
    assert len(warned) == 1
    assert "schema_version" in warned[0].getMessage()


def test_corrupt_json_never_crashes_consumers(tmp_path, monkeypatch):
    from repro_torch.core.config import get_config
    from repro_torch.serve.cache import PagedKVCache
    p = tmp_path / "corrupt.json"
    p.write_text("{this is not json")
    monkeypatch.setenv("REPRO_TUNE_TABLE", str(p))
    assert ttt.active_table() is None
    assert PagedKVCache.default_block_size(
        get_config("smollm-360m").attn) == 16
    assert tsp.choose_schedule(tmk.causal(), 8, Tl=32, Hq=8) in (
        "balanced", "ring", "ulysses")
    ttt.set_table(str(p))
    assert ttt.active_table() is None


def test_off_switch_and_resolution_order(tmp_path, monkeypatch):
    """set_table > REPRO_TUNE_TABLE > the bundled default (none ships:
    no table) ; REPRO_TUNE=off skips every one."""
    assert ttt.platform() == "cpu"
    assert ttt.bundled_default("cpu") is None
    assert ttt.bundled_default("cuda") is None
    assert ttt.active_table() is None
    p = tmp_path / "t.json"
    ttt.TuningTable(sample_table()).save(str(p))
    monkeypatch.setenv("REPRO_TUNE_TABLE", str(p))
    ttt.reset()
    assert ttt.active_table().path == str(p)
    ttt.set_table(None)
    assert ttt.active_table() is None
    ttt.set_table(ttt.TuningTable(sample_table()))
    monkeypatch.setenv("REPRO_TUNE", "off")
    assert ttt.active_table() is None
    monkeypatch.delenv("REPRO_TUNE")
    assert ttt.active_table() is not None


def test_paged_block_size_precedence(monkeypatch):
    """REPRO_TUNE_BLOCK_SIZE > the table's winner for the layout and
    sharding > 16; garbage in the variable is ignored; create takes the
    default only where the caller gives no block size."""
    import types
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.serve.cache import PagedKVCache
    a = get_config("smollm-360m").attn
    mla = get_config("deepseek-v2-lite-16b").attn
    ttt.set_table(ttt.TuningTable(sample_table(paged=[
        dict(layout="mha", sharding="none", block_size=32),
        dict(layout="mha", sharding="pool", block_size=64),
        dict(layout="mla", sharding="none", block_size=8)])))
    mesh = types.SimpleNamespace(size=lambda ax: 4)
    assert PagedKVCache.default_block_size(a) == 32
    assert PagedKVCache.default_block_size(a, mesh, "seq") == 64
    assert PagedKVCache.default_block_size(mla, mesh, "seq") == 8
    monkeypatch.setenv("REPRO_TUNE_BLOCK_SIZE", "8")
    assert PagedKVCache.default_block_size(a) == 8
    monkeypatch.setenv("REPRO_TUNE_BLOCK_SIZE", "banana")
    assert PagedKVCache.default_block_size(a) == 32
    monkeypatch.delenv("REPRO_TUNE_BLOCK_SIZE")
    cfg = smoke_config(get_config("smollm-360m"))
    assert PagedKVCache.create(cfg, n_blocks=4, max_reqs=1,
                               device="cpu").block_size == 32
    assert PagedKVCache.create(cfg, block_size=8, n_blocks=4, max_reqs=1,
                               device="cpu").block_size == 8
    ttt.set_table(None)
    assert PagedKVCache.default_block_size(a) == 16


def test_choose_schedule_table_hit_then_coeffs_then_roofline():
    """A measured row decides (zigzag left out of the candidates), at any
    head count; at an unmeasured P the calibrated coefficients rank, the
    same pick every call; with no table the roofline."""
    ttt.set_table(ttt.TuningTable(sample_table()))
    assert tsp.choose_schedule(tmk.causal(), 8, Tl=256, Hq=8) == "balanced"
    assert tsp.choose_schedule(tmk.causal(), 8, Tl=256, Hq=12,
                               Hkv=12) == "balanced"
    picks = {tsp.choose_schedule(tmk.causal(), 4, Tl=256, Hq=8)
             for _ in range(3)}
    assert len(picks) == 1 and picks <= {"balanced", "ring", "ulysses"}
    assert tsp.choose_schedule(tmk.document(), 4, Tl=256, Hq=8) in (
        "balanced", "ring", "ulysses")
    ttt.set_table(None)
    assert tsp.choose_schedule(tmk.causal(), 1, Tl=64) == "ring"
    assert tsp.choose_schedule(tmk.causal(), 8, Tl=256, Hq=8) in (
        "balanced", "ring", "ulysses")


# ------------------------------------------------------------ calibration

def test_features_fit_and_rank_correlation_equal_the_reference(
        tpu_constants):
    """mask_for_kind, schedule_features (every schedule, both horizons),
    fit_nonneg, spearman and calibrate over the reference CPU table's
    schedule rows: the reference's results."""
    for kind in ("causal", "full", "sliding_window", "document",
                 "prefix_lm"):
        assert tcal.mask_for_kind(kind, T=256).kind == kind
    with pytest.raises(ValueError, match="unknown mask kind"):
        tcal.mask_for_kind("nope", T=8)
    for sched in ("balanced", "ring", "ulysses", "rsa", "zigzag"):
        for kind in ("causal", "sliding_window", "document", "full"):
            for bwd in (False, True):
                kw = dict(mask_kind=kind, P=8, seq=2048, Hq=8,
                          include_bwd=bwd)
                assert tcal.schedule_features(sched, **kw) == \
                    rcal.schedule_features(sched, **kw), (sched, kind)
    assert tcal.schedule_features("rsa", mask_kind="sliding_window", P=8,
                                  seq=2048) is None
    rng = np.random.default_rng(0)
    X = np.hstack([rng.uniform(0.1, 1.0, size=(40, 3)), np.ones((40, 1))])
    y = X @ np.array([2.0, 0.0, 5.0, 0.3])
    w = tcal.fit_nonneg(X, y)
    assert np.all(w >= 0) and float(np.abs(X @ w - y).max()) < 1e-6
    np.testing.assert_array_equal(w, rcal.fit_nonneg(X, y))
    X2 = np.hstack([np.linspace(1, 2, 20)[:, None], np.ones((20, 1))])
    assert np.all(tcal.fit_nonneg(X2, -3.0 * X2[:, 0] + 10.0) >= 0)
    assert tcal.spearman([1, 2, 3, 4], [10, 20, 30, 40]) == \
        pytest.approx(1.0)
    assert tcal.spearman([1, 2, 3, 4], [40, 30, 20, 10]) == \
        pytest.approx(-1.0)
    for a, b in (([1, 2, 4, 3], [1, 2, 3, 4]), ([1, 1, 2], [3, 1, 2])):
        assert tcal.spearman(a, b) == rcal.spearman(a, b)
    rows = json.load(open(CPU_TABLE))["schedule"]
    got, want = tcal.calibrate(rows), rcal.calibrate(rows)
    assert got == want
    with pytest.raises(ValueError, match="at least"):
        tcal.calibrate([])


def test_median_timers():
    calls = []
    us = ttm.timeit_us(lambda: calls.append(1), iters=3)
    assert us >= 0 and len(calls) == 4
    a, b = ttm.timeit_pair(lambda: None, lambda: sum(range(1000)), 3)
    assert a >= 0 and b >= 0
    assert len(ttm.timeit_round_robin([lambda: None] * 3, 2)) == 3
