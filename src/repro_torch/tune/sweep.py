"""Offline sweeps: measure → pick winners → tuning-table rows (port of the
reference ``tune/sweep.py``; the same table document, ``schema_version``
1, written by ``tools/autotune_torch.py``).

Three sweeps, one per tuning surface:

  * :func:`sweep_kernels` — the attention kernels' times.  On the card: the
    ``cuda`` backend (kernels A, C and D) in bf16 at head dims 64, 128,
    160 and the (192, 128) pair, at each seq and mask kind, forward and
    backward, timed by ``tune/timing.timeit_round_robin`` (the mask kinds
    of one shape interleaved).  The port's kernels fix their tiles when
    they are compiled (``kernels/flash_attention.py``: A's bf16 route
    128 × 128, its pair route 128 × 64, C and D 64 × 64), so there is no
    tile to race: each row carries its route's tile as ``block_q`` /
    ``block_kv`` and a one-entry ``sweep`` map.  Choosing tiles is the
    kernels' design, not the table's, and ``TuningTable.best_blocks`` has
    no consumer.  On the CPU: backend ``ref`` (the plain versions) at
    ``block_q = block_kv = T``, as the reference's chunked-lax keeps one
    whole-chunk q block.
  * :func:`sweep_schedules` — ``dist_flash_attn``'s forward wall time for
    every schedule that can serve each (mask kind, seq), on a P-rank world
    started by ``launch/world.spawn`` (``gloo`` on the CPU, ``cuda-ipc``
    on the card: four ranks sharing one card talk at ~16 GB/s, not over
    NVLink, and ``host`` says so).  Each row keeps the whole wall map for
    ``tune/calibrate.calibrate``; a wall is the slowest rank's median.
  * :func:`sweep_paged` — the paged ``block_size`` per kv layout, on a
    serving microtrace (this module's copy of the reference's
    ``benchmarks/serving_bench`` trace, :func:`trace` / :func:`run_trace`)
    through the port's ``Engine``, the pool's token capacity held about
    constant across sizes (``n_blocks = max(tokens // bs, 4) + 1``).

Everything lands in one table document (:mod:`repro_torch.tune.table`);
``smoke`` shrinks shapes and iterations to CPU-test scale.  No table ships
with the port: a bundled one would change ``auto`` and ``block_size`` on
every later run.
"""
from __future__ import annotations

import platform as _platform
import statistics
import subprocess
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.tune.table import SCHEMA_VERSION
from repro_torch.tune.timing import timeit_round_robin, timeit_us


def _card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError):
        return None
    return out[0] if out else None


def host_info(device="cuda") -> dict:
    """Where the table was measured: ``platform`` (``cuda`` or ``cpu``,
    the table's lookup key), torch and CUDA versions, devices, and on the
    card its name and power limit."""
    dev = torch.device(device)
    info = dict(platform="cuda" if dev.type == "cuda" else "cpu",
                torch=torch.__version__, cuda=torch.version.cuda,
                devices=torch.cuda.device_count() if dev.type == "cuda"
                else 1,
                machine=_platform.machine(),
                python=_platform.python_version())
    if dev.type == "cuda":
        info.update(device_name=torch.cuda.get_device_name(dev),
                    nvidia_smi=_card())
    return info


def new_table_data(device="cuda") -> dict:
    return dict(schema_version=SCHEMA_VERSION,
                generated_by="tools/autotune_torch.py",
                host=host_info(device),
                kernel=[], schedule=[], paged=[])


# --------------------------------------------------------------------------
# (a) the attention kernels
# --------------------------------------------------------------------------

def _kernel_masks(T: int) -> Dict[str, object]:
    from repro_torch.core import mask as mk
    return {
        "causal": mk.causal(),
        "sliding_window": mk.sliding_window(max(T // 4, 1)),
        "document": mk.document(boundaries=mk.doc_boundaries(T, 4)),
        "full": mk.full(),
    }


def route_tile(op: str, dtype, D: int, Dv: int) -> tuple:
    """(block_q, block_kv) of the route a call of kernel A (``fwd``) or
    C / D (``bwd``) at head dims (D, Dv) and ``dtype`` takes."""
    from repro_torch.kernels import flash_attention as fa
    if op == "bwd":
        return fa.BLOCK_Q, fa.BLOCK_KV
    if Dv != D or (D in fa.WIDE_DIMS and dtype == torch.bfloat16):
        return fa.PAIR_ROUTES[dtype][2:4]
    block = fa.FWD_ROUTES[dtype][2]
    return block, block


def _kernel_runner(backend, op, q, k, v, do, mask):
    from repro_torch.kernels import registry
    be = registry.get(backend)
    if op == "fwd":
        return lambda: be.fwd(q, k, v, mask=mask)
    o, lse = be.fwd(q, k, v, mask=mask)
    return lambda: be.bwd(q, k, v, o, lse, do, mask=mask)


def kernel_grid(device, smoke: bool = False):
    """(backend, dtype, [(T, D, Dv)], heads, iters) of the kernel sweep on
    ``device``."""
    if torch.device(device).type == "cuda":
        dims = ((64, 64), (128, 128), (160, 160), (192, 128))
        seqs = (2048,) if smoke else (2048, 8192)
        return ("cuda", torch.bfloat16,
                [(T, D, Dv) for D, Dv in dims for T in seqs], 32,
                3 if smoke else 5)
    if smoke:
        return "ref", torch.float32, [(128, 32, 32), (64, 32, 32)], 2, 2
    return ("ref", torch.float32, [(256, 64, 64), (512, 64, 64)], 4, 3)


def sweep_kernels(data: dict, *, smoke: bool = False, device="cuda",
                  log=print, shapes=None) -> None:
    """Time each (mask kind, head dims, seq, op) of :func:`kernel_grid`
    (its (T, D, Dv) list replaced by ``shapes`` when given); append one
    row each to ``data['kernel']`` (module docstring)."""
    backend, dt, grid, H, iters = kernel_grid(device, smoke)
    grid = grid if shapes is None else shapes
    plat = "cuda" if torch.device(device).type == "cuda" else "cpu"
    gen = torch.Generator(device=device).manual_seed(0)
    for T, D, Dv in grid:
        q, k = (torch.randn((1, T, H, D), generator=gen, device=device,
                            dtype=dt) for _ in range(2))
        v, do = (torch.randn((1, T, H, Dv), generator=gen, device=device,
                             dtype=dt) for _ in range(2))
        masks = _kernel_masks(T)
        for op in ("fwd", "bwd"):
            fns = [_kernel_runner(backend, op, q, k, v, do, m)
                   for m in masks.values()]
            med = timeit_round_robin(fns, iters)
            bq, bk = (T, T) if backend == "ref" else route_tile(op, dt, D,
                                                                Dv)
            for kind, us in zip(masks, med):
                data["kernel"].append(dict(
                    backend=backend, platform=plat, mask_kind=kind,
                    head_dim=D, dv=Dv, heads=H, dtype=str(dt).split(".")[1],
                    seq=T, op=op, block_q=bq, block_kv=bk,
                    wall_us=round(us, 1), sweep={f"{bq}x{bk}": round(us, 1)}))
                log(f"kernel {backend:5s} {kind:15s} T={T:5d} D={D}/{Dv} "
                    f"{op}: {bq}x{bk} {us / 1e3:.3f} ms")
        del q, k, v, do


# --------------------------------------------------------------------------
# (b) distributed-schedule wall time (a P-rank world)
# --------------------------------------------------------------------------

SCHEDULES = ("ring", "balanced", "zigzag", "ulysses", "rsa")


def schedule_grid(device, smoke: bool = False, seqs=None) -> dict:
    """The schedule sweep's settings on ``device``: seqs, schedules, mask
    kinds, (B, H, D), dtype, iterations, ranks."""
    if torch.device(device).type == "cuda":
        return dict(seqs=tuple(seqs or (8192, 12288)), scheds=SCHEDULES,
                    regimes=("causal", "document", "sliding_window"),
                    B=1, H=32, D=128, dtype=torch.bfloat16,
                    iters=3, P=4)
    if smoke:
        return dict(seqs=tuple(seqs or (256,)),
                    scheds=("ring", "balanced", "ulysses"),
                    regimes=("causal", "sliding_window"), B=1, H=8, D=16,
                    dtype=torch.float32, iters=2, P=4)
    return dict(seqs=tuple(seqs or (1024, 2048)), scheds=SCHEDULES,
                regimes=("causal", "document", "sliding_window"), B=1, H=8,
                D=64, dtype=torch.float32, iters=3, P=4)


def _global_qkv(N: int, g: dict, device):
    """The sweep's global q, k, v (B, N, H, D) and segment ids (B, N),
    the same on every rank and in the parent (seed 0)."""
    from repro_torch.core import mask as mk
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((g["B"], N, g["H"], g["D"]), generator=gen,
                           device=device, dtype=g["dtype"])
               for _ in range(3))
    bnd = mk.doc_boundaries(N, 8)
    seg = torch.as_tensor(np.tile(mk.segments_from_boundaries(N, bnd),
                                  (g["B"], 1)), device=device)
    return q, k, v, seg.to(torch.int32)


def _regime_mask(regime: str, N: int):
    """(MaskSpec, needs segments, window) of a schedule-sweep regime."""
    from repro_torch.core import mask as mk
    win = N // 8
    return {"causal": (mk.causal(), False, None),
            "document": (mk.document(), True, None),
            "sliding_window": (mk.sliding_window(win), False, win)}[regime]


def _schedule_rank(rank: int, g: dict, device: str, check_seq: int):
    """One rank of the schedule sweep: for every seq, schedule and regime
    its median µs of ``dist_flash_attn``'s forward, and at ``check_seq``
    its output shard with its positions (rank 0 only)."""
    from repro_torch.core.dist_attention import (DistAttnSpec,
                                                 dist_flash_attn,
                                                 shard_positions)
    from repro_torch.launch.mesh import make_local_mesh
    P = g["P"]
    mesh = make_local_mesh(seq=P, device=device)
    comm = mesh.comms["model"]
    walls, outs = {}, {}
    for N in g["seqs"]:
        q, k, v, seg = _global_qkv(N, g, device)
        for sched in g["scheds"]:
            pos = shard_positions(N, P, comm.rank, sched == "zigzag")
            idx = torch.as_tensor(pos, device=device)
            ql, kl, vl, sl = (x[:, idx].contiguous() for x in (q, k, v,
                                                                 seg))
            for regime in g["regimes"]:
                m, needs_seg, _ = _regime_mask(regime, N)
                try:
                    spec = DistAttnSpec(axis="model", axis_size=P,
                                        schedule=sched, mask=m)
                except ValueError:
                    continue             # this schedule cannot serve m
                segs = sl if needs_seg else None
                with torch.no_grad():
                    def run(spec=spec, segs=segs):
                        return dist_flash_attn(ql, kl, vl, spec, comm,
                                               segs)[0]
                    us = timeit_us(run, g["iters"])
                    walls[(regime, N, sched)] = us
                    if N == check_seq:        # every rank runs it
                        o = run().float().cpu()
                        if comm.rank == 0:
                            outs[(regime, sched)] = (o, pos)
        del q, k, v, seg
    return {"rank": comm.rank, "walls": walls, "outs": outs,
            "transport": mesh.transport}


def _plain_rows(q, k, v, seg, mask, needs_seg, pos):
    """The plain attention (``kernels/ref.chunk_attn_ref``) of the global
    q, k, v at query positions ``pos`` (contiguous runs, one call each)."""
    from repro_torch.kernels.ref import chunk_attn_ref
    pos = np.asarray(pos)
    cuts = np.flatnonzero(np.diff(pos) != 1) + 1
    out = []
    for run in np.split(pos, cuts):
        lo, hi = int(run[0]), int(run[-1]) + 1
        kw = dict(q_segments=seg[:, lo:hi], kv_segments=seg) \
            if needs_seg else {}
        out.append(chunk_attn_ref(q[:, lo:hi], k, v,
                                  mask=mask.replace(q_offset=lo), **kw)[0])
    return torch.cat(out, dim=1)


def sweep_schedules(data: dict, *, smoke: bool = False, log=print,
                    seqs: Optional[Sequence[int]] = None, device="cuda",
                    timeout: float = 600.0, check: bool = True) -> dict:
    """Time ``dist_flash_attn``'s forward per (mask kind, seq) for every
    capable schedule on a P-rank world; append one row per (mask kind,
    seq) with the whole wall map.  With ``check``, rank 0's output of
    every timed schedule at the first seq is held to the plain attention
    over the whole sequence: returns ``{(regime, schedule): max |Δ|}``."""
    from repro_torch.launch.world import spawn
    g = schedule_grid(device, smoke, seqs)
    res = spawn(_schedule_rank, g["P"], (g, str(device), g["seqs"][0]),
                device=device, timeout=timeout, threads=1)
    transport = res[0]["transport"]
    data["host"]["schedule_transport"] = transport
    data["host"]["schedule_ranks"] = g["P"]
    if torch.device(device).type == "cuda":
        data["host"]["schedule_note"] = (
            f"{g['P']} ranks share one card over {transport}: transfers at "
            f"CUDA IPC rates, not NVLink")
    bpe = torch.tensor([], dtype=g["dtype"]).element_size()
    rows: Dict[tuple, dict] = {}
    for (regime, N, sched) in res[0]["walls"]:
        us = max(r["walls"][(regime, N, sched)] for r in res)
        _, needs_seg, win = _regime_mask(regime, N)
        row = rows.setdefault((regime, N), dict(
            mask_kind=regime, P=g["P"], seq=N, B=g["B"], Hq=g["H"],
            Hkv=g["H"], Dqk=g["D"], bpe=bpe, window=win,
            dynamic_seg=needs_seg, best=None, wall_us={}))
        row["wall_us"][sched] = round(us, 1)
    for key in sorted(rows):
        row = rows[key]
        row["best"] = min(row["wall_us"], key=row["wall_us"].get)
        data["schedule"].append(row)
        log(f"schedule {row['mask_kind']:15s} seq={row['seq']:6d}: best "
            f"{row['best']} " + " ".join(
                f"{s}={u / 1e3:.2f}ms"
                for s, u in sorted(row["wall_us"].items())))
    errs = {}
    if check:
        N = g["seqs"][0]
        q, k, v, seg = _global_qkv(N, g, device)
        for (regime, sched), (o, pos) in sorted(res[0]["outs"].items()):
            m, needs_seg, _ = _regime_mask(regime, N)
            ref = _plain_rows(q, k, v, seg, m, needs_seg, pos)
            errs[(regime, sched)] = float((o.to(ref.device)
                                           - ref.float()).abs().max())
        del q, k, v, seg
    return errs


# --------------------------------------------------------------------------
# (c) paged-decode block size
# --------------------------------------------------------------------------

def trace(rng, n_requests, prompt_lens, budgets, mean_gap):
    """The reference's seeded arrival trace (``benchmarks/serving_bench.
    _trace``): (arrive_step, prompt_len, n_new, temperature) a request."""
    t = 0
    out = []
    for _ in range(n_requests):
        t += int(rng.poisson(mean_gap))
        out.append((t, int(rng.choice(prompt_lens)),
                    int(rng.choice(budgets)),
                    float(rng.choice([0.0, 0.0, 0.8]))))
    return out


def trace_blocks(bs: int, tokens: int = 17 * 8) -> int:
    """Pool blocks at block size ``bs`` for about ``tokens`` of capacity
    (the trace's default pool of 17 blocks of 8), the null block
    included."""
    return max(tokens // bs, 4) + 1


def paged_model(arch: str, smoke: bool, device, seed: int = 0):
    """(model, params, cfg) of ``arch`` on one process (its smoke config
    with ``smoke``), weights from ``seed``."""
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    model = build_model(cfg, device)
    return model, model.init(seed=seed), cfg


def run_trace(model, params, *, block_size=8, n_blocks=17, n_requests=8,
              max_batch=4, prompt_lens=(16, 24, 32), budgets=(6, 10, 14),
              mean_gap=1, seed=0, greedy=False, log=None) -> dict:
    """The reference's ``run_trace`` on the port's ``Engine``: warm the
    chunk shapes, then replay :func:`trace` (``greedy``: every request at
    temperature 0), one engine step a trace step.  Returns tokens/s, token
    latencies, TTFT, steps, preemptions, each request's stream, and
    whether each got its whole budget."""
    from repro_torch.core.config import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.serve.engine import Engine
    cfg = model.cfg
    shape = ShapeSpec("bench", max(prompt_lens), max(4, n_requests),
                      "prefill")
    prompts = SyntheticTokens(cfg, shape, device="cpu").batch(0)[
        "tokens"].numpy()
    tr = trace(np.random.default_rng(seed), n_requests, prompt_lens,
               budgets, mean_gap)
    eng = Engine(model, params, max_batch=max_batch, block_size=block_size,
                 n_blocks=n_blocks)
    eng.warm_prefill(max(prompt_lens) + max(budgets))
    w = eng.submit(prompts[0][:prompt_lens[0]], max_new_tokens=2)
    eng.run()
    del eng.requests[w]
    warm_steps = eng.sched.step_count
    warm_preempt = eng.sched.n_preemptions
    submit_t, first_t, token_ms, rids = {}, {}, [], []
    step = i = 0
    t_start = time.perf_counter()
    while tr[len(rids):] or not eng.sched.idle:
        while len(rids) < len(tr) and tr[len(rids)][0] <= step:
            _, plen, n_new, temp = tr[len(rids)]
            r = eng.submit(prompts[i % len(prompts)][:plen],
                           max_new_tokens=n_new,
                           temperature=0.0 if greedy else temp, seed=i)
            submit_t[r] = time.perf_counter()
            rids.append(r)
            i += 1
        t0 = time.perf_counter()
        events = eng.step()
        dt_ms = (time.perf_counter() - t0) * 1e3
        n_tok = sum(len(v) for v in events.values())
        for r, toks in events.items():
            if r not in first_t and toks:
                first_t[r] = time.perf_counter()
            token_ms.extend([dt_ms / max(n_tok, 1)] * len(toks))
        step += 1
        if step > 100_000:
            raise RuntimeError("trace did not drain")
    if torch.device(model.device).type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.perf_counter() - t_start
    streams = [list(eng.requests[r].emitted) for r in rids]
    total = sum(len(s) for s in streams)
    ttft = sorted((first_t[r] - submit_t[r]) * 1e3 for r in rids
                  if r in first_t)
    stats = eng.stats()
    return {"total_tokens": total, "wall_s": wall,
            "tokens_per_s": total / wall,
            "p50_token_ms": statistics.median(token_ms),
            "ttft_p50_ms": ttft[len(ttft) // 2],
            "steps": stats["steps"] - warm_steps,
            "preemptions": stats["n_preemptions"] - warm_preempt,
            "streams": streams,
            "full_budgets": [len(s) == t[2] for s, t in zip(streams, tr)]}


def paged_grid(device, smoke: bool = False) -> dict:
    """The paged sweep's archs, block sizes and trace on ``device``."""
    kw = dict(n_requests=8, max_batch=4, prompt_lens=(16, 24, 32),
              budgets=(6, 10, 14), mean_gap=1, seed=0)
    if smoke:
        return dict(archs=("smollm-360m",), sizes=(8, 16), smoke=True,
                    kw=dict(n_requests=3, max_batch=2, prompt_lens=(8, 12),
                            budgets=(3, 5), mean_gap=1, seed=0))
    if torch.device(device).type == "cuda":
        return dict(archs=("smollm-360m", "deepseek-v2-lite-16b"),
                    sizes=(8, 16, 32, 64), smoke=False,
                    kw=dict(kw, greedy=True))
    return dict(archs=("smollm-360m", "deepseek-v2-lite-16b"),
                sizes=(4, 8, 16, 32), smoke=True, kw=kw)


def sweep_paged(data: dict, *, smoke: bool = False, device="cuda",
                log=print) -> dict:
    """Race paged block sizes per kv layout on the serving microtrace; the
    pool's token capacity is held about constant, so the sizes differ
    only in granularity (allocation pressure, padding), not in memory.
    Appends one row per arch to ``data['paged']``; returns each arch's
    ``{block size: run_trace result}``."""
    g = paged_grid(device, smoke)
    out = {}
    for arch in g["archs"]:
        model, params, cfg = paged_model(arch, g["smoke"], device)
        layout = "mla" if cfg.attn.is_mla else "mha"
        meas = {}
        for bs in g["sizes"]:
            meas[bs] = run_trace(model, params, block_size=bs,
                                 n_blocks=trace_blocks(bs), **g["kw"])
            log(f"paged {arch} ({layout}) block_size={bs}: "
                f"{meas[bs]['tokens_per_s']:.1f} tok/s, "
                f"{meas[bs]['preemptions']} preemptions")
        del model, params
        tps = {b: float(r["tokens_per_s"]) for b, r in meas.items()}
        best = max(tps, key=lambda b: (tps[b], -b))
        data["paged"].append(dict(
            layout=layout, sharding="none", arch=arch, block_size=best,
            tokens_per_s=round(tps[best], 2),
            sweep={str(b): round(t, 2) for b, t in sorted(tps.items())}))
        log(f"paged {arch} ({layout}): best block_size={best}")
        out[arch] = meas
    return out


# --------------------------------------------------------------------------

def check_roundtrip(tab, log=print) -> None:
    """Every winner of ``tab`` (a ``TuningTable``) must come back out of
    its lookups; a calibrated table must predict a time."""
    from repro_torch.tune import calibrate as cal
    for r in tab.data["kernel"]:
        got = tab.best_blocks(backend=r["backend"], platform=r["platform"],
                              mask_kind=r["mask_kind"],
                              head_dim=r["head_dim"], seq=r["seq"],
                              op=r["op"])
        if got != (r["block_q"], r["block_kv"]):
            raise AssertionError(f"kernel row {r} lookup returned {got}")
    for r in tab.data["schedule"]:
        got = tab.best_schedule(mask_kind=r["mask_kind"], P=r["P"],
                                seq=r["seq"])
        if got != r["best"]:
            raise AssertionError(f"schedule row {r} lookup returned {got}")
    for r in tab.data["paged"]:
        got = tab.best_block_size(layout=r["layout"], sharding=r["sharding"])
        if got != r["block_size"]:
            raise AssertionError(f"paged row {r} lookup returned {got}")
    if tab.coeffs() is not None:
        feats = cal.schedule_features("ring", mask_kind="causal", P=4,
                                      seq=8192)
        if not cal.predict_s(feats, tab.coeffs()) >= 0.0:
            raise AssertionError("calibrated table predicts no time")
    log(f"roundtrip OK: {len(tab.data['kernel'])} kernel, "
        f"{len(tab.data['schedule'])} schedule, "
        f"{len(tab.data['paged'])} paged rows"
        + (", calibrated" if tab.coeffs() else ""))


def run_sweep(*, smoke: bool = False, parts=("kernel", "schedule", "paged"),
              seqs: Optional[Sequence[int]] = None, device="cuda",
              log=print, timeout: float = 600.0) -> dict:
    """Run the requested sweeps on ``device`` into a fresh table
    document."""
    data = new_table_data(device)
    if "kernel" in parts:
        sweep_kernels(data, smoke=smoke, device=device, log=log)
    if "schedule" in parts:
        sweep_schedules(data, smoke=smoke, log=log, seqs=seqs,
                        device=device, timeout=timeout, check=False)
    if "paged" in parts:
        sweep_paged(data, smoke=smoke, device=device, log=log)
    return data
