#!/usr/bin/env python
"""The port's autotuner CLI: sweep → tuning table → calibrate → inspect
(``repro_torch.tune``; the reference's ``tools/autotune.py``).

    PYTHONPATH=src python tools/autotune_torch.py sweep [--smoke] [--out F]
        [--parts kernel,schedule,paged] [--seqs 8192,12288] [--calibrate]
        [--check-roundtrip] [--device cuda|cpu]
    PYTHONPATH=src python tools/autotune_torch.py calibrate --table F [--out F2]
    PYTHONPATH=src python tools/autotune_torch.py show [--table F]
    PYTHONPATH=src python tools/autotune_torch.py diff TABLE_A TABLE_B

``sweep`` times the kernels, the distributed schedules and the paged block
sizes on ``--device`` (the card by default; ``--device cpu`` times the
plain versions on a gloo world) and writes a schema-versioned JSON table
(``repro_torch/tune/sweep.py``).  A missing card is an error, not a
fallback.  ``calibrate`` fits the schedule cost model's coefficients to a
table's rows.  ``--check-roundtrip`` reloads the table and asserts every
winner comes back out of the lookups.  No table ships with the port: load
one with ``REPRO_TUNE_TABLE=<path>``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.tune import calibrate as cal  # noqa: E402
from repro_torch.tune.table import TuningTable, active_table  # noqa: E402


def _load(path):
    return TuningTable.load(path)      # raises TableError with the reason


def cmd_sweep(args) -> int:
    from repro_torch.tune.sweep import check_roundtrip, run_sweep
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("sweep: no CUDA device (use --device cpu to time the plain "
              "versions)", file=sys.stderr)
        return 2
    parts = tuple(p for p in args.parts.split(",") if p)
    seqs = tuple(int(s) for s in args.seqs.split(",")) if args.seqs else None
    data = run_sweep(smoke=args.smoke, parts=parts, seqs=seqs,
                     device=args.device)
    if args.calibrate:
        if data["schedule"]:
            data["calibration"] = cal.calibrate(data["schedule"])
        else:
            print("calibrate: no schedule rows swept, skipping",
                  file=sys.stderr)
    tab = TuningTable(data)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    tab.save(args.out)
    print(f"wrote {args.out}")
    if args.check_roundtrip:
        check_roundtrip(_load(args.out))
    return 0


def cmd_calibrate(args) -> int:
    tab = _load(args.table)
    if not tab.data["schedule"]:
        print("no schedule rows in table — run `sweep` with the schedule "
              "part first", file=sys.stderr)
        return 1
    tab.data["calibration"] = cal.calibrate(tab.data["schedule"])
    out = args.out or args.table
    tab.save(out)
    fit = tab.fit()
    print(f"wrote {out}: spearman={fit['spearman']} "
          f"(roofline {fit['spearman_roofline']}), "
          f"best-match {fit['best_match']} "
          f"(roofline {fit['best_match_roofline']}), "
          f"rel_rms={fit['rel_rms']} over {fit['n_points']} points")
    return 0


def cmd_show(args) -> int:
    tab = _load(args.table) if args.table else active_table()
    if tab is None:
        print("no active tuning table (set REPRO_TUNE_TABLE or pass "
              "--table)", file=sys.stderr)
        return 1
    h = tab.data.get("host", {})
    print(f"table: {tab.path or '<memory>'}  (platform={h.get('platform')}, "
          f"torch={h.get('torch')}, card={h.get('nvidia_smi')}, schedule "
          f"transport={h.get('schedule_transport')})")
    for r in tab.data["kernel"]:
        print(f"  kernel   {r['backend']:5s} {r['mask_kind']:15s} "
              f"seq={r['seq']:5d} D={r['head_dim']:3d} {r['op']}: "
              f"{r['block_q']}x{r['block_kv']} "
              f"{r.get('wall_us', 0) / 1e3:.3f} ms")
    for r in tab.data["schedule"]:
        walls = " ".join(f"{s}={u / 1e3:.2f}ms"
                         for s, u in sorted(r["wall_us"].items()))
        print(f"  schedule {r['mask_kind']:15s} P={r['P']} "
              f"seq={r['seq']:6d}: best={r['best']}  {walls}")
    for r in tab.data["paged"]:
        print(f"  paged    {r['layout']:4s} sharding={r['sharding']}: "
              f"block_size={r['block_size']}")
    fit = tab.fit()
    if fit:
        print(f"  calibration: spearman={fit.get('spearman')} "
              f"(roofline {fit.get('spearman_roofline')}), "
              f"best-match {fit.get('best_match')} "
              f"(roofline {fit.get('best_match_roofline')})")
    return 0


def cmd_diff(args) -> int:
    a, b = _load(args.table_a), _load(args.table_b)

    def key_map(rows, keys):
        return {tuple(r.get(k) for k in keys): r for r in rows}

    n = 0
    specs = [("kernel", ("backend", "platform", "mask_kind", "head_dim",
                         "seq", "op"), ("block_q", "block_kv")),
             ("schedule", ("mask_kind", "P", "seq"), ("best",)),
             ("paged", ("layout", "sharding"), ("block_size",))]
    for section, keys, vals in specs:
        ma = key_map(a.data[section], keys)
        mb = key_map(b.data[section], keys)
        for k in sorted(set(ma) | set(mb), key=str):
            ra, rb = ma.get(k), mb.get(k)
            va = tuple(ra[v] for v in vals) if ra else None
            vb = tuple(rb[v] for v in vals) if rb else None
            if va != vb:
                n += 1
                print(f"  {section} {k}: {va} -> {vb}")
    ca, cb = a.coeffs(), b.coeffs()
    if ca != cb:
        n += 1
        print(f"  calibration: {json.dumps(ca)} -> {json.dumps(cb)}")
    print(f"{n} difference(s)" if n else "tables agree")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sweep", help="measure and persist a tuning table")
    sp.add_argument("--smoke", action="store_true",
                    help="small shapes / few iterations")
    sp.add_argument("--out", default="tuning_table.json")
    sp.add_argument("--parts", default="kernel,schedule,paged",
                    help="comma list of sweeps to run")
    sp.add_argument("--seqs", default=None,
                    help="comma list of schedule-sweep seq lengths")
    sp.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    sp.add_argument("--calibrate", action="store_true",
                    help="fit cost-model coefficients after sweeping")
    sp.add_argument("--check-roundtrip", action="store_true",
                    help="assert persisted winners survive lookup")
    sp.set_defaults(fn=cmd_sweep)

    cp = sub.add_parser("calibrate",
                        help="(re)fit coefficients on an existing table")
    cp.add_argument("--table", required=True)
    cp.add_argument("--out", default=None)
    cp.set_defaults(fn=cmd_calibrate)

    hp = sub.add_parser("show", help="print a table (default: active)")
    hp.add_argument("--table", default=None)
    hp.set_defaults(fn=cmd_show)

    dp = sub.add_parser("diff", help="compare two tables' winners")
    dp.add_argument("table_a")
    dp.add_argument("table_b")
    dp.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
