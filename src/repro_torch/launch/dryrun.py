"""Dry-run on the ``meta`` device: one rank's step of every (architecture ×
input shape) on the production mesh, at full size and full depth, with its
FLOPs, bytes, collectives and memory counted as PyTorch dispatches it (port
of the reference ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k [--multi-pod] [--schedule balanced] [--out f.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every pair

The model is built on ``meta`` (no memory, no data) over the production
mesh's meta view (``launch/mesh.make_production_mesh``: Comms of the
production sizes that move nothing and count what they would move), its
inputs from ``data/pipeline.input_specs``, and one step runs eagerly:

  * ``train``: on FSDP shards (the model built with ``fsdp=True``: the
    parameters and moments are one rank's shards over ``pod`` × ``data``,
    each weight gathered on use and its gradient reduce-scattered, as
    the reference's step runs on ``param_shardings``), ``model.loss``,
    ``torch.autograd.grad``, the gradient sums
    over the ranks (``train/step.sum_over``), the world-wide non-finite
    flag's max, then ``optim/adamw.update`` — ``train/step``'s step without
    its host branch on the flag (a meta tensor holds no value; the
    reference's jitted step has no host branch either);
  * ``prefill``: ``model.prefill``; ``decode``: ``model.decode`` over the
    dense cache, both on whole (replicated) weights, as the port's engines
    serve (the reference's dry-run shards these too).

A run that finishes proves the per-rank shapes, the plan and the
collectives coherent, as the reference's ``.lower().compile()`` does.
``long_500k`` runs the attention families under the reference's Appendix-F
window of 8,192 (:data:`LONG_CTX_WINDOW`).

Eager PyTorch runs every layer, so the counts need none of the reference's
affine fit over reduced depths (its ``_knob_points`` / ``extrapolate_costs``,
there because XLA's cost analysis counts a scan body once).  The record's
keys, against the reference's:

  ==================================  ====================================
  port                                reference
  ==================================  ====================================
  ``flops`` (impl ``ref``, as run)    ``hlo_flops`` (extrapolated)
  ``bytes_accessed``                  ``hlo_bytes``
  ``flops_by_op``                     —
  ``collectives`` (``MetaComm``)      ``collectives`` (``collective_stats``
                                      of the optimized HLO)
  ``memory`` (live storage's peak)    ``memory`` (``memory_analysis``)
  ``adjusted`` (impl ``null`` +       ``adjusted`` (the same)
  ``attention_analytic``)
  ``roofline_as_run``, ``roofline``   ``roofline_as_lowered``,
  (H100 constants)                    ``roofline`` (TPU v5e constants)
  ``build_s``, ``run_s``              ``lower_s``, ``compile_s``
  ``model_coords``, ``flops_by_coord``  — (SPMD: one program)
  ==================================  ====================================

**Ranks.** A rank's work depends on its place in the sequence group (a
causal ring's last rank does the most), so the counts come from two
``model`` coordinates at ``data`` 0, the first and the last, and the
record keeps the larger (``flops_by_coord`` lists both); every
coordinate would cost 16 full-size runs a pair.  The multi-pod pass runs
coordinate 0 alone and reports its memory and collectives, as the
reference's multi-pod pass reports memory and compile success.

The adjusted figures swap the attention for the ``null`` backend (O(T), its
collectives intact) and add the kernels' analytic cost; the plain path
materialises O(T²) scores that a flash kernel never writes.  A decode step
attends through the plain float32 ``dist_decode_attn``, not a registry
backend, so its adjusted figures are its as-run ones (its
``attention_analytic`` is reported beside them); so are an SSM's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.analysis import roofline as R
from repro_torch.analysis.meta_count import as_dict, counting
from repro_torch.core.config import (ARCH_IDS, PAPER_ARCH_IDS, SHAPES,
                                     TrainConfig, get_config, get_shape,
                                     smoke_config)
from repro_torch.core.tree import flatten
from repro_torch.data.pipeline import input_specs
from repro_torch.launch.mesh import make_meta_mesh, make_production_mesh
from repro_torch.models.transformer import build_model, trainable
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import batch_group, make_parallel_config
from repro_torch.train.step import leaf_groups, sum_over

LONG_CTX_WINDOW = 8192   # the reference's Appendix-F window for long_500k


def meta_mesh(multi_pod: bool = False, shape=None, rank: int = 0):
    """The production mesh's meta view (``shape`` None), or a meta mesh of
    ``shape``: (data, model), or (pod, data, model)."""
    if shape is None:
        return make_production_mesh(multi_pod, rank=rank)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return make_meta_mesh(names, shape, rank=rank)


def _config(arch: str, shape_name: str, smoke: bool = False):
    """The arch's config (its smoke config with ``smoke``), under the
    Appendix-F window at ``long_500k`` for the attention families."""
    cfg = get_config(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    if shape_name == "long_500k" and cfg.uses_attention:
        cfg = cfg.replace(attn=dataclasses.replace(cfg.attn,
                                                   window=LONG_CTX_WINDOW))
    return cfg


def _train_step(model, tc: TrainConfig):
    """``train/step.make_train_step``'s step with no host read: the
    update always runs."""
    def step(params, opt, batch):
        ps, rebuild = flatten(params)
        loss, _ = model.loss(params, batch)
        groups = leaf_groups(model, params)
        grads = sum_over(torch.autograd.grad(loss, ps),
                         [sg for sg, _ in groups])
        finite = torch.isfinite(loss.detach())
        for g in grads:
            finite &= torch.isfinite(g).all()
        if model.mesh is not None and model.mesh.world.size > 1:
            model.mesh.world.all_reduce_([(~finite).float().reshape(1)],
                                         op="max")
        adamw.update(rebuild(grads), opt, params, tc,
                     groups=[ng for _, ng in groups])
        return loss
    return step


def prepare(arch: str, shape_name: str, mesh, *, schedule="balanced",
            remat="remat_aware", impl="ref", latent_ring=False,
            smoke=False):
    """(cfg, shape, step, live): :func:`build_step` of the pair on
    ``mesh``."""
    cfg = _config(arch, shape_name, smoke)
    shape = get_shape(shape_name)
    step, live = build_step(cfg, shape, mesh, schedule=schedule,
                            remat=remat, impl=impl, latent_ring=latent_ring)
    return cfg, shape, step, live


def build_step(cfg, shape, mesh, *, schedule="balanced",
               remat="remat_aware", impl="ref", latent_ring=False,
               device="meta"):
    """(step, live): the model of ``cfg`` on ``device`` over ``mesh``,
    ``step()`` one rank's step of ``shape.kind``, ``live`` the trees of
    tensors it starts from (parameters, optimizer moments, batch, cache).
    The inputs are :func:`~repro_torch.data.pipeline.input_specs`'
    (values undefined: ``meta`` is where they are meant)."""
    par = make_parallel_config(mesh, shape, schedule=schedule, remat=remat)
    model = build_model(cfg, device, par=par, impl=impl, mesh=mesh,
                        latent_ring=latent_ring,
                        fsdp=shape.kind == "train")
    batch = input_specs(cfg, shape, par, mesh, device)
    if shape.kind == "train":
        params = trainable(model.init())
        opt = adamw.init(params)
        run = _train_step(model, TrainConfig())
        return (lambda: run(params, opt, batch),
                (params, opt.m, opt.v, batch))
    params = model.init()
    if shape.kind == "prefill":
        extra = [v for k, v in batch.items() if k != "tokens"]
        return (lambda: model.prefill(params, batch["tokens"], *extra),
                (params, batch))
    return (lambda: model.decode(params, batch["cache"], batch["token"],
                                 batch["pos"]), (params, batch))


def measure(arch, shape_name, *, multi_pod=False, rank=0,
            schedule="balanced", remat="remat_aware", impl="ref",
            latent_ring=False, smoke=False, mesh_shape=None) -> dict:
    """One rank's step counted: FLOPs, bytes, memory, collectives."""
    mesh = meta_mesh(multi_pod, mesh_shape, rank)
    t0 = time.perf_counter()
    cfg, shape, step, live = prepare(arch, shape_name, mesh,
                                     schedule=schedule, remat=remat,
                                     impl=impl, latent_ring=latent_ring,
                                     smoke=smoke)
    t1 = time.perf_counter()
    counts = mesh.world.counts
    counts.reset()
    with counting(*live) as c:
        out = step()
        del out
    t2 = time.perf_counter()
    res = as_dict(c)
    res.update(collectives=counts.as_dict(), build_s=t1 - t0, run_s=t2 - t1)
    return res


def _memory(m: dict) -> dict:
    """The reference's ``memory`` keys from a count: arguments (the
    tensors the step starts from), outputs (storage still alive after it
    that it made), temporaries (the peak above the arguments)."""
    return {"argument_bytes": m["tracked_bytes"],
            "output_bytes": max(m["end_bytes"] - m["tracked_bytes"], 0),
            "temp_bytes": m["peak_bytes"] - m["tracked_bytes"],
            "peak_device_bytes": m["peak_bytes"]}


def _coords(mesh):
    """The global ranks at ``data`` 0 of the first and the last ``model``
    coordinate."""
    return sorted({0, mesh.size("model") - 1})


def worker_pool(jobs: int):
    """A pool of ``jobs`` fresh worker processes (each run is one Python
    thread of meta dispatch: full-size steps take 5-25 s on a CPU)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=jobs, mp_context=multiprocessing.get_context("spawn"))


def _measure_kw(kw):
    torch.set_num_threads(1)
    return measure(**kw)


def _plan(arch, shape_name, *, multi_pod=False, schedule="balanced",
          remat="remat_aware", latent_ring=False, smoke=False,
          mesh_shape=None):
    """The measure() keyword sets of one pair's record: each counted
    ``model`` coordinate with impl ``ref``, then with ``null`` where the
    adjusted figures need it."""
    kw = dict(arch=arch, shape_name=shape_name, multi_pod=multi_pod,
              schedule=schedule, remat=remat, latent_ring=latent_ring,
              smoke=smoke, mesh_shape=mesh_shape)
    if multi_pod:
        return [kw]
    cs = _coords(meta_mesh(multi_pod, mesh_shape))
    tasks = [dict(kw, rank=c) for c in cs]
    if _adjusts(_config(arch, shape_name, smoke), get_shape(shape_name)):
        tasks += [dict(kw, rank=c, impl="null") for c in cs]
    return tasks


def _adjusts(cfg, shape) -> bool:
    return cfg.uses_attention and shape.kind != "decode"


def _record(tasks, got) -> dict:
    """One pair's record (module docstring) from its measure() runs."""
    kw = tasks[0]
    arch, shape_name = kw["arch"], kw["shape_name"]
    mesh = meta_mesh(kw["multi_pod"], kw["mesh_shape"])
    chips = mesh.world.size
    cfg = _config(arch, shape_name, kw["smoke"])
    shape = get_shape(shape_name)
    head = {"arch": arch, "shape": shape_name, "schedule": kw["schedule"],
            "remat": kw["remat"], "multi_pod": kw["multi_pod"],
            "chips": chips, "kind": shape.kind, "smoke": kw["smoke"],
            "mesh": dict(zip(mesh.axis_names, mesh.shape)),
            "window": None if cfg.attn is None else cfg.attn.window}
    if kw["multi_pod"]:
        m, = got
        return {**head, "build_s": m["build_s"], "run_s": m["run_s"],
                "model_coords": [0], "memory": _memory(m),
                "collectives": m["collectives"], "ran_ok": True}
    refs = [(t["rank"], g) for t, g in zip(tasks, got)
            if t.get("impl", "ref") == "ref"]
    runs = dict(refs)
    worst = max(runs, key=lambda c: (runs[c]["flops"],
                                     runs[c]["peak_bytes"]))
    m = runs[worst]
    flops, bytes_acc = float(m["flops"]), float(m["bytes_accessed"])
    coll = m["collectives"]
    par = make_parallel_config(mesh, shape, schedule=kw["schedule"],
                               remat=kw["remat"])
    bg = batch_group(mesh, par)
    an_f, an_b = R.attention_analytic(
        cfg, shape, seq_shards=mesh.comm(tuple(
            a for a in mesh.axis_names if a in par.seq_axes)).size,
        batch_shards=1 if bg is None else bg.size)
    if _adjusts(cfg, shape):
        n = max(got[len(refs):], key=lambda r: r["flops"])
        adj_f, adj_b = n["flops"] + an_f, n["bytes_accessed"] + an_b
        adj_c = n["collectives"]["total_bytes"]
    else:
        adj_f, adj_b, adj_c = flops, bytes_acc, coll["total_bytes"]
    mf = R.model_flops(cfg, shape, chips=chips)
    return {
        **head,
        "build_s": m["build_s"],
        "run_s": sum(r["run_s"] for r in got),
        "model_coords": sorted(runs),
        "flops_by_coord": {str(c): r["flops"] for c, r in runs.items()},
        "memory": _memory(m),
        "flops": flops,
        "bytes_accessed": bytes_acc,
        "flops_by_op": m["flops_by_op"],
        "collectives": coll,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "attention_analytic": {"flops": an_f, "bytes": an_b},
        "roofline_as_run": R.roofline_terms(flops, bytes_acc,
                                            coll["total_bytes"]),
        "roofline": R.roofline_terms(adj_f, adj_b, adj_c),
        "adjusted": {"flops": adj_f, "bytes": adj_b, "coll_bytes": adj_c,
                     "useful_flops_ratio": (mf / adj_f) if adj_f else None},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def submit_many(ex, pairs, **kw):
    """Submit every run of several (arch, shape) pairs to the process pool
    ``ex`` (``kw`` as :func:`run_one`'s) and return ``collect()``, which
    waits for them and gives the pairs' records."""
    plans = [_plan(a, s, **kw) for a, s in pairs]
    futs = [[ex.submit(_measure_kw, t) for t in p] for p in plans]
    return lambda: [_record(p, [f.result() for f in fs])
                    for p, fs in zip(plans, futs)]


def run_many(pairs, *, jobs: int = 1, **kw) -> list:
    """The records of several (arch, shape) pairs, every run of all of
    them in one pool of ``jobs`` worker processes."""
    if jobs <= 1:
        return [_record(p, [measure(**t) for t in p])
                for p in (_plan(a, s, **kw) for a, s in pairs)]
    with worker_pool(jobs) as ex:
        return submit_many(ex, pairs, **kw)()


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            schedule="balanced", remat="remat_aware", latent_ring=False,
            jobs: int = 1, smoke: bool = False, mesh_shape=None) -> dict:
    """The record of one (arch × shape) pair (module docstring); its runs
    in ``jobs`` processes.  ``smoke`` takes the arch's smoke config and
    ``mesh_shape`` a meta mesh of that shape (tests, quick drives)."""
    return run_many([(arch, shape_name)], jobs=jobs, multi_pod=multi_pod,
                    schedule=schedule, remat=remat, latent_ring=latent_ring,
                    smoke=smoke, mesh_shape=mesh_shape)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + PAPER_ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--schedule", default="balanced",
                    choices=("balanced", "ring", "rsa", "zigzag",
                             "ulysses"))
    ap.add_argument("--remat", default="remat_aware",
                    choices=("remat_aware", "hf", "none"))
    ap.add_argument("--latent-ring", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--mesh", default=None,
                    help="a meta mesh's shape, e.g. 2,4 (data, model); "
                         "default the production mesh")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for a pair's runs")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) in subprocesses")
    ap.add_argument("--results-dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        return run_all(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                  schedule=args.schedule, remat=args.remat,
                  latent_ring=args.latent_ring, jobs=args.jobs,
                  smoke=args.smoke,
                  mesh_shape=None if args.mesh is None else tuple(
                      int(x) for x in args.mesh.split(",")))
    js = json.dumps(rec, indent=1)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)
    return 0


def run_all(args):
    """Every (arch × shape), single pod then multi-pod, each in its own
    process; a pair whose record exists is skipped.  Prints the failures
    and each pair's seconds."""
    os.makedirs(args.results_dir, exist_ok=True)
    fails = []
    t_all = time.perf_counter()
    for multi_pod in (False, True):
        for arch in ARCH_IDS:
            for shape in SHAPES:
                tag = f"{'pod2' if multi_pod else 'pod1'}_{arch}_{shape}"
                out = os.path.join(args.results_dir, tag + ".json")
                if os.path.exists(out):
                    print(f"[skip] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", out,
                       "--schedule", args.schedule, "--remat", args.remat,
                       "--jobs", str(args.jobs)]
                if multi_pod:
                    cmd.append("--multi-pod")
                t0 = time.perf_counter()
                r = subprocess.run(cmd, capture_output=True, text=True)
                dt = time.perf_counter() - t0
                if r.returncode != 0:
                    fails.append(tag)
                    print(f"[FAIL] {tag} ({dt:.1f} s)\n{r.stderr[-2000:]}",
                          flush=True)
                else:
                    print(f"[ok  ] {tag} ({dt:.1f} s)", flush=True)
    print(f"done in {time.perf_counter() - t_all:.1f} s; {len(fails)} "
          f"failures: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
