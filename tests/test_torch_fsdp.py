"""FSDP (ZeRO-3 over ``pod`` × ``data``): the port's layout, gathers and
train step against the reference's (``parallel/sharding.param_spec``,
``train/step.init_sharded`` + ``jit_train_step``) and against its own
single process.

The reference side is one JAX process on 512 forced host devices with
Auto-axis meshes (``_torch_fsdp_cases.REFERENCE``); the port's side one
4-rank ``gloo`` world on one torch thread a rank.  Each has a time limit
of its own.  Bars: the reference's — a mesh's first loss within
``5e-3·max(1, |loss|)`` of the reference's, 3-step trajectories within
2e-3 (``tests/test_torch_dist_train.py``); parameters after the steps
against the port's one process (and the reference's) at a tenth of
the learning rate where the gradients are clear of rounding
(:func:`_check_params`), gradient norms within float32 rounding of the
reduce-scatter's sums (:data:`GNORM_REL`), gradients within the
distributed-gradient bar 5e-5 (``tests/test_dist_attention.py``).
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_fsdp_cases as C
from _torch_dist_cases import load_tree
from repro_torch.core.config import (ARCH_IDS, SHAPES, ParallelConfig,
                                     get_config)
from repro_torch.launch.mesh import make_meta_mesh, make_production_mesh
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import build_model
from repro_torch.parallel.sharding import (make_parallel_config,
                                           param_shapes)

LOSS_REL = 5e-3
TRAJ_TOL = 2e-3
GRAD_TOL = 5e-5
# the one process and the world round the gradient sums in other orders.
# An element whose first moment stays clear of that rounding (above
# CLEAR · its leaf's max |m| at every step; at least CLEAR_SHARE of the
# elements) lands within PARAM_CLEAR (lr / 10 at lr 1e-3) of one
# process's; elsewhere (a gradient within rounding of 0: while the moments
# are young the update is ≈ lr · sign, which may flip) within PARAM_TOL,
# 2 · lr.
CLEAR = 1e-5
CLEAR_SHARE = 0.9
PARAM_CLEAR = 1e-4
PARAM_TOL = 2e-3 + 1e-6
GNORM_REL = 1e-5
REF_TIMEOUT = 300
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")


class _Reference:
    """The reference process, started at once: :meth:`inits` waits until
    the training cases' initial weights are written (the port's world
    starts from them while the reference goes on), :meth:`spec` for its
    layouts (written before its train steps), :meth:`result` for its
    end."""

    def __init__(self, out):
        self.out = out
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=512 "
                   "--xla_backend_optimization_level=0 "
                   "--xla_llvm_disable_expensive_passes=true",
                   PYTHONPATH=SRC + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        self.log = open(os.path.join(out, "log.txt"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", C.reference_script(out)], env=env,
            stdout=self.log, stderr=subprocess.STDOUT, text=True)
        self.t0 = time.monotonic()
        self._res = None

    def _failed(self):
        self.log.seek(0)
        return f"the reference exited {self.proc.returncode}: " + \
            self.log.read()[-3000:]

    def _wait(self, name):
        while not os.path.exists(os.path.join(self.out, name)):
            assert self.proc.poll() is None, self._failed()
            assert time.monotonic() - self.t0 < REF_TIMEOUT, "timed out"
            time.sleep(0.05)

    def inits(self):
        self._wait("init.done")
        return self.out

    def spec(self):
        self._wait("spec.json")
        with open(os.path.join(self.out, "spec.json")) as f:
            return json.load(f)

    def result(self):
        if self._res is None:
            try:
                rc = self.proc.wait(max(1.0, REF_TIMEOUT - (
                    time.monotonic() - self.t0)))
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
            assert rc == 0, self._failed()
            with open(os.path.join(self.out, "runs.json")) as f:
                runs = json.load(f)
            self._res = (self.out, runs)
        return self._res

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    ref = _Reference(str(tmp_path_factory.mktemp("fsdp_ref")))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def reference(started):
    return started.result()


@pytest.fixture(scope="module")
def spec(started):
    return started.spec()


@pytest.fixture(scope="module")
def world(started, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt") / "run")
    res = spawn(C.world, 4, (started.inits(), ckpt), device="cpu",
                timeout=240)
    return res, ckpt


@pytest.fixture(scope="module")
def single(started):
    """The port on one process, on one torch thread: each training case
    from the reference's initial weights (one run for the cases whose
    weights and batch are the same), and each of the port's own families
    from its init."""
    ref_dir = started.inits()
    out, runs = {}, []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, arch, _, _, B in C.TRAIN:
            tree = load_tree(os.path.join(ref_dir, f"{name}_init.npz"))
            out[name] = next((res for (a, b, t), res in runs if (a, b) == (
                arch, B) and _same_tree(t, tree)), None)
            if out[name] is None:
                out[name] = C.single_run(arch, B, C.STEPS, tree)
                runs.append(((arch, B, tree), out[name]))
        for arch, _ in C.OTHERS:
            out[arch] = C.single_run(arch, C.OTHER_B, C.OTHER_STEPS)
    finally:
        torch.set_num_threads(n)
    return out


def _same_tree(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def _clear(one, k):
    """The elements of leaf ``k`` whose first moment in one process's run
    ``one`` is clear of rounding at every step."""
    ms = [np.abs(m[k]) for m in one["m"]]
    return np.logical_and.reduce([a > CLEAR * a.max() for a in ms])


def _check_params(got, one, *others):
    """The gathered parameters after the steps ``got`` against one
    process's (``one``: its parameters and each step's first moment) and
    ``others`` (flat trees): within :data:`PARAM_CLEAR` where one
    process's first moment is clear of rounding at every step, within
    :data:`PARAM_TOL` elsewhere; the clear elements at least
    :data:`CLEAR_SHARE` of all."""
    n = clear = 0
    assert set(got) == set(one["params"]), set(got) ^ set(one["params"])
    for k, x in got.items():
        mask = _clear(one, k)
        bar = np.where(mask, PARAM_CLEAR, PARAM_TOL)
        for want in (one["params"][k],) + tuple(o[k] for o in others):
            err = np.abs(x - want)
            assert (err <= bar).all(), (k, float(err[mask].max(initial=0)),
                                        float(err.max()))
        n += x.size
        clear += int(mask.sum())
    assert clear >= CLEAR_SHARE * n, clear / n


# ------------------------------------------------------ FSDP training
# (the tests that need only the port's world come first: it runs while
# the reference process goes on)

def test_gather_param_against_plain(world):
    """``gather_param`` gathers what its plain version concatenates, and
    its backward gives each shard the hand-summed blocks of the ranks'
    cotangents (times the scale); ``reduce_scatter`` of bfloat16 is the
    float64 sum rounded once."""
    res, _ = world
    for r in res:
        for dim in (0, 1):
            same, err = r["gather"][dim]
            assert same
            assert err <= 1e-6, err
        assert r["gather"]["bf16"] == (True, True)


def test_shards_are_the_whole_tree_sliced(world):
    """Every rank's shards — from ``init`` (drawn a subtree at a time and
    cut at once) and from the reference's weights (the importer on
    shards) — equal, bit for bit, ``shard_tree`` of one process's whole
    tree."""
    res, _ = world
    for r in res:
        for name in [t[0] for t in C.TRAIN] + [a for a, _ in C.OTHERS]:
            assert r[name]["sliced"], name


def test_owned_layers_lie_with_their_owner(world):
    """The owned-layers case (A_log (4, 6) stacked over 4 data ranks:
    the rule picks the layer axis) keeps layer i on data rank i alone."""
    res, _ = world
    for r in res:
        owned = r["owned"]["owned"]
        assert owned == [int(i == r["owned"]["fsdp_rank"]) for i in
                         range(4)], owned


@pytest.mark.parametrize("arch", [a for a, _ in C.OTHERS])
def test_other_families_follow_one_process(arch, world, single):
    """mamba2, zamba2, whisper-tiny, deepseek-v3 (MTP) and the
    owned-layers mamba2 on an FSDP world: losses, norms and the gathered
    parameters of 2 steps equal one process's."""
    res, _ = world
    one = single[arch]
    for r in res:
        got = r[arch]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], one["gnorm"],
                                   rtol=GNORM_REL)
        _check_params(got["params"], one)
        # float32 shards and moments, less than the whole model
        assert got["bytes"][1] == 2 * got["bytes"][0] < 2 * one["bytes"]


def test_data_replicas_count_each_token_once(world, started):
    """Batch 1 on (data 2, model 2): ``data`` holds replicas (not a batch
    axis) but still shards the parameters; the loss and every gradient
    equal one process's, and the same sums without the replica scale
    (each token counted twice) are rejected."""
    from repro_torch.models.transformer import (build_model,
                                                load_reference_params,
                                                trainable)
    res, _ = world
    cfg = C.config("llama-gqa")
    tree = load_tree(os.path.join(started.inits(), "gqa_2x2_init.npz"))
    one = build_model(cfg, "cpu", par=ParallelConfig())
    loss1, g1 = C.replica_grads(one, trainable(load_reference_params(
        cfg, tree, "cpu")))
    for r in res:
        rep = r["replica"]
        assert rep["batch_axes"] == () and rep["scale"] == 0.5
        loss, gs = rep["sound"]
        assert abs(loss - loss1) <= 1e-6 * max(1.0, abs(loss1))
        err = max(float(np.abs(a - b).max()) for a, b in zip(gs, g1))
        assert err <= GRAD_TOL, err
        _, gd = rep["double"]
        bad = max(float(np.abs(a - b).max()) for a, b in zip(gd, g1))
        assert bad > GRAD_TOL, bad


def test_checkpoint_from_shards_is_the_one_process_file(world, started,
                                                        tmp_path):
    """Rank 0 of a (data 2, model 2) world writes the gathered shards:
    the files equal, byte for byte, one process's checkpoint of the same
    parameters; restoring it into shards gives each rank its shards."""
    from repro_torch.io import checkpoint as ckpt_io
    from repro_torch.models.transformer import (load_reference_params,
                                                to_reference_params)
    res, path = world
    cfg = C.config("llama-gqa")
    tree = load_tree(os.path.join(started.inits(), "gqa_2x2_init.npz"))
    one = str(tmp_path / "one")
    ckpt_io.save(one, {"params": to_reference_params(load_reference_params(
        cfg, tree, "cpu"))}, step=0)
    for name in ("weights.npz", "manifest.json"):
        with open(os.path.join(one, name), "rb") as a, \
                open(os.path.join(path, name), "rb") as b:
            assert a.read() == b.read(), name
    assert all(r["restored_equal"] for r in res)


# ---------------------------------------------------------- axis roles

def test_multipod_fsdp_axes_are_pod_and_data():
    """The production multi-pod mesh shards parameters over pod × data,
    as the reference's ``make_parallel_config`` says (the port once gave
    data alone)."""
    mesh = make_production_mesh(multi_pod=True)
    for shape in SHAPES.values():
        assert make_parallel_config(mesh, shape).fsdp_axes == ("pod",
                                                               "data")


@pytest.mark.parametrize("mesh", [m[0] for m in C.SPEC_MESHES])
def test_parallel_config_matches_reference(mesh, spec):
    names, shape = next((n, s) for m, n, s in C.SPEC_MESHES if m == mesh)
    meta = make_meta_mesh(names, shape)
    for sname, sh in SHAPES.items():
        got = make_parallel_config(meta, sh)
        want = spec["par"][f"{mesh}/{sname}"]
        for k, v in want.items():
            g = getattr(got, k)
            assert (list(g) if isinstance(g, tuple) else g) == v, \
                (mesh, sname, k, g, v)


# ------------------------------------------------------------- layout

def _port_leaves(tree, prefix=""):
    """(reference path, layer index or None, port leaf) of a port tree."""
    from repro_torch.parallel.sharding import LAYER_KEYS
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in LAYER_KEYS and not prefix:
                for i, lp in enumerate(v):
                    for path, _, x in _port_leaves(lp, k):
                        yield path, i, x
            else:
                yield from _port_leaves(v, f"{prefix}/{k}" if prefix
                                        else k)
    else:
        yield prefix, None, tree


def _check_shards(shards, want, what):
    """Every port leaf's shape on one rank against the reference's shard
    shape of its leaf: a layer leaf's per-layer shape is the stacked
    shard's less its layer axis, unless the rule picked the layer axis
    (whole layers a rank: the non-empty layers number the shard's and
    each is one of them)."""
    layers = {}
    for path, i, shape in shards:
        layers.setdefault(path, []).append((i, shape))
    assert set(layers) == set(want), (what, set(layers) ^ set(want))
    owned_cases = 0
    for path, got in layers.items():
        shard, full = want[path]
        if got[0][0] is None:
            assert list(got[0][1]) == shard, (what, path, got, shard)
            continue
        if shard[0] == full[0]:                 # the layer axis is whole
            assert all(list(s) == shard[1:] for _, s in got), \
                (what, path, got, shard)
            continue
        owned = [s for _, s in got if s[0] != 0]
        assert len(owned) == shard[0], (what, path, got, shard)
        assert all(list(s) == shard[1:] for s in owned), (what, path)
        owned_cases += 1
    return owned_cases


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", [m[0] for m in C.SPEC_MESHES])
def test_shard_shapes_match_param_spec(mesh, arch, spec):
    """Each leaf's shape on a rank (its first and last; ``param_shapes``
    of the FSDP model) equals the shard shape of the reference's
    ``param_shardings`` on the reference's path and stacked shape, full
    size, on the meta device."""
    names, shape = next((n, s) for m, n, s in C.SPEC_MESHES if m == mesh)
    want = spec["shards"][f"{mesh}/{arch}"]
    owned = 0
    for rank in (0, int(np.prod(shape)) - 1):
        meta = make_meta_mesh(names, shape, rank=rank)
        par = make_parallel_config(meta, SHAPES["train_4k"])
        model = build_model(get_config(arch), "meta", par=par, mesh=meta,
                            fsdp=True)
        shards = list(_port_leaves(param_shapes(model, par, meta)))
        owned += _check_shards(shards, want, (mesh, arch, rank))
    if (mesh, arch) == ("pod2_data16_model16", "mamba2-2.7b"):
        assert owned == 2 * 3     # A_log, D, dt_bias: 2 of 64 layers a rank


def test_dryrun_parameter_bytes_are_the_reference_shards(spec):
    """The meta dry-run's llama-7b ``train_4k`` step on (16, 16) starts
    from one rank's parameters: their bytes are the reference's shard
    bytes (bfloat16), and its moments twice that in float32."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch.dryrun import build_step
    from repro_torch.core.config import get_shape
    want = spec["shards"]["data16_model16/llama-7b"]
    ref_bytes = sum(math.prod(s) * 2 for s, _ in want.values())
    _, (params, m, v, _) = build_step(get_config("llama-7b"),
                                      get_shape("train_4k"),
                                      make_production_mesh())

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in leaves(t))
    assert nbytes(params) == ref_bytes
    assert nbytes(m) == nbytes(v) == 2 * ref_bytes


def test_meta_comm_counts_reduce_scatter():
    """The dry-run's MetaComm returns the reduce-scatter's block and counts
    R·(n − 1)/n of its input."""
    mesh = make_meta_mesh(("data", "model"), (4, 2), device="cpu")
    c = mesh.comm("data")
    x = torch.empty(8, 6)
    counts = mesh.world.counts
    counts.reset()
    assert tuple(c.reduce_scatter(x, 0).shape) == (2, 6)
    assert counts.bytes["reduce_scatter"] == 8 * 6 * 4 * 3 / 4
    assert counts.ops["reduce_scatter"] == 1


# ------------------------------------ the reference's FSDP train steps
# (last: the reference process ends after writing its layouts)

@pytest.mark.parametrize("case", [t[0] for t in C.TRAIN])
def test_fsdp_steps_follow_the_reference(case, reference, world):
    """3 FSDP steps from the reference's ``init_sharded`` weights: the
    ranks agree, the first loss is the reference's within its bar and the
    trajectory within 2e-3."""
    _, runs = reference
    res, _ = world
    want = runs[case]["loss"]
    got = [r[case]["loss"] for r in res]
    assert all(g == got[0] for g in got), got
    assert abs(got[0][0] - want[0]) <= LOSS_REL * max(1.0, abs(want[0]))
    np.testing.assert_allclose(got[0], want, atol=TRAJ_TOL)


@pytest.mark.parametrize("case", [t[0] for t in C.TRAIN])
def test_fsdp_params_and_gnorm_match_one_process(case, world, single,
                                                 reference):
    """The gathered parameters after the steps and each step's gradient
    norm equal the port's one process (and the parameters the
    reference's FSDP step's, at the same bar)."""
    res, _ = world
    one = single[case]
    final = dict(np.load(os.path.join(reference[0], f"{case}_final.npz")))
    for r in res:
        got = r[case]
        np.testing.assert_allclose(got["gnorm"], one["gnorm"],
                                   rtol=GNORM_REL)
        assert set(got["params"]) == set(final)
        _check_params(got["params"], one, final)


def test_skipped_shard_update_is_rejected(world, single):
    """The planted fault: data rank 1 of (data 2, model 2) puts its shards
    back after every step, as if it skipped its update; the gathered
    parameters then miss one process's by far more than the bar on the
    elements clear of rounding, and :func:`_check_params` rejects them."""
    res, _ = world
    one = single["gqa_2x2"]
    for r in res:
        worst = 0.0
        for k, x in r["skipped"].items():
            err = np.abs(x - one["params"][k])[_clear(one, k)]
            worst = max(worst, float(err.max(initial=0)))
        assert worst > 10 * PARAM_CLEAR, worst
        with pytest.raises(AssertionError):
            _check_params(r["skipped"], one)


@pytest.mark.parametrize("case", [t[0] for t in C.TRAIN])
def test_rank_bytes_are_its_shards(case, reference, world):
    """Each rank holds its shards only: its parameter bytes are the sum
    of the reference's shard sizes (float32), its moments twice that."""
    _, runs = reference
    res, _ = world
    want = sum(math.prod(s) * 4 for s in runs[case]["shards"].values())
    for r in res:
        params, moments = r[case]["bytes"]
        assert params == want, (case, params, want)
        assert moments == 2 * want
