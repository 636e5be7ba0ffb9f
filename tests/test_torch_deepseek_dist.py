"""DeepSeek-V2-Lite (MLA + MoE) across ranks: training on a (2, 4) mesh and
the fixed-slot engine on (1, 4), in the port against the reference, on the
CPU.

The smoke config of ``deepseek-v2-lite-16b`` (the dense layer 0 and one MoE
layer of 4 routed + 1 shared experts, top 2; MLA q/k 48, v 32, latent 32 +
rope 16; float32).  The reference side is one JAX process on 8 forced host
devices with Auto-axis meshes: ``model.loss``'s value and gradients (T 32,
B 2: each of the (2, 4) mesh's ranks holds 8 tokens of one row) under the
balanced and the zigzag schedule, a 3-step AdamW trajectory, and on
(1, 4) the whole-prompt ``prefill``, three dense ``decode`` steps and
``FixedSlotEngine``'s greedy streams at capacity factors 4.0 and 0.5; it
saves its ``DecoderLM.init`` weights for the port.  The port side is an
8-rank and a 4-rank ``gloo`` world (``tests/_torch_moe_cases.py``), each
rank holding its rows of the routed experts (1 of 4 a rank).

Bars: loss, ce, aux and every gradient leaf 1e-4 under every checkpoint
policy (``tests/test_torch_deepseek_train.py``); 3-step losses 2e-3
(``tests/test_train_integration.py``); logits and the ``{"ckv"}`` cache
1e-4 (``tests/test_torch_deepseek_fixed.py``); streams equal; init and
checkpoints bit for bit.  The worlds and the reference process each run
under a time limit of their own.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_moe_cases as C
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.io import checkpoint as ckpt
from repro_torch.kernels.ref import chunk_attn_ref
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import (load_reference_params,
                                            to_reference_params)

GRAD_TOL = 1e-4
LOSS_TOL = 2e-3
LOGIT_TOL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_moe_cases as C
from repro.core.config import (ShapeSpec, TrainConfig, get_config,
                               smoke_config)
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.optim import adamw
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import FixedSlotEngine
from repro.train.step import make_train_step
devs = np.array(jax.devices())
def mesh_of(d, s):
    return Mesh(devs[:d * s].reshape(d, s), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
def flat(tree):
    return {{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
base = smoke_config(get_config(C.ARCH))
mesh = mesh_of(2, 4)
shape = ShapeSpec("tt", C.T, C.B, "train")
out = {{}}
params = None
for sched in C.SCHEDULES:
    par = make_parallel_config(mesh, shape, schedule=sched, remat="none")
    model = build_model(base, Runtime(mesh=mesh, par=par, impl="ref"))
    if params is None:
        params = model.init(jax.random.PRNGKey(0))
        np.savez({params_path!r}, **flat(params))
    batch = SyntheticTokens(base, shape, par, mesh).batch(0)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    out[sched + "/loss"] = np.asarray(loss)
    for k in ("ce", "aux"):
        out[sched + "/" + k] = np.asarray(met[k])
    for k, v in flat(grads).items():
        out[sched + "/g/" + k] = v
par = make_parallel_config(mesh, shape, schedule="balanced")
model = build_model(base, Runtime(mesh=mesh, par=par, impl="ref"))
step = jax.jit(make_train_step(model, TrainConfig(**C.TC)))
p, opt = params, adamw.init(params)
data = SyntheticTokens(base, shape, par, mesh)
traj = []
for i in range(C.TRAIN_STEPS):
    p, opt, m = step(p, opt, data.batch(i))
    traj.append([float(m[k]) for k in ("loss", "ce", "aux", "gnorm")])
out["traj"] = np.asarray(traj)
smesh = mesh_of(*C.SERVE_MESH)
toks = jnp.asarray(C.prompts())
for cf in C.CAPS:
    cfg = C.with_capacity(base, cf)
    par = make_parallel_config(smesh, ShapeSpec("srv", C.T_PROMPT, C.B,
                                                "decode"))
    model = build_model(cfg, Runtime(mesh=smesh, par=par, impl="ref"))
    key = "serve/%s/" % cf
    logits, cache = model.prefill(params, {{"tokens": toks}})
    out[key + "prefill"], out[key + "ckv"] = (np.asarray(logits),
                                             np.asarray(cache["ckv"]))
    rc = {{"ckv": jnp.pad(cache["ckv"],
                         [(0, 0), (0, 0), (0, C.SERVE_PAD), (0, 0)])}}
    for i, (tok, pos) in enumerate(C.decode_inputs()):
        logits, rc = model.decode(params, rc, {{"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos)}})
        out[key + "dec%d" % i] = np.asarray(logits)
        out[key + "ckv%d" % i] = np.asarray(rc["ckv"])
    t, lg = FixedSlotEngine(model, params).generate({{"tokens": toks}},
                                                    C.N_GEN)
    out[key + "tokens"] = np.asarray(t)
    out[key + "logits"] = np.asarray(lg[:, -1], np.float32)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    path, params_path = str(d / "ref.npz"), str(d / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            tests=TESTS, path=path, params_path=params_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), params_path


@pytest.fixture(scope="module")
def train(reference, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt") / "p4")
    return spawn(C.deepseek_train_world, 8, (reference[1], d),
                 device="cpu", timeout=240), d


@pytest.fixture(scope="module")
def serve(reference):
    return spawn(C.deepseek_serve_world, 4, (reference[1],), device="cpu",
                 timeout=180)


def _cfg():
    return smoke_config(get_config(C.ARCH))


def _ref_grads(ref, sched):
    """The reference's gradients in the port's leaf order."""
    tree = {}
    for k, v in ref.items():
        if k.startswith(sched + "/g/"):
            node = tree
            *head, last = k[len(sched) + 3:].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return [t.numpy() for t in leaves(load_reference_params(_cfg(), tree,
                                                            "cpu"))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("policy", C.POLICIES)
@pytest.mark.parametrize("sched", C.SCHEDULES)
def test_loss_and_grads_match_reference(sched, policy, reference, train):
    """On (2, 4), every rank's ``loss = ce + aux``, ``ce`` and ``aux`` and
    every gradient leaf (replicated leaves summed over the world, expert
    shards summed over data and gathered over the sequence axis) within
    1e-4 of the reference's ``model.loss`` on the same mesh, under each
    checkpoint policy and schedule (zigzag: the ranks hold the mirror
    chunks and the MoE dispatches their rows in that order)."""
    ref = reference[0]
    want = _ref_grads(ref, sched)
    for r in train[0]:
        got = r[f"{sched}/{policy}"]
        _close(got["loss"], ref[sched + "/loss"], GRAD_TOL)
        _close(got["ce"], ref[sched + "/ce"], GRAD_TOL)
        _close(got["aux"], ref[sched + "/aux"], GRAD_TOL)
        assert got["aux"] > 0
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            assert g.shape == w.shape
            _close(g, w, GRAD_TOL)


def test_three_steps_follow_the_reference(reference, train):
    """A 3-step AdamW trajectory on (2, 4) (balanced, remat_aware): every
    rank's losses within 2e-3 of the reference's; loss, ce, aux and the
    gradient norm (each expert counted once) equal on every rank, no step
    skipped, and the replicated leaves equal on every rank afterwards;
    each rank's expert leaves hold 1 of the 4 experts."""
    ref = reference[0]["traj"]
    ranks = train[0]
    for r in ranks:
        got = np.array([t[:4] for t in r["traj"]])
        assert [t[4] for t in r["traj"]] == [0] * C.TRAIN_STEPS
        np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=LOSS_TOL)
        _close(got[:, 3], ref[:, 3], 1e-3)
        assert r["traj"] == ranks[0]["traj"]
        assert r["replicated_sum"] == ranks[0]["replicated_sum"]
        d, de = _cfg().d_model, _cfg().moe.d_expert
        assert r["expert_shapes"] == sorted([(1, d, de), (1, de, d)])


def test_expert_init_is_the_slice_of_one_rank(train):
    """``init(seed)`` on a rank of 4 expert shards gives every leaf of the
    one-rank init with the same seed bit for bit, and its rows of the
    routed experts."""
    assert all(r["init_slice"] for r in train[0])


def test_reference_params_round_trip_and_checkpoint_bytes(reference,
                                                          train, tmp_path):
    """``load_reference_params`` slices the reference's tree on each rank
    and ``to_reference_params`` gathers it back to the same arrays; the
    checkpoint rank 0 writes of the gathered tree equals, byte for byte,
    one written on one process of the same global parameters."""
    assert all(r["round_trip"] for r in train[0])
    tree = C.load_tree(reference[1])
    one = str(tmp_path / "p1")
    ckpt.save(one, {"params": to_reference_params(load_reference_params(
        _cfg(), tree, "cpu"))}, step=3)
    for f in ("weights.npz", "manifest.json"):
        assert open(os.path.join(one, f), "rb").read() == \
            open(os.path.join(train[1], f), "rb").read(), f


@pytest.mark.parametrize("cf", C.CAPS)
def test_fixed_slot_prefill_and_decode_match_reference(cf, reference,
                                                       serve):
    """On (1, 4): the whole-prompt prefill's last logits on every rank and
    each rank's ``{"ckv"}`` shard, then three dense decode steps over the
    cache padded to 36 slots (logits and each rank's 9 slots after every
    step) within 1e-4 of the reference's; ``FixedSlotEngine``'s greedy
    streams equal the reference's and its last logits within 1e-4.  At
    capacity 0.5 each rank's 16 rows overflow its experts."""
    ref = reference[0]
    key = f"serve/{cf}/"
    Tl = C.T_PROMPT // 4
    S_loc = (C.T_PROMPT + C.SERVE_PAD) // 4
    for r in serve:
        got = r[cf]
        rank = r["rank"]
        _close(got["prefill"][0], ref[key + "prefill"], LOGIT_TOL)
        _close(got["prefill"][1],
               ref[key + "ckv"][:, :, rank * Tl:(rank + 1) * Tl], LOGIT_TOL)
        for i, (lg, ck) in enumerate(got["decode"]):
            _close(lg, ref[key + f"dec{i}"], LOGIT_TOL)
            _close(ck, ref[key + f"ckv{i}"][:, :, rank * S_loc:
                                            (rank + 1) * S_loc], LOGIT_TOL)
        np.testing.assert_array_equal(got["tokens"], ref[key + "tokens"])
        _close(got["logits"], ref[key + "logits"], LOGIT_TOL)


def test_executors_take_v_width_at_dk_ne_dv(serve):
    """``dist_flash_attn`` at q/k 48, v 32 on 4 ranks (balanced): every
    ``o`` the backward executor hands the chunk kernel and every empty
    partial the forward builds is v's width (the CUDA wrapper checks ``o``
    against ``(B, Tq, Hq, Dv)``), and o and the gradients equal one causal
    attention over the whole sequence within 1e-5 / 1e-4."""
    q, k, v, do = (torch.from_numpy(a) for a in C.pair_inputs())
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    from repro_torch.core import mask as mk
    o, _ = chunk_attn_ref(q, k, v, mask=mk.causal(), scale=48 ** -0.5)
    want = torch.autograd.grad((o * do).sum(), (q, k, v))
    n = 64 // 4
    bwd_calls = 0
    for r in serve:
        got = r["pair"]
        sl = slice(r["rank"] * n, (r["rank"] + 1) * n)
        _close(got["o"], o.detach()[:, sl], 1e-5)
        for g, w in zip(got["grads"], want):
            _close(g, w[:, sl], GRAD_TOL)
        assert all(s[-1] == 32 for s in got["empty"]), got["empty"]
        assert all(s[-1] == 32 for s in got["bwd_o"]), got["bwd_o"]
        bwd_calls += len(got["bwd_o"])
    assert bwd_calls > 0
