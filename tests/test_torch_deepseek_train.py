"""DeepSeek-V2-Lite (MLA + MoE) training in the port against the JAX
reference, on the CPU.

The smoke config of ``deepseek-v2-lite-16b`` (2 layers — the dense layer 0
and one MoE layer of 4 routed + 1 shared experts, top 2 — 4 heads, MLA
q/k 32 + 16, v 32, latent 32, float32), seq 32, batch 2.  The reference
runs on an Auto-axis (1, 1) mesh with ``impl="ref"``; its ``DecoderLM.init``
weights and ``AdamWState`` are carried into the port.  The port's loss is
the reference's ``ce + aux`` (``aux`` the MoE layers' load-balance loss),
under each checkpoint policy, unpacked and packed, at the smoke config's
capacity factor 4.0 (nothing dropped) and at 0.5, where the capacity order
decides which (token, choice) pairs drop.

Bars are ``tests/test_torch_train.py``'s: loss, ``ce``, ``aux`` and every
gradient leaf 1e-4 (float32 summation order, XLA's CPU dots against
PyTorch's), 4-step losses 2e-3.  One reference value-and-grad is taken per
case, and all three policies are held to it (they compute the same
function).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.config import ShapeSpec as RShapeSpec
from repro.core.config import TrainConfig as RTrainConfig
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.data.pipeline import SyntheticTokens as RSyntheticTokens
from repro.io import checkpoint as rck
from repro.models.transformer import Runtime, build_model
from repro.optim import adamw as radamw
from repro.parallel.sharding import make_parallel_config
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.core.config import ParallelConfig, ShapeSpec, TrainConfig
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.io import checkpoint as ckpt
from repro_torch.kernels import registry
from repro_torch.models import moe as M
from repro_torch.models.transformer import (DecoderLM,
                                            load_reference_opt_state,
                                            load_reference_params,
                                            to_reference_params, trainable)
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

ARCH = "deepseek-v2-lite-16b"
T, B = 32, 2
GRAD_TOL = 1e-4
LOSS_TOL = 2e-3
TC = dict(lr=3e-3, warmup_steps=2, total_steps=4)
POLICIES = ("remat_aware", "hf", "none")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _with_capacity(cfg, cf):
    return cfg if cf is None else cfg.replace(
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@dataclasses.dataclass
class Case:
    """One reference model and batch, and its step-1 loss and gradients
    (``jax.value_and_grad`` of the reference's ``DecoderLM.loss``)."""
    r_model: object
    r_params: dict
    r_data: object
    t_cfg: object
    docs: int
    loss: float
    metrics: dict
    grads: list


def _case(docs=1, cf=None) -> Case:
    r_cfg = _with_capacity(r_smoke_config(r_get_config(ARCH)), cf)
    t_cfg = _with_capacity(smoke_config(get_config(ARCH)), cf)
    mesh = _mesh()
    shape = RShapeSpec("tt", T, B, "train", docs=docs)
    par = make_parallel_config(mesh, shape, remat="none")
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    r_params = r_model.init(jax.random.PRNGKey(0))
    r_data = RSyntheticTokens(r_cfg, shape, par, mesh)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        r_model.loss, has_aux=True))(r_params, r_data.batch(0))
    g = leaves(load_reference_params(t_cfg, jax.tree.map(np.asarray, grads),
                                     device="cpu"))
    return Case(r_model, r_params, r_data, t_cfg, docs, float(loss),
                {k: float(v) for k, v in metrics.items()}, g)


CASES = {"unpacked": dict(), "packed": dict(docs=3),
         "capacity0.5": dict(cf=0.5)}


@pytest.fixture(scope="module")
def cases():
    return {}


def _get(cases, name) -> Case:
    if name not in cases:
        cases[name] = _case(**CASES[name])
    return cases[name]


def _t_params(case):
    return trainable(load_reference_params(
        case.t_cfg, jax.tree.map(np.asarray, case.r_params), device="cpu"))


def _t_batch(case, step=0):
    return SyntheticTokens(case.t_cfg, ShapeSpec("tt", T, B, "train",
                                                 docs=case.docs),
                           device="cpu").batch(step)


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_reference(cases, name, policy):
    """``loss = ce + aux``, ``ce``, ``aux`` and every gradient leaf (the
    router's through ``top_p`` and the aux loss's ``probs.mean``) equal the
    reference's, under each checkpoint policy: unpacked, packed
    (``segment_ids``), and at capacity factor 0.5, where pairs drop."""
    case = _get(cases, name)
    model = DecoderLM(case.t_cfg, device="cpu",
                      par=ParallelConfig(remat=policy))
    params = _t_params(case)
    batch = _t_batch(case)
    assert ("segment_ids" in batch) == (case.docs > 1)
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params))
    assert sorted(metrics) == sorted(case.metrics) == ["aux", "ce"]
    np.testing.assert_allclose(float(loss.detach()), case.loss,
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), case.metrics[k],
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)
    assert float(metrics["aux"].detach()) > 0
    assert float((metrics["ce"] + metrics["aux"] - loss).detach().abs()) == 0
    for g, r in zip(grads, case.grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_capacity_half_drops_pairs_and_aux_reaches_the_router(cases):
    """At capacity factor 0.5 some (token, choice) pairs drop (so the held
    gradients cover the drop path), and the aux loss's gradient reaches the
    router: leaving it out of the gradient moves the router's leaf past
    the bar."""
    case = _get(cases, "capacity0.5")
    cfg = case.t_cfg
    n = B * T
    assert M.capacity(cfg, n) * cfg.moe.n_routed < n * cfg.moe.top_k
    model = DecoderLM(cfg, device="cpu")
    params = _t_params(case)
    loss, metrics = model.loss(params, _t_batch(case))
    router = params["moe_layers"][0]["moe"]["router"]
    g_all, = torch.autograd.grad(loss, [router], retain_graph=True)
    g_ce, = torch.autograd.grad(metrics["ce"], [router])
    assert not np.allclose(g_ce.numpy(), g_all.numpy(), atol=GRAD_TOL,
                           rtol=GRAD_TOL)


def _counting(calls):
    be = registry.get("cuda")

    def fwd(*a, **kw):
        calls.append(1)
        return be.fwd(*a, **kw)
    return dataclasses.replace(be, name="counting", fwd=fwd)


@pytest.mark.parametrize("policy,fwd_per_layer,routings",
                         [("none", 1, 1), ("remat_aware", 1, 2),
                          ("hf", 2, 2)])
def test_attention_forwards_and_routing_recompute(cases, policy,
                                                  fwd_per_layer, routings,
                                                  monkeypatch):
    """The attention forward runs once a layer a step under remat_aware
    and none, twice under hf (§3.3); the MoE layer routes once, or twice
    when its post-attention stage is recomputed in the backward — and the
    recomputed top-k sets equal the forward's."""
    case = _get(cases, "unpacked")
    seen = []

    def top_k(probs, k):
        vals, idx = base(probs, k)
        seen.append(idx.clone())
        return vals, idx
    base = M.top_k
    monkeypatch.setattr(M, "top_k", top_k)
    calls = []
    model = DecoderLM(case.t_cfg, device="cpu",
                      par=ParallelConfig(remat=policy),
                      impl=_counting(calls))
    params = _t_params(case)
    loss, _ = model.loss(params, _t_batch(case))
    torch.autograd.grad(loss, leaves(params))
    assert len(calls) == fwd_per_layer * case.t_cfg.n_layers
    assert len(seen) == routings
    assert all(torch.equal(x, seen[0]) for x in seen)


# ------------------------------------------------------------- training

def test_four_steps_and_resume_from_a_reference_checkpoint(cases,
                                                           tmp_path):
    """Four AdamW steps of ``make_train_step`` from the same init give the
    reference's losses (``ce`` and ``aux`` among the metrics); the port
    then restores the reference's checkpoint of params and AdamW state
    after step 2 and takes steps 3-4 to the reference's losses, and its
    carried AdamW state writes the reference's checkpoint to the byte."""
    case = _get(cases, "unpacked")
    r_step = jax.jit(r_make_train_step(case.r_model, RTrainConfig(**TC)))
    params, opt = case.r_params, radamw.init(case.r_params)
    r_losses = []
    for i in range(4):
        params, opt, m = r_step(params, opt, case.r_data.batch(i))
        r_losses.append(float(m["loss"]))
        if i == 1:
            r_dir = str(tmp_path / "ref")
            rck.save(r_dir, {"params": params, "m": opt.m, "v": opt.v},
                     step=int(opt.step))

    model = DecoderLM(case.t_cfg, device="cpu")
    step = make_train_step(model, TrainConfig(**TC))
    p = _t_params(case)
    o = adamw.init(p)
    out = [step(p, o, _t_batch(case, i)) for i in range(4)]
    np.testing.assert_allclose([x["loss"] for x in out], r_losses,
                               atol=LOSS_TOL)
    for x in out:
        assert x["skipped_nonfinite"] == 0
        assert x["loss"] == pytest.approx(x["ce"] + x["aux"], abs=1e-6)
        assert x["aux"] > 0

    like = {"params": to_reference_params(p), "m": to_reference_params(o.m),
            "v": to_reference_params(o.v)}
    got = ckpt.restore(r_dir, like)
    assert ckpt.latest_step(r_dir) == 2
    tree = {k: jax.tree.map(lambda t: t.numpy(), got[k])
            for k in ("params", "m", "v")}
    p2 = trainable(load_reference_params(case.t_cfg, tree["params"],
                                         device="cpu"))
    o2 = load_reference_opt_state(case.t_cfg, (2, tree["m"], tree["v"]),
                                  device="cpu")
    assert o2.step == 2 and leaves(o2.m)[0].dtype == torch.float32
    t_dir = str(tmp_path / "port")
    ckpt.save(t_dir, {"params": to_reference_params(p2),
                      "m": to_reference_params(o2.m),
                      "v": to_reference_params(o2.v)}, step=2)
    for f in ("weights.npz", "manifest.json"):
        assert open(f"{t_dir}/{f}", "rb").read() == \
            open(f"{r_dir}/{f}", "rb").read(), f
    resumed = [step(p2, o2, _t_batch(case, i))["loss"] for i in (2, 3)]
    np.testing.assert_allclose(resumed, r_losses[2:], atol=LOSS_TOL)


def test_train_cli_trains_deepseek_and_refuses_ranks(capfd):
    """``python -m repro_torch.launch.train --arch deepseek-v2-lite-16b
    --smoke --device cpu`` prints ``ce`` and ``aux`` each step, on one rank
    and on a self-spawned 4-rank world (``--nproc 4 --seq-shards 4``, the
    routed experts one a rank; the name predates that world, when ranks
    were refused): both print the reference's losses — its train step from
    the CLI's seed-0 weights on the same batches — to the printed digits.
    """
    from repro_torch.launch import train as cli
    steps = 2
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
            str(steps), "--seq", str(T), "--batch", str(B), "--log-every",
            "1"]
    r_cfg = r_smoke_config(r_get_config(ARCH))
    mesh = _mesh()
    shape = RShapeSpec("cli", T, B, "train")
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=make_parallel_config(
        mesh, shape), impl="ref"))
    t_cfg = smoke_config(get_config(ARCH))
    params = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                          to_reference_params(DecoderLM(t_cfg, "cpu").init(
                              cli.SEED)))
    r_step = jax.jit(r_make_train_step(r_model, RTrainConfig(
        lr=1e-3, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)))
    opt = radamw.init(params)
    data = RSyntheticTokens(r_cfg, shape, make_parallel_config(mesh, shape),
                            mesh)
    want = []
    for i in range(steps):
        params, opt, m = r_step(params, opt, data.batch(i))
        want.append([float(m[k]) for k in ("loss", "ce", "aux")])
    for extra in ([], ["--nproc", "4", "--seq-shards", "4"]):
        assert cli.main(base + extra) == 0
        out = capfd.readouterr().out
        got = [[float(x.split()[i]) for i in (3, 5, 7)]
               for x in out.splitlines() if x.startswith("step ")]
        assert len(got) == steps, out
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                   err_msg=str(extra))
        if extra:
            assert "mesh={'data': 1, 'model': 4}" in out
