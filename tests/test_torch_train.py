"""Parity of the port's single-card training slice with the JAX reference,
on the CPU.

Smoke ``llama-7b`` (MHA) and ``llama-gqa`` (GQA): 2 layers, 4 heads of 32,
vocab 128, float32, seq 64.  Every reference model is built on an
Auto-axis ``(1, 1)`` mesh (the default Explicit mesh of jax 0.9 breaks the
reference's training path) with the plain ``ref`` attention; the port runs
its default ``cuda`` backend, whose wrappers run the plain versions on CPU
tensors.  The reference ``DecoderLM.init`` weights and ``AdamWState`` are
carried into the port with ``load_reference_params`` /
``load_reference_opt_state``.

Bars are the reference's own: remat policies 5e-4 atol / 1e-4 rtol
(tests/test_remat.py), 4-step losses 2e-3
(tests/test_train_integration.py); first-step loss and gradients 1e-4 (the
slack is float32 summation order, XLA's CPU dots against PyTorch's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dist_attention as rda
from repro.core import mask as rmk
from repro.core.config import ShapeSpec as RShapeSpec
from repro.core.config import TrainConfig as RTrainConfig
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.data.pipeline import SyntheticTokens as RSyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.optim import adamw as radamw
from repro.parallel.sharding import make_parallel_config
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.core import dist_attention as tda
from repro_torch.core import mask as tmk
from repro_torch.core.config import ParallelConfig, ShapeSpec, TrainConfig
from repro_torch.core.config import get_config, smoke_config
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import registry
from repro_torch.models.transformer import (DecoderLM, load_reference_opt_state,
                                            load_reference_params, trainable)
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

T, B, VOCAB = 64, 2, 128
GRAD_TOL = 1e-4
LOSS_TOL = 2e-3
TC = dict(lr=3e-3, warmup_steps=2, total_steps=4)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@dataclasses.dataclass
class Pair:
    r_model: object
    r_params: dict
    r_data: object
    t_cfg: object
    tree: dict                     # reference init, numpy


def _pair(arch, docs=1, remat="remat_aware"):
    r_cfg = r_smoke_config(r_get_config(arch)).replace(vocab=VOCAB)
    t_cfg = smoke_config(get_config(arch)).replace(vocab=VOCAB)
    mesh = _mesh()
    shape = RShapeSpec("tt", T, B, "train", docs=docs)
    par = make_parallel_config(mesh, shape, remat=remat)
    r_model = build_model(r_cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    r_params = r_model.init(jax.random.PRNGKey(0))
    return Pair(r_model, r_params, RSyntheticTokens(r_cfg, shape, par, mesh),
                t_cfg, jax.tree.map(np.asarray, r_params))


@pytest.fixture(scope="module")
def gqa():
    return _pair("llama-gqa")


def _t_params(pair):
    return trainable(load_reference_params(pair.t_cfg, pair.tree,
                                           device="cpu"))


def _t_data(pair, docs=1):
    return SyntheticTokens(pair.t_cfg, ShapeSpec("tt", T, B, "train",
                                                 docs=docs), device="cpu")


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("docs", [1, 3])
def test_synthetic_tokens_identical_to_reference(gqa, docs):
    r_shape = RShapeSpec("tt", T, B, "train", docs=docs)
    mesh = _mesh()
    r_ds = RSyntheticTokens(gqa.r_data.cfg, r_shape,
                            make_parallel_config(mesh, r_shape), mesh,
                            seed=5)
    t_ds = SyntheticTokens(gqa.t_cfg, ShapeSpec("tt", T, B, "train",
                                                docs=docs), "cpu", seed=5)
    for step in (0, 7):
        r, t = r_ds.batch(step), t_ds.batch(step)
        assert sorted(r) == sorted(t)
        for key in r:
            assert t[key].dtype == torch.int32
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(r[key]))


# ------------------------------------------------------------- the loss

def test_first_step_loss_and_grads_match_reference(gqa):
    batch_r = gqa.r_data.batch(0)
    (r_loss, _), r_grads = jax.value_and_grad(gqa.r_model.loss,
                                              has_aux=True)(gqa.r_params,
                                                            batch_r)
    model = DecoderLM(gqa.t_cfg, device="cpu")
    params = _t_params(gqa)
    loss, metrics = model.loss(params, _t_data(gqa).batch(0))
    grads = torch.autograd.grad(loss, leaves(params))
    assert float(metrics["ce"].detach()) == float(loss.detach())
    np.testing.assert_allclose(float(loss), float(r_loss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    ref = leaves(load_reference_params(
        gqa.t_cfg, jax.tree.map(np.asarray, r_grads), device="cpu"))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_packed_loss_matches_reference():
    pair = _pair("llama-gqa", docs=3)
    batch_r = pair.r_data.batch(1)
    r_loss, _ = pair.r_model.loss(pair.r_params, batch_r)
    batch_t = _t_data(pair, docs=3).batch(1)
    assert "segment_ids" in batch_t
    model = DecoderLM(pair.t_cfg, device="cpu")
    loss, _ = model.loss(_t_params(pair), batch_t)
    np.testing.assert_allclose(float(loss), float(r_loss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    unpacked = {k: v for k, v in batch_t.items() if k != "segment_ids"}
    loss_u, _ = model.loss(_t_params(pair), unpacked)
    assert abs(float(loss_u) - float(loss)) > 1e-4, "segments had no effect"


def _counting_backend(counter):
    be = registry.get("cuda")

    def fwd(*a, **kw):
        counter.append(1)
        return be.fwd(*a, **kw)
    return dataclasses.replace(be, name="counting", fwd=fwd)


def test_remat_policies_agree_and_count_attention_forwards(gqa):
    """remat_aware, hf and none give the same loss and gradients; the
    attention forward runs L times per step under remat_aware and none,
    2L under hf (the recompute §3.3 removes)."""
    batch = _t_data(gqa).batch(0)
    L = gqa.t_cfg.n_layers
    out = {}
    for pol, want in (("none", L), ("remat_aware", L), ("hf", 2 * L)):
        calls = []
        model = DecoderLM(gqa.t_cfg, device="cpu",
                          par=ParallelConfig(remat=pol),
                          impl=_counting_backend(calls))
        params = _t_params(gqa)
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves(params))
        assert len(calls) == want, (pol, len(calls))
        out[pol] = (float(loss), grads)
    base_loss, base = out["none"]
    for pol in ("remat_aware", "hf"):
        loss, grads = out[pol]
        assert loss == base_loss, pol
        for a, b in zip(grads, base):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                       rtol=1e-4)


# ------------------------------------------------------------- training

def _r_run(pair, steps, snapshot_after):
    r_step = jax.jit(r_make_train_step(pair.r_model, RTrainConfig(**TC)))
    params, opt = pair.r_params, radamw.init(pair.r_params)
    losses, snap = [], None
    for i in range(steps):
        params, opt, m = r_step(params, opt, pair.r_data.batch(i))
        losses.append(float(m["loss"]))
        if i + 1 == snapshot_after:
            snap = jax.tree.map(np.asarray, (params, opt))
    return losses, snap


@pytest.mark.parametrize("arch", ["llama-7b", "llama-gqa"])
def test_four_step_losses_match_reference_and_resume(arch, gqa):
    """Four steps of make_train_step from the same init; then the port
    resumes from the reference's params and AdamW state after step 2 and
    takes steps 3-4."""
    pair = gqa if arch == "llama-gqa" else _pair(arch)
    r_losses, (r_p2, r_o2) = _r_run(pair, 4, snapshot_after=2)
    model = DecoderLM(pair.t_cfg, device="cpu")
    step = make_train_step(model, TrainConfig(**TC))
    ds = _t_data(pair)
    params = _t_params(pair)
    opt = adamw.init(params)
    t_losses = [step(params, opt, ds.batch(i))["loss"] for i in range(4)]
    np.testing.assert_allclose(t_losses, r_losses, atol=LOSS_TOL)
    assert t_losses[-1] < t_losses[0]
    assert opt.step == 4

    params = trainable(load_reference_params(pair.t_cfg, r_p2, device="cpu"))
    opt = load_reference_opt_state(pair.t_cfg, r_o2, device="cpu")
    assert opt.step == 2 and leaves(opt.m)[0].dtype == torch.float32
    resumed = [step(params, opt, ds.batch(i))["loss"] for i in (2, 3)]
    np.testing.assert_allclose(resumed, r_losses[2:], atol=LOSS_TOL)


def test_nonfinite_step_is_skipped_params_bit_identical(gqa):
    """A poisoned step (NaN in an embedding row the batch reads: NaN loss
    and grads) skips the update — params and AdamW state bit-identical —
    and a healthy step afterwards updates."""
    model = DecoderLM(gqa.t_cfg, device="cpu")
    step = make_train_step(model, TrainConfig(**TC))
    ds = _t_data(gqa)
    params = _t_params(gqa)
    opt = adamw.init(params)
    assert step(params, opt, ds.batch(0))["skipped_nonfinite"] == 0
    batch = ds.batch(1)
    with torch.no_grad():
        params["embed"][int(batch["tokens"][0, 0])] = float("nan")
    before = [t.detach().clone() for t in leaves((params, opt.m, opt.v))]
    m = step(params, opt, batch)
    assert m["skipped_nonfinite"] == 1 and not np.isfinite(m["loss"])
    assert m["lr"] == 0.0 and m["gnorm"] == 0.0
    assert opt.step == 1
    for a, b in zip(leaves((params, opt.m, opt.v)), before):
        assert a.dtype == b.dtype
        assert torch.equal(torch.nan_to_num(a.detach(), nan=7.0),
                           torch.nan_to_num(b, nan=7.0))
        assert torch.equal(a.isnan(), b.isnan())
    with torch.no_grad():
        params["embed"].nan_to_num_(0.0)
    m = step(params, opt, ds.batch(2))
    assert m["skipped_nonfinite"] == 0 and opt.step == 2


@pytest.mark.parametrize("remat", ["remat_aware", "none"])
def test_train_step_leaves_nothing_in_reference_cycles(gqa, remat):
    """With the garbage collector off, a step frees its gradients and
    activations by reference counting alone: no tensor survives the step
    in a reference cycle (at full width one set of gradients is 3.5 GiB)."""
    import gc

    def live():
        return {o.untyped_storage().data_ptr() for o in gc.get_objects()
                if isinstance(o, torch.Tensor)}

    model = DecoderLM(gqa.t_cfg, device="cpu",
                      par=ParallelConfig(remat=remat))
    step = make_train_step(model, TrainConfig(**TC))
    ds = _t_data(gqa)
    params = _t_params(gqa)
    opt = adamw.init(params)
    step(params, opt, ds.batch(0))
    gc.collect()
    gc.disable()
    try:
        before = live()
        for i in (1, 2):
            step(params, opt, ds.batch(i))
        assert live() - before == set()
    finally:
        gc.enable()


def test_adamw_pieces_match_reference():
    """schedule, clip_by_global_norm and one update, on the same tree."""
    tc = TrainConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    rtc = RTrainConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    for s in range(12):
        np.testing.assert_allclose(adamw.schedule(s, tc),
                                   float(radamw.schedule(jnp.int32(s), rtc)),
                                   rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = {"a": 3 * rng.standard_normal((4, 3)).astype(np.float32),
             "b": [3 * rng.standard_normal(5).astype(np.float32)]}

    def tt(t):
        return {"a": torch.from_numpy(t["a"].copy()),
                "b": [torch.from_numpy(t["b"][0].copy())]}
    c_t, gn_t = adamw.clip_by_global_norm(tt(grads), 1.0)
    c_r, gn_r = radamw.clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(gn_t), float(gn_r), rtol=1e-6)
    np.testing.assert_allclose(c_t["a"].numpy(), np.asarray(c_r["a"]),
                               rtol=1e-6)
    p_t = tt(tree)
    st = adamw.init(p_t)
    adamw.update(tt(grads), st, p_t, tc)
    p_r, st_r, _ = radamw.update(grads, radamw.init(tree), tree, rtc)
    np.testing.assert_allclose(p_t["a"].numpy(), np.asarray(p_r["a"]),
                               atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(st.v["b"][0].numpy(), np.asarray(st_r.v["b"][0]),
                               rtol=1e-6)
    assert st.step == int(st_r.step) == 1


# ------------------------------------------------------ dist_attention

LEGACY = [dict(causal=True), dict(window=4)]
BAD = [
    dict(schedule="rign"),
    dict(schedule="balanced", axis_size=4, mask="sliding_window_nc"),
    dict(schedule="ring", axis_size=4, mask="prefix"),
    dict(schedule="rsa", axis_size=4, mask="window"),
    dict(schedule="ring", axis_size=4, mask="sliding_window_nc"),
    dict(schedule="zigzag", axis_size=2, mask="full"),
    dict(mask="offset"),
]


def _masks(pkg):
    return {"sliding_window_nc": pkg.sliding_window(8, causal=False),
            "prefix": pkg.prefix_lm(4), "window": pkg.sliding_window(8),
            "full": pkg.full(), "offset": pkg.causal(rel_offset=3)}


@pytest.mark.parametrize("kw", LEGACY + BAD)
def test_dist_attn_spec_raises_where_reference_raises(kw):
    kw = dict(kw)
    m = kw.pop("mask", None)
    with pytest.raises((TypeError, ValueError)) as r_err:
        rda.DistAttnSpec(**kw, **({} if m is None else
                                  {"mask": _masks(rmk)[m]}))
    with pytest.raises(r_err.type):
        tda.DistAttnSpec(**kw, **({} if m is None else
                                  {"mask": _masks(tmk)[m]}))


def test_dist_attn_single_card_only_and_local_kernels():
    """At ``axis_size > 1`` a call needs its axis's group of that many
    ranks (the schedules themselves run in ``tests/test_torch_dist.py``'s
    worlds), ``auto`` waits for the H100 cost model, and at
    ``axis_size == 1`` every schedule is the local kernels."""
    from repro_torch.parallel.comm import Comm
    spec = tda.DistAttnSpec(axis_size=2, schedule="ring")
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="group of mesh axis 'model'"):
        tda.dist_attn_fwd(q, q, q, spec=spec)
    with pytest.raises(ValueError, match="with that many ranks"):
        tda.dist_attn_bwd(q, q, q, q, q[..., 0], q, spec=spec,
                          group=Comm([0], "local", "cpu"))
    with pytest.raises(NotImplementedError, match="tune/"):
        tda.resolve_schedule(tda.DistAttnSpec(axis_size=2,
                                              schedule="auto"))
    assert tda.resolve_schedule(spec) == "ring"
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 64, 4, 32)).astype(np.float32)).requires_grad_()
        for _ in range(4))
    spec = tda.DistAttnSpec(mask=tmk.sliding_window(20))
    o, lse = tda.dist_flash_attn(q, k, v, spec)
    assert not lse.requires_grad
    got = torch.autograd.grad(o, (q, k, v), do.detach())
    from repro_torch.kernels.ref import chunk_attn_ref
    o_r, _ = chunk_attn_ref(q, k, v, mask=tmk.sliding_window(20))
    want = torch.autograd.grad(o_r, (q, k, v), do.detach())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_train_cli_runs_on_cpu_and_has_no_schedule_flag(capfd,
                                                        monkeypatch):
    """The training CLI trains the smoke config on the CPU, on one process
    and on a world it spawns itself: ``--nproc 2 --seq-shards 2
    --schedule ring`` prints the single process's losses; an unknown
    schedule is refused rather than ignored.  The CLI's world runs without
    a time limit, so here its spawn gets one of 120 s."""
    from repro_torch.launch import train as cli
    from repro_torch.launch.world import spawn

    def limited(fn, nprocs, args, *, device, timeout):
        assert timeout is None
        return spawn(fn, nprocs, args, device=device, timeout=120)

    monkeypatch.setattr(cli, "spawn", limited)
    base = ["--arch", "llama-gqa", "--smoke", "--device", "cpu", "--steps",
            "2", "--seq", "32", "--batch", "1", "--log-every", "1"]
    assert cli.main(base) == 0
    one = capfd.readouterr().out
    assert "step     1 loss" in one and "skipped" not in one
    assert cli.main(base + ["--nproc", "2", "--seq-shards", "2",
                            "--schedule", "ring"]) == 0
    two = capfd.readouterr().out
    assert "transport gloo: 2 ranks on the CPU" in two
    assert "'model': 2" in two and "schedule=ring" in two

    def losses(out):
        return [ln.split(" loss ")[1].split()[0] for ln in out.splitlines()
                if ln.startswith("step ")]

    assert losses(two) == losses(one) and len(losses(one)) == 2
    with pytest.raises(SystemExit):
        cli.main(["--smoke", "--device", "cpu", "--schedule", "rign"])
