"""The port's dry-run (``launch/dryrun.py``) and what it stands on, on the
CPU, against the reference: the registry's ``null`` backend, the matmul
FLOPs of a step counted on the ``meta`` device (``analysis/meta_count``)
against the reference's jaxpr, the remat policies' order, the meta mesh's
collective bytes (``parallel/comm.MetaComm``) against the static cost
model, the counters on ``meta`` against the same step on real CPU tensors,
and the CLI.

The reference's FLOPs are ``dot_general`` and ``conv_general_dilated``
FLOPs walked through ``jax.make_jaxpr`` of the same function at the same
smoke shapes, after dead-code elimination (XLA compiles only what the
outputs need), every sub-jaxpr included and a scan body counted times its
length.  The two counts are equal to 1e-9 relative, except for the ops
that one package alone runs, each named below and its FLOPs asserted:

* the SSM families' chunked SSD (``models/ssm._ssd_chunked``): the two
  packages contract the intra-chunk and chunk-prefix products in
  different orders (the port's chunk prefix is one product, the
  reference's an associative scan); the difference is each package's own
  count of ``_ssd_chunked`` at the layer's shapes, once an SSM layer;
* whisper-tiny's encoder backward: each encoder layer is checkpointed in
  both, but the port's recompute runs the whole layer (``p · v`` too)
  and its plain attention backward recomputes ``q · kᵀ``, where the
  reference's remat keeps only what its autodiff needs: two (B·H, F, F)
  products of 2·B·H·F²·head_dim FLOPs more an encoder layer.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend import core as jcore
from jax.sharding import AxisType

from repro.core.config import ShapeSpec as RShape
from repro.core.config import TrainConfig as RTrainConfig
from repro.core.config import get_config as r_get_config
from repro.core.config import smoke_config as r_smoke_config
from repro.data.pipeline import input_specs as r_input_specs
from repro.kernels import registry as rreg
from repro.models import ssm as rssm
from repro.models.transformer import Runtime
from repro.models.transformer import build_model as r_build_model
from repro.optim import adamw as radamw
from repro.parallel.sharding import make_parallel_config as r_par
from repro.train.step import make_train_step as r_train_step
from repro_torch.analysis.meta_count import as_dict, counting
from repro_torch.core import mask as tmk
from repro_torch.core import schedule as tsp
from repro_torch.core.config import (ShapeSpec, get_config, smoke_config)
from repro_torch.core.dist_attention import DistAttnSpec, dist_flash_attn
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import registry as treg
from repro_torch.launch.dryrun import build_step
from repro_torch.launch.mesh import make_meta_mesh
from repro_torch.models import ssm as tssm
from repro_torch.parallel.sharding import make_parallel_config, param_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("smollm-360m", "qwen3-8b", "deepseek-v2-lite-16b",
            "deepseek-v3-671b", "mamba2-2.7b", "zamba2-2.7b",
            "internvl2-2b", "whisper-tiny")
T, B = 64, 2


# ----------------------------------------------------------- null backend

def test_null_backend_matches_the_reference():
    """``null`` at (2, 64, 4, 32), GQA 2, float32: o, lse and the
    gradients equal the reference's ``_null_fwd`` / ``_null_bwd`` within
    1e-6; it is registered as not exact and only by name."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    be = treg.get("null")
    assert not be.exact and treg.resolve(None).name == "cuda"
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = be.fwd(*t[:3], mask=tmk.causal())
    ro, rlse = rreg._null_fwd(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), atol=1e-6)
    got = be.bwd(*t[:3], o, lse, t[3], mask=tmk.causal())
    ref = rreg._null_bwd(*map(jnp.asarray, (q, k, v)), ro, rlse,
                         jnp.asarray(do))
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)


# ------------------------------------------------- FLOPs vs the reference

def _sub(v):
    if isinstance(v, jcore.ClosedJaxpr):
        return [v.jaxpr]
    if isinstance(v, jcore.Jaxpr):
        return [v]
    if isinstance(v, (list, tuple)):
        return [j for x in v for j in _sub(x)]
    return []


def _jaxpr_flops(jaxpr) -> float:
    """dot_general / conv_general_dilated FLOPs of ``jaxpr``: every
    sub-jaxpr counted, a scan's times its length, a cond's largest
    branch."""
    tot = 0.0
    for e in jaxpr.eqns:
        p = e.primitive.name
        out = math.prod(e.outvars[0].aval.shape) if e.outvars else 0
        if p == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            tot += 2.0 * out * math.prod(lhs[i] for i in lc)
        elif p == "conv_general_dilated":
            rs = e.params["dimension_numbers"].rhs_spec
            rhs = e.invars[1].aval.shape
            tot += 2.0 * out * rhs[rs[1]] * math.prod(rhs[d]
                                                      for d in rs[2:])
        subs = [j for v in e.params.values() for j in _sub(v)]
        if not subs:
            continue
        if p == "cond":
            tot += max(_jaxpr_flops(j) for j in subs)
            continue
        n = e.params.get("length", 1) if p == "scan" else 1
        tot += n * sum(_jaxpr_flops(j) for j in subs)
    return tot


def _traced_flops(fn, *args, dce=True) -> float:
    from jax._src.interpreters import partial_eval as pe
    closed = jax.make_jaxpr(fn)(*args)
    if not dce:
        return _jaxpr_flops(closed.jaxpr)
    live, _ = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return _jaxpr_flops(live)


def _ref_flops(arch: str, kind: str) -> float:
    cfg = r_smoke_config(r_get_config(arch))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    shape = RShape("t", T, B, kind)
    par = r_par(mesh, shape, remat="none")
    model = r_build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    p = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch, _ = r_input_specs(cfg, shape, par, mesh)
    if kind == "train":
        opt = jax.eval_shape(radamw.init, p)
        return _traced_flops(r_train_step(model, RTrainConfig()), p, opt,
                             batch)
    return _traced_flops(lambda p, b: model.prefill(p, b)[0], p, batch)


def _port_counts(arch: str, kind: str, remat="none", mesh_shape=(1, 1),
                 device="meta"):
    cfg = smoke_config(get_config(arch))
    mesh = make_meta_mesh(("data", "model"), mesh_shape, device=device)
    step, live = build_step(cfg, ShapeSpec("t", T, B, kind), mesh,
                            remat=remat, device=device)
    with counting(*live) as c:
        step()
    return c


def _ssd_flops(arch: str, train: bool):
    """(port, reference) FLOPs of one ``_ssd_chunked`` call at ``arch``'s
    smoke SSM layer's shapes (its forward, and with ``train`` the backward
    to x, B, C, dt and adt)."""
    s = smoke_config(get_config(arch)).ssm
    d = smoke_config(get_config(arch)).d_model
    nh, hd, N = s.n_heads(d), s.head_dim, s.d_state
    shapes = ((B, T, nh, hd), (B, T, N), (B, T, N), (B, T, nh), (B, T, nh))
    xs = [torch.empty(sh, device="meta", requires_grad=train)
          for sh in shapes]
    s0 = torch.zeros((B, nh, N, hd), device="meta")
    with counting(*xs) as c:
        y, _ = tssm._ssd_chunked(*xs, s0, s.chunk)
        if train:
            torch.autograd.grad((y * torch.empty_like(y)).sum(), xs)
    args = [jax.ShapeDtypeStruct(sh, jnp.float32) for sh in shapes]
    z = jnp.zeros((B, nh, N, hd))

    def fwd(*a):
        return rssm._ssd_chunked(*a, z, s.chunk)

    def grads(*a):
        return jax.grad(lambda *a: (fwd(*a)[0] * 1.5).sum(),
                        argnums=tuple(range(5)))(*a)
    # the whole call, its final state included (the model's relay keeps
    # it live at any rank count)
    return c.flops, _traced_flops(grads if train else fwd, *args, dce=False)


def _port_only(arch: str, kind: str) -> float:
    """The FLOPs of the ops one package alone runs (module docstring):
    port minus reference."""
    cfg = smoke_config(get_config(arch))
    if cfg.ssm is not None:
        port, ref = _ssd_flops(arch, kind == "train")
        return cfg.n_layers * (port - ref)
    if arch == "whisper-tiny" and kind == "train":
        a = cfg.attn
        F = cfg.n_audio_frames
        return cfg.n_enc_layers * 2 * (2.0 * B * a.n_heads * F * F
                                       * a.head_dim)
    return 0.0


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_matmul_flops_equal_the_references_jaxpr(arch, kind):
    """The port's counted FLOPs (impl ``ref``, mesh (1, 1), remat
    ``none``) equal the reference's jaxpr count plus the named ops of one
    package alone, within 1e-9 relative."""
    ref = _ref_flops(arch, kind)
    port = _port_counts(arch, kind).flops
    extra = _port_only(arch, kind)
    assert ref > 0 and port > 0
    assert abs(port - (ref + extra)) <= 1e-9 * ref, (port, ref, extra)
    if arch in ("mamba2-2.7b", "zamba2-2.7b", "whisper-tiny") and \
            (kind == "train" or arch != "whisper-tiny"):
        assert extra > 0          # the named difference is real


def test_remat_policies_order_the_train_steps_flops():
    """hf > remat_aware > none at T 512: hf recomputes every layer's
    attention forward, remat_aware recomputes the layers but not the
    attention, none recomputes nothing.  (remat_aware reruns ``post``
    whole, its last product included, which the checkpoint under hf stops
    short of: at T 64 that product outweighs the smoke attention.)"""
    cfg = smoke_config(get_config("smollm-360m"))
    mesh = make_meta_mesh(("data", "model"), (1, 1))
    f = {}
    for r in ("hf", "remat_aware", "none"):
        step, live = build_step(cfg, ShapeSpec("t", 512, B, "train"), mesh,
                                remat=r)
        with counting(*live) as c:
            step()
        f[r] = c.flops
    assert f["hf"] > f["remat_aware"] > f["none"], f


# --------------------------------------------------- collectives on meta

@pytest.mark.parametrize("sched", ["ring", "balanced", "zigzag", "ulysses"])
def test_meta_comm_bytes_equal_the_static_cost(sched):
    """One ``dist_flash_attn`` forward at P = 4 on every rank of a (1, 4)
    meta mesh: the hop-weighted shift bytes equal ``plan_cost``'s forward
    comm bytes (ring, balanced, zigzag), ulysses' all_to_all bytes
    ``ulysses_cost``'s; nothing else moves."""
    P, Tl, Hq, D = 4, 64, 4, 32
    Hkv = 4 if sched == "ulysses" else 2
    m = tmk.causal()
    if sched == "ulysses":
        want = tsp.ulysses_cost(m, P, Tl=Tl, B=1, Hq=Hq, Hkv=Hkv, Dqk=D,
                                bpe=2).comm_bytes_fwd
    else:
        want = tsp.plan_cost(tsp.build_plan(sched, m, P, Tl), B=1, Hq=Hq,
                             Hkv=Hkv, Dqk=D, bpe=2).comm_bytes_fwd
    for r in range(P):
        mesh = make_meta_mesh(("data", "model"), (1, P), rank=r)
        q = torch.empty(1, Tl, Hq, D, device="meta", dtype=torch.bfloat16)
        k, v = (torch.empty(1, Tl, Hkv, D, device="meta",
                            dtype=torch.bfloat16) for _ in range(2))
        spec = DistAttnSpec(axis="model", axis_size=P, schedule=sched,
                            mask=m, impl="ref")
        with torch.no_grad():
            o, _ = dist_flash_attn(q, k, v, spec, mesh.comms["model"])
        assert o.shape == q.shape
        c = mesh.world.counts
        kind = "all_to_all" if sched == "ulysses" else "shift"
        got = c.bytes[kind] if sched == "ulysses" else c.hop_bytes
        assert got == want, (r, got, want)
        assert c.total_bytes == c.bytes[kind]


def test_meta_mesh_groups_and_production_shapes():
    """make_production_mesh: (16, 16) and (2, 16, 16), a rank's coords and
    its groups' ranks, as the reference's grid orders them."""
    from repro_torch.launch.mesh import make_production_mesh
    m = make_production_mesh(rank=37)
    assert (m.axis_names, m.shape, m.coords) == (("data", "model"),
                                                 (16, 16), (2, 5))
    assert m.comms["model"].ranks == list(range(32, 48))
    assert m.comms["data"].ranks == list(range(5, 256, 16))
    assert m.world.size == 256 and m.world.rank == 37
    m2 = make_production_mesh(True, rank=300)
    assert m2.shape == (2, 16, 16) and m2.coords == (1, 2, 12)
    assert m2.comm(("pod", "data")).size == 32
    assert m2.comm(("data", "model")).rank == 2 * 16 + 12


# --------------------------------------------------------- meta vs real

def _real_counts(arch: str):
    """The same smoke train step on real CPU tensors (weights from a seed,
    the synthetic batch)."""
    cfg = smoke_config(get_config(arch))
    mesh = make_meta_mesh(("data", "model"), (1, 1), device="cpu")
    shape = ShapeSpec("t", T, B, "train")
    step, live = build_step(cfg, shape, mesh, remat="remat_aware",
                            device="cpu")
    params, m, v, batch = live
    real = SyntheticTokens(cfg, shape, device="cpu").batch(0)
    for k, x in batch.items():
        x.copy_(real[k])
    with counting(*live) as c:
        loss = step()
    assert torch.isfinite(loss)
    return c


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_meta_counts_equal_a_real_cpu_step(arch):
    """A smoke train step (loss, grads, AdamW) counted on ``meta`` and on
    real CPU tensors: the same FLOPs, bytes accessed and peak of live
    storage; and the same FLOPs as ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = as_dict(_port_counts(arch, "train", remat="remat_aware"))
    real = as_dict(_real_counts(arch))
    for k in ("flops", "bytes_accessed", "peak_bytes", "tracked_bytes"):
        assert meta[k] == real[k] > 0, (k, meta[k], real[k])
    cfg = smoke_config(get_config(arch))
    step, _ = build_step(cfg, ShapeSpec("t", T, B, "train"),
                         make_meta_mesh(("data", "model"), (1, 1)))
    with FlopCounterMode(display=False) as fc:
        step()
    assert fc.get_total_flops() == meta["flops"]


def test_counter_frees_a_storage_with_its_last_view():
    """A storage counts once while any view of it lives, and its bytes
    leave the live total when the last one dies."""
    with counting() as c:
        x = torch.empty(1024, device="meta")
        v = x[256:]
        n = c.live_bytes
        del x
        assert c.live_bytes == n == 4096
        del v
        assert c.live_bytes == 0
    assert c.peak_bytes == 4096


# ------------------------------------------------------------ shapes, CLI

def test_param_shapes_shard_the_experts_over_seq():
    """param_shapes on a (2, 4) meta mesh: the routed experts hold E / 4
    rows, every other leaf its whole shape."""
    from repro_torch.core.tree import leaves
    from repro_torch.models.transformer import build_model
    cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
    mesh = make_meta_mesh(("data", "model"), (2, 4), rank=5)
    par = make_parallel_config(mesh, ShapeSpec("t", T, 8, "train"))
    model = build_model(cfg, "meta", par=par, mesh=mesh)
    got = param_shapes(model, par, mesh)
    whole = param_shapes(build_model(cfg, "meta"), par, None)
    E = cfg.moe.n_routed
    for lp, lw in zip(got["moe_layers"], whole["moe_layers"]):
        for key in ("wg", "wu", "wd"):
            assert lp["moe"][key] == (E // 4,) + lw["moe"][key][1:]
        assert lp["attn"] == lw["attn"]
    assert len(leaves(got)) == len(leaves(whole))


def test_cli_writes_a_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a smoke arch at a (data
    2, model 4) meta mesh at long_500k: every figure nonzero, the
    Appendix-F window applied."""
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama-7b", "--shape", "long_500k", "--smoke", "--mesh", "2,4",
         "--out", str(out)], capture_output=True, text=True, env=env,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text())
    assert rec["window"] == 8192 and rec["chips"] == 8
    assert rec["mesh"] == {"data": 2, "model": 4}
    for x in (rec["flops"], rec["bytes_accessed"],
              rec["collectives"]["total_bytes"],
              rec["memory"]["peak_device_bytes"], rec["adjusted"]["flops"],
              rec["attention_analytic"]["flops"],
              rec["roofline"]["step_s_lower_bound"],
              rec["model_flops_per_chip"]):
        assert x > 0
