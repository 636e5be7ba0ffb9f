"""DeepSeek-V3 with multi-token prediction (MTP) in the port against the
reference, on the CPU.

The smoke config of ``deepseek-v3-671b`` (``tests/_torch_mtp_cases.py``):
its one MTP block predicts token t + 2 from (h_t, emb_{t+1}) and adds
0.3 · mtp_ce to the loss.  The reference side is one JAX process on 4
forced host devices with Auto-axis ``(data, seq, head)`` meshes: the
loss, ce, aux, mtp_ce and every gradient on (1, 1, 1), (1, 4, 1) and
(1, 2, 2) under balanced; its refusal of a packed batch; and
``FixedSlotEngine`` and the paged ``Engine`` at one rank.  It saves its
``DecoderLM.init`` weights for the port.  The port's multi-rank cases run
in one 4-rank ``gloo`` world, its one-rank cases in this process.  This
is the first check of MLA's low-rank query path (``wq_a`` → ``q_ln`` →
``wq_b``): deepseek-v3 is the first config with ``q_lora_rank`` > 0.

Bars: the distributed bars of ROADMAP item 1 — loss, ce, aux and mtp_ce
2e-5, every gradient leaf 5e-5; serving tokens equal, last logits within
1e-4 × max |logit|.  Each planted fault of the t + 2 shift — each rank
rolling its own shard, a 2D mesh shifting over ``seq`` alone, labels of
t + 1 — must miss a bar.  The world and the reference process run under
time limits of their own.  Also here: every ``ARCH_IDS`` entry's config,
``param_count`` and ``attention_analytic`` against the reference's (the
latter repaired for the hybrid's and the encoder–decoder's sites).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mtp_cases as C
from _torch_dist_cases import load_tree
from repro_torch.analysis import roofline as TR
from repro_torch.core import config as TC
from repro_torch.core.tree import leaves
from repro_torch.io import checkpoint as ckpt
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import (DecoderLM, build_model,
                                            expert_mask,
                                            load_reference_params,
                                            to_reference_params)
from repro_torch.serve.engine import Engine, FixedSlotEngine

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
LOGIT_REL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_mtp_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
from repro.serve.engine import Engine, FixedSlotEngine
devs = np.array(jax.devices())
def mesh_of(d, r, u):
    return Mesh(devs[:d * r * u].reshape(d, r, u), ("data", "seq", "head"),
                axis_types=(AxisType.Auto,) * 3)
def flat(tree, prefix):
    return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
cfg = smoke_config(get_config(C.ARCH))
shape = ShapeSpec("tt", C.T, C.B, "train")
out, params = {{}}, None
for m in C.MESHES:
    mesh = mesh_of(*m)
    par = make_parallel_config(mesh, shape, schedule="balanced",
                               remat="none")
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    if params is None:
        params = model.init(jax.random.PRNGKey(0))
        np.savez({params_path!r}, **flat(params, ""))
    batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    key = C.mesh_name(m) + "/"
    out[key + "loss"] = np.asarray(loss)
    for k in ("ce", "aux", "mtp_ce"):
        out[key + k] = np.asarray(met[k])
    out.update(flat(grads, key + "g/"))
    if m == C.MESHES[0]:
        packed = dict(batch, segment_ids=jnp.ones_like(batch["tokens"]))
        try:
            model.loss(params, packed)
            out["packed/error"] = np.asarray("no error")
        except ValueError as e:
            out["packed/error"] = np.asarray(str(e))
mesh = mesh_of(1, 1, 1)
par = make_parallel_config(mesh, ShapeSpec("srv", C.T_PROMPT, C.B, "decode"))
model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
toks = jnp.asarray(C.prompts(cfg.vocab))
for n in (C.N_GEN, C.N_GEN - 1):
    t, lg = FixedSlotEngine(model, params).generate({{"tokens": toks}}, n)
    out[f"serve/tokens/{{n}}"] = np.asarray(t)
    out[f"serve/logits/{{n}}"] = np.asarray(lg[:, -1], np.float32)
eng = Engine(model, params, **C.ENGINE)
out["paged/tokens"] = np.asarray(eng.generate({{"tokens": toks}}, C.N_GEN))
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    path, params_path = str(tmp / "ref.npz"), str(tmp / "params.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            tests=TESTS, path=path, params_path=params_path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), params_path


@pytest.fixture(scope="module")
def world(reference):
    return spawn(C.world, 4, (reference[1],), device="cpu", timeout=180)


@pytest.fixture(scope="module")
def cfg():
    return TC.smoke_config(TC.get_config(C.ARCH))


@pytest.fixture(scope="module")
def tree(reference):
    return load_tree(reference[1])


@pytest.fixture(scope="module")
def one_rank(cfg, tree):
    """The port's one-rank runs: the right one and the t + 1 labels."""
    shape = TC.ShapeSpec("tt", C.T, C.B, "train")
    return {fault: C.run_case(DecoderLM(cfg, "cpu"), cfg, tree, shape,
                              fault) for fault in (None, "t_plus_1")}


def _ref_grads(ref, key, cfg):
    """The reference's gradients of case ``key`` in the port's leaf
    order."""
    tree = {}
    pre = key + "/g/"
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return [t.numpy() for t in leaves(load_reference_params(cfg, tree,
                                                            "cpu"))]


def _worst(grads, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(grads, want))


def _misses(got, ref, key, cfg):
    """Does ``got`` miss a bar against the reference's case ``key``?"""
    off = max(abs(got[k] - float(ref[f"{key}/{k}"]))
              for k in ("loss", "mtp_ce"))
    return off > FWD_TOL or _worst(got["grads"],
                                   _ref_grads(ref, key, cfg)) > GRAD_TOL


def _assert_matches(got, ref, key, cfg):
    for k in ("loss", "ce", "aux", "mtp_ce"):
        assert abs(got[k] - float(ref[f"{key}/{k}"])) <= FWD_TOL, \
            (k, got[k], float(ref[f"{key}/{k}"]))
    want = _ref_grads(ref, key, cfg)
    assert len(got["grads"]) == len(want)
    for g, w in zip(got["grads"], want):
        assert g.shape == w.shape
    assert _worst(got["grads"], want) <= GRAD_TOL


# ------------------------------------------------------------ training

def test_loss_and_grads_at_one_rank_match_reference(reference, one_rank,
                                                    cfg):
    """(1, 1, 1): loss = ce + aux + 0.3 · mtp_ce, each within 2e-5 of the
    reference's, and every gradient leaf — the ``mtp`` block's and the
    low-rank query's among them — within 5e-5."""
    got = one_rank[None]
    _assert_matches(got, reference[0], "1x1x1", cfg)
    assert abs(got["loss"] - (got["ce"] + got["aux"]
                              + 0.3 * got["mtp_ce"])) <= 1e-6
    assert got["aux"] > 0 and got["mtp_ce"] > 0


@pytest.mark.parametrize("key", [f"{C.mesh_name(m)}/{s}"
                                 for m, s in C.WORLD])
def test_loss_and_grads_across_ranks_match_reference(key, reference, world,
                                                     cfg):
    """(1, 4, 1) and (1, 2, 2): every rank's loss, ce, aux and mtp_ce
    within 2e-5 of the reference's balanced run on the same mesh, and
    every gradient leaf (replicated leaves summed over the world, expert
    shards gathered) within 5e-5; zigzag asked for runs balanced, on
    contiguous tokens."""
    mesh = key.split("/")[0]
    for r in world:
        got = r[key]
        _assert_matches(got, reference[0], mesh, cfg)
        n = C.T // 4
        assert got["contiguous"] == list(range(r["rank"] * n,
                                               (r["rank"] + 1) * n))


@pytest.mark.parametrize("fault,mesh", [
    (k, C.mesh_name(m)) for k, ms in C.FAULTS.items() for m in ms])
def test_planted_shift_faults_miss_a_bar(fault, mesh, reference, world,
                                         one_rank, cfg):
    """Each rank rolling its own shard, a 2D mesh shifting over ``seq``
    alone, and labels of t + 1 each miss the loss or the gradient bar."""
    if mesh == "1x1x1":
        got = [one_rank[fault]]
    else:
        got = [r[f"{fault}/{mesh}"] for r in world]
    for g in got:
        assert _misses(g, reference[0], mesh, cfg)


def test_packed_batch_with_mtp_raises(cfg, reference):
    """Packed ``segment_ids`` with MTP raise, with the reference's words."""
    model = DecoderLM(cfg, "cpu")
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int32),
             "labels": torch.zeros(1, 8, dtype=torch.int32),
             "segment_ids": torch.ones(1, 8, dtype=torch.int32)}
    with pytest.raises(ValueError) as e:
        model.loss(model.init(0), batch)
    assert str(e.value) == str(reference[0]["packed/error"])


def test_mtp_subtree_round_trips(cfg, tree, tmp_path):
    """``to_reference_params`` ∘ ``load_reference_params`` gives back the
    reference's ``mtp`` subtree bit for bit (its experts not stacked by
    layer, the router float32), the checkpoint restores it, and
    ``expert_mask`` marks its routed experts."""
    params = load_reference_params(cfg, tree, "cpu")
    back = to_reference_params(params)
    ref_m = tree["mtp"]
    got_m = back["mtp"]
    assert sorted(got_m) == sorted(ref_m) == ["layer", "ln_e", "ln_f",
                                              "ln_h", "proj"]
    for grp in ("attn", "moe"):
        for name, arr in ref_m["layer"][grp].items():
            np.testing.assert_array_equal(
                got_m["layer"][grp][name].numpy(), arr)
    assert got_m["layer"]["moe"]["router"].dtype == torch.float32
    assert got_m["layer"]["moe"]["wg"].shape[0] == cfg.moe.n_routed
    assert "q_ln" in got_m["layer"]["attn"]
    ckpt.save(str(tmp_path / "ck"), {"params": back}, step=1)
    again = ckpt.restore(str(tmp_path / "ck"), {"params": back})["params"]
    for a, b in zip(leaves(again["mtp"]), leaves(back["mtp"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    marks = dict(zip(map(id, leaves(params)), expert_mask(params)))
    moe = params["mtp"]["layer"]["moe"]
    for name in moe:
        assert marks[id(moe[name])] == (name in ("wg", "wu", "wd"))


def test_init_tree_matches_reference(cfg, tree):
    """The port's init has the reference's tree, the ``mtp`` block
    included, and keeps an MTP-free config's draws: the leaves of the
    same config without ``mtp_depth`` are the leading ones, bit for
    bit."""
    def shapes(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in shapes(v, pre + k + "/").items()}
        return {pre[:-1]: tuple(t.shape)}
    mine = to_reference_params(DecoderLM(cfg, "cpu").init(0))
    assert shapes(mine) == shapes(tree)
    plain = DecoderLM(cfg.replace(mtp_depth=0), "cpu").init(0)
    full = DecoderLM(cfg, "cpu").init(0)
    assert "mtp" not in plain
    for a, b in zip(leaves(plain), leaves({k: full[k] for k in plain})):
        assert torch.equal(a, b)


# ------------------------------------------------------------- serving

def test_served_by_both_engines_matches_reference(reference, cfg, tree):
    """The smoke model, its MTP block loaded and unused: ``FixedSlotEngine``
    and the paged ``Engine`` (16-token chunks over a latent pool) give the
    reference's greedy tokens, and their last decode logits are within
    1e-4 × max |logit| of the reference's."""
    ref = reference[0]
    model = DecoderLM(cfg, "cpu")
    params = load_reference_params(cfg, tree, "cpu")
    assert "mtp" in params
    toks = C.prompts(cfg.vocab)
    for n in (C.N_GEN, C.N_GEN - 1):
        t, lg = FixedSlotEngine(model, params).generate(
            {"tokens": toks}, n)
        np.testing.assert_array_equal(t.numpy(), ref[f"serve/tokens/{n}"])
        want = ref[f"serve/logits/{n}"]
        err = float(np.abs(lg[:, -1].numpy() - want).max())
        assert err <= LOGIT_REL * float(np.abs(want).max()), err
    seen = []
    decode = model.decode

    def recording(*a, **k):
        out = decode(*a, **k)
        seen.append(out)
        return out
    model.decode = recording
    try:
        out = Engine(model, params, **C.ENGINE).generate({"tokens": toks},
                                                         C.N_GEN)
    finally:
        del model.decode
    np.testing.assert_array_equal(np.asarray(out), ref["paged/tokens"])
    # the paged engine's last decode predicts token N_GEN, as the
    # fixed-slot run of N_GEN − 1 tokens' last logits do
    want = ref[f"serve/logits/{C.N_GEN - 1}"]
    err = float(np.abs(seen[-1][:, -1].numpy() - want).max())
    assert err <= LOGIT_REL * float(np.abs(want).max()), err


# ----------------------------------------------- configs and the roofline

@pytest.mark.parametrize("arch", TC.ARCH_IDS + TC.PAPER_ARCH_IDS)
def test_config_param_count_and_smoke_build_match_reference(arch):
    """Every architecture of the reference has a port config with its
    fields, ``param_count`` and ``active_param_count``, at full size and
    smoke size (deepseek-v3: 6.701e11, its MTP block not counted, as in
    the reference); every smoke config builds and inits on the CPU."""
    from repro.core import config as RC
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert TC.PAPER_ARCH_IDS == RC.PAPER_ARCH_IDS
    rc, tc = RC.get_config(arch), TC.get_config(arch)
    assert repr(rc) == repr(tc)
    for r, t in ((rc, tc), (RC.smoke_config(rc), TC.smoke_config(tc))):
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()
    if arch == C.ARCH:
        assert f"{tc.param_count():.3e}" == "6.701e+11"
        assert tc.mtp_depth == 1 and TC.smoke_config(tc).mtp_depth == 1
    params = build_model(TC.smoke_config(tc), "cpu").init(0)
    assert all(torch.isfinite(x).all() for x in leaves(params))


@pytest.mark.parametrize("arch", TC.ARCH_IDS + TC.PAPER_ARCH_IDS)
def test_attention_analytic_matches_reference(arch):
    """``attention_analytic`` equals the reference's at a train, a prefill
    and a decode shape, at 4 sequence shards and at (8, 2): deepseek-v3's
    MTP block, zamba2's one shared site a ``hybrid_period``, whisper's
    encoder self-attention and decoder cross-attention."""
    from repro.analysis import roofline as RR
    from repro.core import config as RC
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for seq, batch in ((4, 1), (8, 2)):
            got = TR.attention_analytic(TC.get_config(arch),
                                        TC.get_shape(shape),
                                        seq_shards=seq, batch_shards=batch)
            want = RR.attention_analytic(RC.get_config(arch),
                                         RC.get_shape(shape),
                                         seq_shards=seq, batch_shards=batch)
            assert got == want, (shape, seq, got, want)
