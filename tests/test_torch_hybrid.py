"""The SSM and hybrid decoders — smoke mamba2-2.7b and zamba2-2.7b — in the
port's ``DecoderLM`` against the reference's on the CPU: the loss and every
gradient leaf at one rank and at 4 under ``balanced`` and ``zigzag`` (which
falls back to ``balanced`` for these families), the prefill's logits, a
greedy recurrent decode from the empty cache step for step in float32 and
in bf16, the empty
cache's shapes, the weights' round trip, a few AdamW steps, and the 2D mesh
accepted.

The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, model)`` meshes; it saves its ``DecoderLM.init`` weights
for the port.  The port's 4-rank cases run in one ``gloo`` world
(``tests/_torch_hybrid_cases.py``), its one-rank cases in this process.
Bars: the distributed bars of ROADMAP item 1 — loss and logits 2e-5, every
gradient leaf 5e-5.

The reference's own zigzag run of the hybrid is off (ROADMAP fault 3.8):
its shared block builds its attention from a dense copy of the config,
whose ``_zigzag_ok`` lets the zigzag plan run on the contiguous layout the
hybrid keeps.  The port's zigzag is held to the reference's balanced run.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_hybrid_cases as C
from _torch_dist_cases import load_tree
from repro_torch.core.config import (ShapeSpec, TrainConfig, get_config,
                                     smoke_config)
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticTokens, empty_decode_cache
from repro_torch.launch.world import spawn
from repro_torch.models.transformer import (DecoderLM,
                                            load_reference_params,
                                            to_reference_params, trainable)
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
sys.path.insert(0, {tests!r})
import _torch_hybrid_cases as C
from repro.core.config import ShapeSpec, get_config, smoke_config
from repro.data.pipeline import SyntheticTokens, cache_specs
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config
devs = np.array(jax.devices())
def mesh_of(P):
    return Mesh(devs[:P].reshape(1, P), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
def flat(tree, prefix):
    return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}}
shape = ShapeSpec("tt", C.T, C.B, "train")
out = {{}}
for arch in C.ARCHS:
    cfg = smoke_config(get_config(arch))
    params = None
    for case in C.CASES:
        P, sched = case
        if sched == "zigzag" and cfg.arch_type == "ssm":
            continue        # no attention: its zigzag is its balanced run
        mesh = mesh_of(P)
        par = make_parallel_config(mesh, shape, schedule=sched,
                                   remat="none")
        model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
        if params is None:
            params = model.init(jax.random.PRNGKey(0))
            np.savez({params_dir!r} + "/" + arch + ".npz",
                     **flat(params, ""))
        batch = SyntheticTokens(cfg, shape, par, mesh).batch(0)
        (loss, met), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, batch)
        key = arch + "/" + C.case_name(case) + "/"
        out[key + "loss"] = np.asarray(loss)
        out.update(flat(grads, key + "g/"))
    mesh = mesh_of(1)
    toks = jnp.asarray(C.prompts(cfg.vocab))
    dshape = ShapeSpec("dec", C.T_PROMPT + C.N_GEN, C.B, "decode")
    par = make_parallel_config(mesh, dshape)
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    lg, cache = jax.jit(model.prefill)(params, {{"tokens": toks}})
    out[arch + "/prefill"] = np.asarray(lg)
    assert cache == {{}}
    specs, _ = cache_specs(cfg, dshape, par)
    for k, s in specs.items():
        out[arch + "/cache/" + k] = np.asarray(s.shape)
        out[arch + "/cache_dtype/" + k] = np.asarray(str(s.dtype))
    def run(model, cfg, params, forced=None):
        specs, _ = cache_specs(cfg, dshape, par)
        cache = {{k: jnp.zeros(s.shape, s.dtype) for k, s in specs.items()}}
        dec = jax.jit(model.decode)
        rows, gen, tok = [], [], None
        for t in range(C.T_PROMPT + C.N_GEN):
            if t >= C.T_PROMPT:
                tok = tok if forced is None else forced[:, t - C.T_PROMPT]
                gen.append(np.asarray(tok))
            cur = toks[:, t:t + 1] if t < C.T_PROMPT else tok[:, None]
            lg, cache = dec(params, cache, {{"token": cur,
                                            "pos": jnp.full((C.B,), t,
                                                            jnp.int32)}})
            rows.append(np.asarray(lg[:, 0].astype(jnp.float32)))
            tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
        return np.stack(rows), np.stack(gen, axis=1)
    rows, gen = run(model, cfg, params)
    out[arch + "/decode_logits"] = rows
    out[arch + "/decode_tokens"] = gen
    # bf16: the bf16 init of the same key (the float32 weights cast), its
    # greedy stream, and the float32 model's decode on that stream
    cfg16 = cfg.replace(dtype="bfloat16")
    model16 = build_model(cfg16, Runtime(mesh=mesh, par=par, impl="ref"))
    p16 = model16.init(jax.random.PRNGKey(0))
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: bool((a == b.astype(a.dtype)).all()), p16, params)))
    rows, gen = run(model16, cfg16, p16)
    out[arch + "/decode16_logits"] = rows
    out[arch + "/decode16_tokens"] = gen
    out[arch + "/decode16_f32_logits"] = run(model, cfg, params,
                                             jnp.asarray(gen))[0]
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' many small operators run on one thread: the
    suite runs several files at once, and threads that wait for each
    other's parallel regions slow every file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    path = str(tmp / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(
            tests=TESTS, path=path, params_dir=str(tmp))],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path)), str(tmp)


@pytest.fixture(scope="module")
def world(reference):
    return spawn(C.model_world, C.WORLD, (reference[1],), device="cpu",
                 timeout=150)


def _cfg(arch):
    return smoke_config(get_config(arch))


def _tree(reference, arch):
    return load_tree(f"{reference[1]}/{arch}.npz")


def _ref_grads(ref, arch, key):
    """The reference's gradients of case ``key`` in the port's leaf
    order."""
    pre = f"{arch}/{key}/g/"
    tree = {}
    for k, v in ref.items():
        if k.startswith(pre):
            node = tree
            *head, last = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return [t.numpy() for t in leaves(load_reference_params(
        _cfg(arch), tree, "cpu"))]


def _one_rank(reference, arch):
    """Loss and gradient leaves of the port at one rank on the reference's
    weights and batch (remat_aware, balanced)."""
    cfg = _cfg(arch)
    model = DecoderLM(cfg, "cpu")
    params = trainable(load_reference_params(cfg, _tree(reference, arch),
                                             "cpu"))
    batch = SyntheticTokens(cfg, ShapeSpec("tt", C.T, C.B, "train"),
                            device="cpu").batch(0)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params))
    return float(loss.detach()), [g.numpy() for g in grads]


def _held(loss, grads, ref, arch, key):
    want = _ref_grads(ref, arch, key)
    assert abs(loss - float(ref[f"{arch}/{key}/loss"])) <= FWD_TOL, \
        (loss, float(ref[f"{arch}/{key}/loss"]))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=GRAD_TOL)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_one_rank_loss_and_grads_match_reference(arch, reference):
    """One rank: the loss within 2e-5 of the reference's and every
    gradient leaf within 5e-5 (the SSM layers under layer-boundary
    checkpointing, zamba2's shared block under remat_aware through kernels
    A, C and D's plain versions)."""
    _held(*_one_rank(reference, arch), reference[0], arch, "1/balanced")


@pytest.mark.parametrize("arch", C.ARCHS)
@pytest.mark.parametrize("sched", ["balanced", "zigzag"])
def test_four_ranks_loss_and_grads_match_reference(arch, sched, reference,
                                                   world):
    """4 ranks of 32 tokens (the state relayed, the conv halo shifted,
    zamba2's shared attention through the balanced plan): every rank's
    loss within 2e-5 of the reference's balanced run and every summed
    gradient leaf within 5e-5; zigzag falls back to balanced (the tokens
    stay contiguous: 32 columns a rank)."""
    for r in world:
        got = r[f"{arch}/4/{sched}"]
        assert got["cols"] == C.T // C.WORLD
        _held(got["loss"], got["grads"], reference[0], arch, "4/balanced")


def test_reference_hybrid_zigzag_is_off(reference, world):
    """ROADMAP fault 3.8 (reference side): the reference's zamba2 under
    zigzag at 4 ranks misses its own balanced loss by more than the bar,
    while the port's zigzag run equals it."""
    ref = reference[0]
    arch = "zamba2-2.7b"
    off = abs(float(ref[f"{arch}/4/zigzag/loss"])
              - float(ref[f"{arch}/4/balanced/loss"]))
    assert off > 10 * FWD_TOL, off
    port = world[0][f"{arch}/4/zigzag"]["loss"]
    assert abs(port - float(ref[f"{arch}/4/balanced/loss"])) <= FWD_TOL


@pytest.mark.parametrize("arch", C.ARCHS)
def test_prefill_logits_match_reference(arch, reference):
    """The prefill's last-token logits within 2e-5 of the reference's, and
    no cache (the SSM decode starts from the empty cache)."""
    cfg = _cfg(arch)
    model = DecoderLM(cfg, "cpu")
    params = load_reference_params(cfg, _tree(reference, arch), "cpu")
    logits, cache = model.prefill(params, C.prompts(cfg.vocab))
    assert cache == {}
    np.testing.assert_allclose(logits.numpy(),
                               reference[0][f"{arch}/prefill"],
                               atol=FWD_TOL)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_greedy_recurrent_decode_matches_reference(arch, reference):
    """The prompt fed token by token from the empty cache, then greedy
    tokens: every step's logits within 2e-5 of the reference's decode on
    the reference's stream, every greedy pick equal to its token, and the
    prompt's last logits equal to the prefill's."""
    ref = reference[0]
    cfg = _cfg(arch)
    model = DecoderLM(cfg, "cpu")
    params = load_reference_params(cfg, _tree(reference, arch), "cpu")
    toks = torch.from_numpy(C.prompts(cfg.vocab))
    gen = torch.from_numpy(ref[f"{arch}/decode_tokens"])
    stream = torch.cat([toks, gen], dim=1)
    cache = empty_decode_cache(cfg, C.B, C.T_PROMPT + C.N_GEN, "cpu")
    rows = []
    for t in range(C.T_PROMPT + C.N_GEN):
        lg = model.decode(params, cache, stream[:, t:t + 1],
                          torch.full((C.B,), t, dtype=torch.int32))
        rows.append(lg[:, 0].numpy())
        if t >= C.T_PROMPT - 1 and t + 1 < stream.shape[1]:
            assert torch.equal(lg[:, -1].argmax(-1), stream[:, t + 1])
    np.testing.assert_allclose(np.stack(rows), ref[f"{arch}/decode_logits"],
                               atol=FWD_TOL)
    np.testing.assert_allclose(rows[C.T_PROMPT - 1],
                               ref[f"{arch}/prefill"][:, 0], atol=FWD_TOL)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_bf16_recurrent_decode_matches_reference(arch, reference):
    """The same decode in bf16 (the dtype the full-size models run in; the
    reference's bf16 init of the same key, which is its float32 weights
    cast) on the reference's bf16 greedy stream, step for step.  Two
    implementations of one bf16 model agree only up to bf16 rounding, so
    the bar is the reference's own: its bf16 decode against its float32
    decode on the same stream.  Each step's max |Δlogit| / max |logit| of
    a row stays within 4 × the largest of those steps' readings, their
    mean within 2 × theirs; every greedy pick whose top-two gap in the
    reference's logits exceeds twice the step's |Δ| equals its token."""
    ref = reference[0]
    cfg = _cfg(arch).replace(dtype="bfloat16")
    model = DecoderLM(cfg, "cpu")
    params = load_reference_params(cfg, _tree(reference, arch), "cpu")
    toks = torch.from_numpy(C.prompts(cfg.vocab))
    gen = torch.from_numpy(ref[f"{arch}/decode16_tokens"])
    stream = torch.cat([toks, gen], dim=1)
    cache = empty_decode_cache(cfg, C.B, C.T_PROMPT + C.N_GEN, "cpu")
    rows = []
    for t in range(C.T_PROMPT + C.N_GEN):
        lg = model.decode(params, cache, stream[:, t:t + 1],
                          torch.full((C.B,), t, dtype=torch.int32))
        assert lg.dtype == torch.bfloat16
        rows.append(lg[:, 0].float().numpy())
    got = np.stack(rows)
    r16 = ref[f"{arch}/decode16_logits"]
    r32 = ref[f"{arch}/decode16_f32_logits"]

    def rel(a, b):
        return np.abs(a - b).max(-1) / np.abs(b).max(-1)
    err, noise = rel(got, r16), rel(r16, r32)
    assert err.max() <= 4 * noise.max(), (err.max(), noise.max())
    assert err.mean() <= 2 * noise.mean(), (err.mean(), noise.mean())
    top2 = np.sort(r16, axis=-1)[..., -2:]
    for t in range(C.T_PROMPT - 1, stream.shape[1] - 1):
        for b in range(C.B):
            if top2[t, b, 1] - top2[t, b, 0] > 2 * np.abs(
                    got[t, b] - r16[t, b]).max():
                assert got[t, b].argmax() == int(stream[b, t + 1]), (t, b)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_empty_decode_cache_matches_cache_specs(arch, reference):
    """``empty_decode_cache``'s keys, shapes and dtypes are the reference's
    ``cache_specs`` arms: state float32, conv in the model's dtype, and a
    hybrid's shared_k / shared_v for its G groups."""
    ref = reference[0]
    cfg = _cfg(arch)
    cache = empty_decode_cache(cfg, C.B, C.T_PROMPT + C.N_GEN, "cpu")
    want = {k.split("/")[-1] for k in ref if k.startswith(arch + "/cache/")}
    assert set(cache) == want
    for k, t in cache.items():
        assert list(t.shape) == list(ref[f"{arch}/cache/{k}"]), k
        assert str(t.dtype)[6:] == str(ref[f"{arch}/cache_dtype/{k}"]), k
        assert not t.any()


@pytest.mark.parametrize("arch", C.ARCHS)
def test_weights_round_trip(arch, reference):
    """``load_reference_params`` then ``to_reference_params`` gives the
    reference's tree back, leaf for leaf and bit for bit (the SSM's A_log,
    D and dt_bias in float32; zamba2's shared block unstacked)."""
    tree = _tree(reference, arch)
    back = to_reference_params(load_reference_params(_cfg(arch), tree,
                                                     "cpu"))

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + "/" + k)
            else:
                assert b[k].dtype == torch.float32, path + "/" + k
                np.testing.assert_array_equal(b[k].numpy(), a[k])
    walk(tree, back)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_loss_falls_over_adamw_steps(arch):
    """The port's counterpart of ``tests/test_train_integration.py:41``: a
    smoke model (vocab 128) trained 25 AdamW steps on the synthetic stream
    at lr 3e-3 ends at least 0.5 below its first loss."""
    cfg = _cfg(arch).replace(vocab=128)
    model = DecoderLM(cfg, "cpu")
    params = trainable(model.init(0))
    opt = adamw.init(params)
    steps = 25
    step = make_train_step(model, TrainConfig(lr=3e-3, warmup_steps=5,
                                              total_steps=steps))
    ds = SyntheticTokens(cfg, ShapeSpec("ti", 64, 4, "train"), device="cpu")
    losses = [step(params, opt, ds.batch(i))["loss"] for i in range(steps)]
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_two_d_mesh_refused(world):
    """A 2D (seq, head) mesh is refused no longer: both families build on
    it (``tests/test_torch_ssm2d.py`` holds what they compute there to the
    reference)."""
    for r in world:
        for arch in C.ARCHS:
            assert r["refused_2d"][arch] == "accepted"


def test_head_dim_160_routes(monkeypatch):
    """Kernels A, C and D at zamba2's head dim 160, planned on the host
    (the launch itself stubbed): bf16 takes the pair libraries' <160, 160>
    (A with the pair route's 128 × 64 tiles and ``(Dv, v_in_k)`` shipped),
    float32 ``flash_fwd.cu`` / ``flash_bwd.cu``; A counts as
    ``flash_fwd_160``, C and D as ``flash_bwd_dq_160`` /
    ``flash_bwd_dkv_160``, and the other counters stay."""
    from repro_torch.core import mask as mk
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    calls = []

    def entry(lib, name, n_ptrs):
        def launch(*args):
            calls.append((lib, name, list(args[n_ptrs])))
            return 0
        return launch
    monkeypatch.setattr(fa, "_entry", entry)
    monkeypatch.setattr(build, "LAUNCHES", dict(build.LAUNCHES))
    monkeypatch.setattr(build, "stream_ptr", lambda dev: None)
    assert 160 in fa.HEAD_DIMS and 160 in fa.WIDE_DIMS
    for dt, lib, block in ((torch.bfloat16, "flash_fwd_pair_sm90", 128),
                           (torch.float32, "flash_fwd", 64)):
        q = torch.zeros((1, 256, 2, 160), dtype=dt)
        n0 = dict(build.LAUNCHES)
        fa._flash_fwd_cuda(q, q, q, mk.causal(), 160 ** -0.5, None, None,
                           True)
        assert calls[-1][:2] == (lib, fa.PAIR_ROUTES[dt][1] if dt ==
                                 torch.bfloat16 else "repro_flash_fwd")
        ia = calls[-1][2]
        assert ia[5] == 160 and ia[7] == -(-256 // block)
        if dt == torch.bfloat16:
            assert ia[-2:] == [160, 1]        # Dv, v is k (one tensor)
        assert {n: build.LAUNCHES[n] - n0[n] for n in n0
                if build.LAUNCHES[n] != n0[n]} == {"flash_fwd_160": 1}
        pl = fa._BwdPlan(q, q, q, q, torch.zeros((1, 256, 2)), q,
                         mk.causal(), None, None, None, True)
        assert (pl.lib, pl.suffix) == fa.PAIR_BWD_ROUTES[dt]
        assert pl.count == "_160"


@pytest.mark.parametrize("arch", C.ARCHS)
def test_packed_batches_refused(arch):
    """Packed training (``segment_ids``) raises for the SSM families, as
    the reference's ``loss`` does: the scan would carry state across
    documents."""
    cfg = _cfg(arch)
    model = DecoderLM(cfg, "cpu")
    params = model.init(0)
    batch = SyntheticTokens(cfg, ShapeSpec("pk", 64, 2, "train", docs=2),
                            device="cpu").batch(0)
    assert "segment_ids" in batch
    with pytest.raises(ValueError, match="packed"):
        model.loss(params, batch)
