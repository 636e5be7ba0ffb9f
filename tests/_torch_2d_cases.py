"""Cases shared by the two sides of ``tests/test_torch_plan2d.py`` and
``tests/test_torch_dist2d.py``: the reference (one JAX process on forced
host devices, Auto-axis ``(data, seq, head)`` meshes) and the port (8- and
4-rank ``gloo`` worlds on ``launch.mesh.make_seq2d_mesh``).  Plain numpy
and the port only: the worlds' ranks import this module and must not
import jax.

Executor cases are (name, schedule, mask, r, u, Hq, Hkv): global arrays
from a seeded numpy generator (permuted with ``zigzag_perm(T, r)`` for the
2D zigzag case), the sequence sharded over the (seq, head) pair, seq
major, so global rank ``s·u + h`` holds chunk ``s·u + h``.
"""
import numpy as np

B, N, D = 2, 256, 32
WINDOW = 60
PREFIX = 100
NC_WINDOW = 64

EXEC_CASES = []
for _hq, _hkv in ((4, 4), (4, 2)):
    for _m in ("causal", "window", "document"):
        for _r, _u in ((2, 4), (4, 2)):
            EXEC_CASES.append((f"{_hq}-{_hkv}/{_m}/r{_r}u{_u}", "balanced",
                               _m, _r, _u, _hq, _hkv))
EXEC_CASES += [
    ("8-2/prefix/r1u8", "ring", "prefix", 1, 8, 8, 2),
    ("8-2/noncausal-window/r1u8", "ring", "noncausal-window", 1, 8, 8, 2),
    ("8-2/zigzag/r4u2", "zigzag", "causal", 4, 2, 8, 2),
]
EXEC_NAMES = [c[0] for c in EXEC_CASES]
# the causal cases ``auto`` also runs on, in scatter and replicate mode
AUTO_CASES = ("4-4/causal/r2u4", "4-2/causal/r4u2")


def make_mask(mk, kind):
    """The case's global MaskSpec, from either package's ``core.mask``."""
    if kind == "causal":
        return mk.causal()
    if kind == "window":
        return mk.sliding_window(WINDOW)
    if kind == "document":
        return mk.document(boundaries=mk.doc_boundaries(N, 3))
    if kind == "prefix":
        return mk.prefix_lm(PREFIX)
    return mk.MaskSpec(causal=False, window=NC_WINDOW)


def zigzag_perm(T, P):
    c = T // (2 * P)
    order = []
    for p in range(P):
        order.append(np.arange(p * c, (p + 1) * c))
        order.append(np.arange((2 * P - 1 - p) * c, (2 * P - p) * c))
    return np.concatenate(order)


def inputs(case):
    """Global q, k, v and the cotangent ``do`` of o (B, N, ·, D) float32,
    in the layout the ranks shard."""
    name, sched, _, r, _, hq, hkv = case
    rng = np.random.default_rng(100 * hq + hkv)
    q = rng.standard_normal((B, N, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, N, hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, N, hq, D)).astype(np.float32)
    if sched == "zigzag":
        perm = zigzag_perm(N, r)
        q, k, v, do = q[:, perm], k[:, perm], v[:, perm], do[:, perm]
    return q, k, v, do


# ------------------------------------------------------------ port side

def exec_world(rank, names):
    """One rank of the 8-rank world: per case, this rank's shard of o,
    lse and the gradients of sum(o · do), and the plan's KV mode."""
    import torch
    from repro_torch.core import dist_attention as da
    from repro_torch.core import mask as tmk
    from repro_torch.core import schedule as sp
    from repro_torch.launch.mesh import make_seq2d_mesh

    meshes = {ru: make_seq2d_mesh(*ru, device="cpu")
              for ru in sorted({(c[3], c[4]) for c in EXEC_CASES})}
    modes = []
    build = sp.build_plan2d

    def recording(*a, **kw):
        p2 = build(*a, **kw)
        modes.append(p2.kv_mode)
        return p2

    sp.build_plan2d = recording
    out = {}
    Tl = N // 8
    for case in EXEC_CASES:
        name, sched, kind, r, u, hq, hkv = case
        if name not in names:
            continue
        mesh = meshes[(r, u)]
        p = mesh.comm(("seq", "head")).rank
        q, k, v, do = (torch.from_numpy(np.ascontiguousarray(
            a[:, p * Tl:(p + 1) * Tl])) for a in inputs(case))
        spec = da.DistAttnSpec(axis="seq", axis_size=8, schedule=sched,
                               mask=make_mask(tmk, kind),
                               mesh2d=da.Mesh2DSpec(r=r, u=u))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        del modes[:]
        o, lse = da.dist_flash_attn(q, k, v, spec, (mesh.comm("seq"),
                                                    mesh.comm("head")))
        dq, dk, dv = torch.autograd.grad((o * do).sum(), (q, k, v))
        out[name] = dict(o=o.detach().numpy(), lse=lse.numpy(),
                         dq=dq.numpy(), dk=dk.numpy(), dv=dv.numpy(),
                         modes=tuple(modes))
    # schedule="auto": the inner schedule it resolves, and its results
    # against the same call under that name
    out["auto"] = {}
    for name in AUTO_CASES:
        case = EXEC_CASES[EXEC_NAMES.index(name)]
        _, _, kind, r, u, _, _ = case
        mesh = meshes[(r, u)]
        p = mesh.comm(("seq", "head")).rank
        q, k, v, do = (torch.from_numpy(np.ascontiguousarray(
            a[:, p * Tl:(p + 1) * Tl])) for a in inputs(case))
        runs = {}
        for sched in ("auto", None):
            if sched is None:
                sched = da.resolve_schedule(spec, q, k, v, for_bwd=True)
            spec = da.DistAttnSpec(axis="seq", axis_size=8, schedule=sched,
                                   mask=make_mask(tmk, kind),
                                   mesh2d=da.Mesh2DSpec(r=r, u=u))
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            o, lse = da.dist_flash_attn(*x, spec, (mesh.comm("seq"),
                                                   mesh.comm("head")))
            loss = (o * do).sum()
            runs[sched] = [loss.detach(), o.detach(), lse] + list(
                torch.autograd.grad(loss, x))
        (_, got), (named, want) = runs.items()
        out["auto"][name] = dict(
            name=named, shapes=(tuple(q.shape), tuple(k.shape)),
            same=all(torch.equal(a, b) for a, b in zip(got, want)))
    # a 2D spec given one Comm is refused
    mesh = meshes[(2, 4)]
    q = torch.zeros(B, Tl, 4, D)
    spec = da.DistAttnSpec(axis="seq", axis_size=8, schedule="balanced",
                           mesh2d=da.Mesh2DSpec(r=2, u=4))
    try:
        da.dist_attn_fwd(q, q, q, spec=spec, group=mesh.comm(("seq",
                                                              "head")))
        out["one_comm"] = "no error"
    except ValueError as e:
        out["one_comm"] = f"ValueError: {e}"
    return out


# --------------------------------------------------- the model (port side)

ARCHS = ("llama-7b", "llama-gqa")
TRAIN_T, TRAIN_B = 64, 2
TRAIN_TC = dict(lr=3e-3, warmup_steps=2, total_steps=4)
TRAIN_STEPS = 3
# (data, seq, head) mesh and schedule of each training run
TRAIN_MESHES = (((1, 2, 2), "balanced"), ((1, 1, 4), "ring"))
SERVE_MESH = (1, 2, 2)
T_PROMPT, N_GEN = 32, 4


def mesh_name(shape):
    return "x".join(map(str, shape))


def prompts(vocab):
    return np.random.default_rng(0).integers(
        0, vocab, (TRAIN_B, T_PROMPT)).astype(np.int32)


def load_tree(path, prefix):
    """The reference's parameter pytree under ``prefix`` of an npz of
    "/"-joined keys."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            if not key.startswith(prefix + "/"):
                continue
            node = tree
            *head, last = key[len(prefix) + 1:].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[key]
    return tree


def model_world(rank, params_path):
    """One rank of the 4-rank world: each arch's 3-step losses on each
    mesh of ``TRAIN_MESHES`` (with the KV modes the 2D plans took),
    ``FixedSlotEngine`` on ``SERVE_MESH``, and what a 2D mesh refuses:
    zigzag at u > 1 (an MoE model and the paged Engine build there)."""
    from repro_torch.core import schedule as sp
    from repro_torch.core.config import (ShapeSpec, TrainConfig,
                                         get_config, smoke_config)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_seq2d_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import Engine, FixedSlotEngine
    from repro_torch.train.step import make_train_step

    meshes = {m: make_seq2d_mesh(*m[1:], data=m[0], device="cpu")
              for m in sorted({m for m, _ in TRAIN_MESHES} | {SERVE_MESH})}
    modes = []
    build = sp.build_plan2d

    def recording(*a, **kw):
        p2 = build(*a, **kw)
        modes.append(p2.kv_mode)
        return p2

    sp.build_plan2d = recording
    shape = ShapeSpec("tt", TRAIN_T, TRAIN_B, "train")
    out = {"rank": rank}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        tree = load_tree(params_path, arch)
        for m, sched in TRAIN_MESHES:
            mesh = meshes[m]
            par = make_parallel_config(mesh, shape, schedule=sched)
            model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
            params = trainable(load_reference_params(cfg, tree, "cpu"))
            opt = adamw.init(params)
            step = make_train_step(model, TrainConfig(**TRAIN_TC))
            ds = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                 par=par)
            del modes[:]
            losses = []
            for i in range(TRAIN_STEPS):
                res = step(params, opt, ds.batch(i))
                assert res["skipped_nonfinite"] == 0
                losses.append(res["loss"])
            out[f"{arch}/{mesh_name(m)}/{sched}"] = dict(
                losses=losses, modes=sorted(set(modes)),
                seq_axes=par.seq_axes, seq_size=model.seq_size,
                seq_rank=model.seq_rank)
    cfg = smoke_config(get_config("llama-gqa"))
    mesh = meshes[SERVE_MESH]
    par = make_parallel_config(mesh, ShapeSpec("srv", T_PROMPT, TRAIN_B,
                                               "decode"))
    model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
    params = load_reference_params(cfg, load_tree(params_path, "llama-gqa"),
                                   "cpu")
    toks, logits = FixedSlotEngine(model, params).generate(
        {"tokens": prompts(cfg.vocab)}, N_GEN)
    out["serve"] = dict(tokens=toks.numpy(), logits=logits[:, -1].numpy(),
                        shards=model.decode_group.size)
    out["errors"] = {}

    def refusal(key, fn, exc):
        try:
            fn()
            out["errors"][key] = "no error"
        except exc as e:
            out["errors"][key] = f"{type(e).__name__}: {e}"

    zz = make_parallel_config(mesh, shape, schedule="zigzag")
    refusal("zigzag", lambda: DecoderLM(cfg, "cpu", par=zz, mesh=mesh),
            ValueError)
    ds_cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
    refusal("moe", lambda: DecoderLM(ds_cfg, "cpu", par=par, mesh=mesh),
            (NotImplementedError, ValueError))
    built = []
    refusal("engine", lambda: built.append(Engine(model, params)),
            (NotImplementedError, ValueError))
    out["engine_pool"] = (built[0].cache.sharding,
                          built[0].cache.group.size) if built else None
    return out
