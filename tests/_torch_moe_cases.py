"""Cases shared by the expert-parallel tests (``tests/test_torch_moe_dist.py``
and ``tests/test_torch_deepseek_dist.py``): the reference side (one JAX
process on 8 forced host devices, Auto-axis meshes) and the port side
(``gloo`` worlds of 4 and 8 ranks).  Plain numpy and the port only: the
worlds' ranks import this module, and they must not import jax.

The model is ``deepseek-v2-lite-16b``'s smoke config (4 routed experts, top
2, one shared), so the sequence axis takes S ∈ {2, 4}: meshes (data,
model) = (1, 4) and (2, 4).
"""
import numpy as np

from _torch_dist_cases import load_tree

ARCH = "deepseek-v2-lite-16b"
MESHES = ((1, 4), (2, 4))
CAPS = (4.0, 0.5)            # capacity factors: nothing dropped; drops

# moe_apply / moe_decode_apply on global inputs (B, T, d)
MB, MT = 2, 32


def mesh_name(shape):
    return "%dx%d" % tuple(shape)


def moe_inputs(d):
    """Global x (MB, MT, d), its cotangent, and decode rows (MB, 1, d)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((MB, MT, d)).astype(np.float32)
    cot = rng.standard_normal((MB, MT, d)).astype(np.float32)
    xd = rng.standard_normal((MB, 1, d)).astype(np.float32)
    return x, cot, xd


def with_capacity(cfg, cf):
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


# the deepseek model across ranks
T, B = 32, 2                 # training: (2, 4) holds 8 tokens of 1 row
TC = dict(lr=3e-3, warmup_steps=2, total_steps=4)
TRAIN_STEPS = 3
SCHEDULES = ("balanced", "zigzag")
POLICIES = ("remat_aware", "hf", "none")
SERVE_MESH = (1, 4)
T_PROMPT, N_GEN, N_DEC = 32, 5, 3
SERVE_PAD = 4                # decode slots past the prompt (36 = 4 · 9)


def prompts():
    return np.random.default_rng(33).integers(
        0, 512, (B, T_PROMPT)).astype(np.int32)


def decode_inputs():
    """Three dense decode steps: tokens (B, 1) and per-request positions
    (request 1 rewrites slots inside its prompt)."""
    rng = np.random.default_rng(34)
    return [(rng.integers(0, 512, (B, 1)).astype(np.int32),
             np.array([T_PROMPT + i, T_PROMPT - 4 + i], np.int32))
            for i in range(N_DEC)]


def flat(tree, prefix=""):
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v
    return out


# ------------------------------------------------------------ port side

def _mesh(shape, device="cpu"):
    from repro_torch.launch.mesh import make_local_mesh
    d, s = shape
    return make_local_mesh(seq=s, data=d, device=device)


def _rows(mesh, n):
    """This rank's rows of a batch of ``n`` that shards over data."""
    d = mesh.size("data")
    per = n // d
    return slice(mesh.coord("data") * per, (mesh.coord("data") + 1) * per)


def _cols(mesh, t):
    s = mesh.size("model")
    per = t // s
    return slice(mesh.coord("model") * per, (mesh.coord("model") + 1) * per)


def _global_grads(mesh, grads, sharded):
    """Summed shares (``train.step.sum_grads``) as global numpy arrays:
    the expert shards gathered over the sequence axis."""
    out = []
    for g, s in zip(grads, sharded):
        if s:
            g = mesh.comms["model"].all_gather(g.contiguous(), 0)
        out.append(g.detach().numpy().copy())
    return out


def moe_world(rank, params_path, shape):
    """One rank of a (data, model) = ``shape`` world: per capacity factor,
    ``moe_apply``'s y (this rank's rows), aux and the gradients of
    ``sum(y · cot) + aux`` (x's rows of this rank; every leaf summed and
    gathered to its global value), and ``moe_decode_apply``'s rows; on the
    4-rank world also the autograd ``all_to_all``'s forward and backward,
    each against the plain ``Comm.all_to_all``."""
    import torch
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.models import moe as M
    from repro_torch.parallel.comm import all_to_all

    mesh = _mesh(shape)
    group = mesh.comms["model"]
    base = smoke_config(get_config(ARCH))
    tree = load_tree(params_path)
    e_loc = base.moe.n_routed // group.size
    lo = group.rank * e_loc
    x, cot, xd = moe_inputs(base.d_model)
    rows, cols = _rows(mesh, MB), _cols(mesh, MT)
    names = sorted(tree)
    out = {"rank": rank, "coords": mesh.coords}

    def params():
        p = {}
        for k in names:
            a = tree[k]
            if k in ("wg", "wu", "wd"):
                a = a[lo:lo + e_loc]
            p[k] = torch.from_numpy(np.ascontiguousarray(a)) \
                .requires_grad_(True)
        return p

    dropped = []
    base_slots = M.dispatch_slots

    def slots(flat_e, E, cap):
        slot, keep = base_slots(flat_e, E, cap)
        dropped.append(int((~keep).sum()))
        return slot, keep
    M.dispatch_slots = slots
    for cf in CAPS:
        cfg = with_capacity(base, cf)
        p = params()
        xl = torch.from_numpy(np.ascontiguousarray(x[rows, cols])) \
            .requires_grad_(True)
        y, aux = M.moe_apply(p, xl, cfg, group=group, all_group=mesh.world)
        loss = (y * torch.from_numpy(np.ascontiguousarray(
            cot[rows, cols]))).sum() + aux
        gs = torch.autograd.grad(loss, [xl] + [p[k] for k in names])
        grads = list(gs[1:])
        sharded = [k in ("wg", "wu", "wd") for k in names]
        for g, s in zip(grads, sharded):
            (mesh.comms["data"] if s else mesh.world).all_reduce_([g])
        glob = _global_grads(mesh, grads, sharded)
        res = {"y": y.detach().numpy(), "aux": float(aux.detach()),
               "gx": gs[0].numpy(),
               "grads": dict(zip(names, glob)),
               "dropped": dropped.pop()}
        with torch.no_grad():
            res["dec"] = M.moe_decode_apply(
                params(), torch.from_numpy(np.ascontiguousarray(xd[rows])),
                cfg, group=group).numpy()
        out[cf] = res
    M.dispatch_slots = base_slots
    if mesh.world.size == 4:
        gen = torch.Generator().manual_seed(rank)
        a = torch.randn((4, 3, 5), generator=gen).requires_grad_(True)
        c = torch.randn((1, 12, 5), generator=gen)
        y = all_to_all(group, a, 0, 1)
        g, = torch.autograd.grad((y * c).sum(), a)
        out["a2a"] = dict(fwd=bool(torch.equal(y.detach(), group.all_to_all(
            a.detach(), 0, 1))), shape=tuple(y.shape),
            bwd=bool(torch.equal(g, group.all_to_all(c, 1, 0))),
            a2a_s=group.a2a_s)
    return out


def deepseek_train_world(rank, params_path, ckpt_dir):
    """One rank of the (2, 4) world: per schedule and checkpoint policy,
    step 1's loss, ce, aux and every gradient leaf (summed and gathered
    to global values, in the port's leaf order); a 3-step AdamW
    trajectory with each rank's gnorm and a digest of its replicated
    leaves; the expert-sharded init against the one-rank init;
    ``load_reference_params`` / ``to_reference_params`` round trip; a
    checkpoint of the reference's weights written by rank 0."""
    import torch
    from repro_torch.core.config import (ShapeSpec, TrainConfig, get_config,
                                         smoke_config)
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.io import checkpoint as ckpt
    from repro_torch.models.transformer import (DecoderLM, expert_mask,
                                                load_reference_params,
                                                to_reference_params,
                                                trainable)
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.train.step import make_train_step, sum_grads

    mesh = _mesh((2, 4))
    cfg = smoke_config(get_config(ARCH))
    tree = load_tree(params_path)
    shape = ShapeSpec("tt", T, B, "train")
    out = {"rank": rank}

    def model_of(sched, remat="remat_aware"):
        par = make_parallel_config(mesh, shape, schedule=sched, remat=remat)
        return DecoderLM(cfg, "cpu", par=par, mesh=mesh)

    def params_of(model):
        return trainable(load_reference_params(
            cfg, tree, "cpu", experts=model.expert_group))

    for sched in SCHEDULES:
        for remat in POLICIES:
            model = model_of(sched, remat)
            params = params_of(model)
            batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                    par=model.par).batch(0)
            loss, met = model.loss(params, batch)
            grads, sharded = sum_grads(model, params, torch.autograd.grad(
                loss, leaves(params)))
            out[f"{sched}/{remat}"] = dict(
                loss=float(loss.detach()), ce=float(met["ce"].detach()),
                aux=float(met["aux"].detach()),
                grads=_global_grads(mesh, grads, sharded))
    model = model_of("balanced")
    params = params_of(model)
    opt = adamw.init(params)
    step = make_train_step(model, TrainConfig(**TC))
    ds = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh, par=model.par)
    traj = []
    for i in range(TRAIN_STEPS):
        m = step(params, opt, ds.batch(i))
        traj.append((m["loss"], m["ce"], m["aux"], m["gnorm"],
                     m["skipped_nonfinite"]))
    out["traj"] = traj
    rep = [t for t, s in zip(leaves(params), expert_mask(params)) if not s]
    out["replicated_sum"] = float(sum(t.detach().double().sum()
                                      for t in rep))
    out["expert_shapes"] = sorted({tuple(t.shape) for t, s in zip(
        leaves(params), expert_mask(params)) if s})
    # the init: every leaf of this rank equal to the one-rank init's (its
    # rows of the experts)
    mine = model.init(7)
    one = DecoderLM(cfg, "cpu").init(7)
    g = model.expert_group
    e = cfg.moe.n_routed // g.size
    same = True
    for a, b, s in zip(leaves(mine), leaves(one), expert_mask(one)):
        same &= torch.equal(a, b[g.rank * e:(g.rank + 1) * e] if s else b)
    out["init_slice"] = bool(same)
    # the reference tree through the port and back (gathered)
    back = to_reference_params(params_of(model), experts=g)
    out["round_trip"] = all(
        np.array_equal(v.detach().numpy(), np.asarray(tree_leaf(tree, k)))
        for k, v in ckpt.flatten(back).items())
    if rank == 0:
        ckpt.save(ckpt_dir, {"params": back}, step=3)
    return out


def tree_leaf(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[part]
    return node


def deepseek_serve_world(rank, params_path):
    """One rank of the (1, 4) world, per capacity factor: the whole-prompt
    prefill's last logits and this rank's ``{"ckv"}`` shard, then the
    cache padded to T_PROMPT + SERVE_PAD slots and three dense decode
    steps (logits and the padded shard after each); ``FixedSlotEngine``'s
    greedy tokens and last logits.  Also kernel A's plain chunk call and
    the empty partials of ``execute_fwd`` / ``execute_bwd`` at q/k 48,
    v 32 under the balanced plan (the shapes each was given)."""
    import torch
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import FixedSlotEngine

    mesh = _mesh(SERVE_MESH)
    base = smoke_config(get_config(ARCH))
    tree = load_tree(params_path)
    out = {"rank": rank}
    toks = prompts()
    for cf in CAPS:
        cfg = with_capacity(base, cf)
        par = make_parallel_config(mesh, ShapeSpec("srv", T_PROMPT, B,
                                                   "decode"))
        model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
        params = load_reference_params(cfg, tree, "cpu",
                                       experts=model.expert_group)
        res = {}
        logits, cache = model.prefill(params, torch.from_numpy(toks))
        res["prefill"] = (logits.numpy(), cache["ckv"].numpy().copy())
        cache = model.pad_cache(cache, T_PROMPT + SERVE_PAD)
        res["decode"] = []
        for tok, pos in decode_inputs():
            lg = model.decode(params, cache, torch.from_numpy(tok),
                              torch.from_numpy(pos))
            res["decode"].append((lg.numpy(), cache["ckv"].numpy().copy()))
        t, lg = FixedSlotEngine(model, params).generate({"tokens": toks},
                                                        N_GEN)
        res["tokens"], res["logits"] = t.numpy(), lg[:, -1].numpy()
        out[cf] = res
    out["pair"] = pair_partials(mesh)
    return out


def pair_inputs():
    """Global q/k (1, 64, 2, 48), v (1, 64, 2, 32) and a cotangent of o."""
    rng = np.random.default_rng(35)
    q, k = (rng.standard_normal((1, 64, 2, 48)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
             for _ in range(2))
    return q, k, v, do


def pair_partials(mesh):
    """``dist_flash_attn`` at q/k 48, v 32 under the balanced plan on this
    rank's shard: o, dq, dk, dv, and the shapes of every empty partial the
    forward built and of every ``o`` the backward gave the chunk kernel."""
    import torch
    from repro_torch.core import dist_attention as da
    from repro_torch.core import schedule as sp

    seen = {"empty": [], "bwd_o": []}
    base_empty, base_bwd = sp.empty_partial, sp.chunk_attn_bwd

    def empty(q, dv=None):
        o, lse = base_empty(q, dv)
        seen["empty"].append(tuple(o.shape))
        return o, lse

    def bwd(q, k, v, o, *a, **kw):
        seen["bwd_o"].append(tuple(o.shape))
        return base_bwd(q, k, v, o, *a, **kw)

    sp.empty_partial, sp.chunk_attn_bwd = empty, bwd
    try:
        P = mesh.size("model")
        cols = _cols(mesh, 64)
        q, k, v, do = (torch.from_numpy(np.ascontiguousarray(a[:, cols]))
                       for a in pair_inputs())
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        spec = da.DistAttnSpec(axis="model", axis_size=P,
                               schedule="balanced", scale=48 ** -0.5)
        o, _ = da.dist_flash_attn(q, k, v, spec, mesh.comms["model"])
        g = torch.autograd.grad((o * do).sum(), (q, k, v))
    finally:
        sp.empty_partial, sp.chunk_attn_bwd = base_empty, base_bwd
    return dict(o=o.detach().numpy(), grads=[x.numpy() for x in g], **seen)


def card_moe_inputs(cfg):
    """Float32 MoE weights (every expert) and x (MB, MT, d) for the card's
    2-rank check, from a seeded numpy generator."""
    rng = np.random.default_rng(36)
    m, d = cfg.moe, cfg.d_model
    ds = m.n_shared * m.d_expert

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"ln": np.ones(d, np.float32), "router": w(d, m.n_routed),
         "wg": w(m.n_routed, d, m.d_expert), "wu": w(m.n_routed, d,
                                                      m.d_expert),
         "wd": w(m.n_routed, m.d_expert, d), "sh_wg": w(d, ds),
         "sh_wu": w(d, ds), "sh_wd": w(ds, d)}
    return p, rng.standard_normal((MB, MT, d)).astype(np.float32)


def card_moe_world(rank):
    """One rank of a 2-rank world on the card (host-staged gloo): this
    rank's rows of ``moe_apply`` over the sequence group with its half of
    the experts (y and aux on the host) and the expert choices it made."""
    import torch
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.models import moe as M

    mesh = _mesh((1, 2), "cuda")
    group = mesh.comms["model"]
    cfg = smoke_config(get_config(ARCH))
    p, x = card_moe_inputs(cfg)
    e = cfg.moe.n_routed // group.size
    p = {k: torch.from_numpy(v[group.rank * e:(group.rank + 1) * e]
                             if k in ("wg", "wu", "wd") else v).cuda()
         for k, v in p.items()}
    seen = []
    base = M.top_k

    def top_k(probs, k):
        vals, idx = base(probs, k)
        seen.append(idx.cpu())
        return vals, idx
    M.top_k = top_k
    try:
        xl = torch.from_numpy(np.ascontiguousarray(
            x[:, _cols(mesh, MT)])).cuda()
        y, aux = M.moe_apply(p, xl, cfg, group=group, all_group=mesh.world)
    finally:
        M.top_k = base
    return (group.rank, mesh.transport, y.cpu(), float(aux), seen[0],
            group.a2a_s)
