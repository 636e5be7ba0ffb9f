"""Cases shared by the two sides of ``tests/test_torch_mtp.py``:
deepseek-v3-671b's smoke config (the dense layer 0 and one MoE layer of 4
routed + 1 shared experts, top 2; MLA with a q_lora of 32, q/k 48, v 32;
one MTP block; float32) at T 64, B 2.  The reference side is one JAX
process on 4 forced host devices; the port's multi-rank side a 4-rank
``gloo`` world: (1, 4, 1) on ``launch.mesh.make_local_mesh`` and
(1, 2, 2) on ``make_seq2d_mesh``.  Plain numpy and the port only: the
world's ranks import this module and must not import jax.
"""
import numpy as np

from _torch_deepseek2d_cases import _global_grads
from _torch_dist_cases import load_tree

ARCH = "deepseek-v3-671b"
T, B = 64, 2
# (data, seq, head) meshes of the reference's training cases, balanced
MESHES = ((1, 1, 1), (1, 4, 1), (1, 2, 2))
# the port's world: each multi-rank mesh under balanced and zigzag (an MTP
# model runs zigzag as balanced, on contiguous tokens)
WORLD = tuple((m, s) for m in MESHES[1:] for s in ("balanced", "zigzag"))
# planted faults of the t + 2 shift, each run on the meshes named (one
# rank's own roll is the global roll: ``local`` needs ranks to show)
FAULTS = {"local": MESHES[1:], "seq_only": MESHES[2:], "t_plus_1": MESHES}
T_PROMPT, N_GEN = 32, 4
ENGINE = dict(max_batch=2, block_size=8, n_blocks=32,
              prefill_chunk_tokens=16)


def mesh_name(m):
    return "x".join(map(str, m))


def prompts(vocab):
    return np.random.default_rng(43).integers(
        0, vocab, (B, T_PROMPT)).astype(np.int32)


# ------------------------------------------------------------ port side

def plant(model, kind):
    """Replace ``model._next_rows`` (the t + 1 rows of the MTP block's
    input and its labels) by a planted fault: ``local`` rolls each rank's
    own shard (no shift across ranks), ``seq_only`` shifts over a 2D
    mesh's ``seq`` axis alone instead of the (seq, head) pair's sequence
    order, ``t_plus_1`` leaves the labels unshifted (the block predicts
    t + 1)."""
    import torch
    from repro_torch.parallel.comm import shift as comm_shift
    right = model._next_rows
    g = model.seq_group

    def last_off(out):
        if g is None or g.rank == g.size - 1:
            out[:, -1] = -100
        return out

    def local(x, labels=False):
        out = torch.cat([x[:, 1:], x[:, :1]], dim=1)
        return last_off(out) if labels else out

    def seq_only(x, labels=False):
        s = model.mesh.comms[model.par.seq_axis]
        nxt = (s.shift([x[:, :1]], -1).wait()[0] if labels
               else comm_shift(s, x[:, :1], -1))
        out = torch.cat([x[:, 1:], nxt], dim=1)
        return last_off(out) if labels else out

    def t_plus_1(x, labels=False):
        return x.clone() if labels else right(x)

    model._next_rows = {"local": local, "seq_only": seq_only,
                        "t_plus_1": t_plus_1}[kind]


def run_case(model, cfg, tree, shape, fault=None):
    """``model.loss``'s loss, ce, aux and mtp_ce and every gradient leaf
    (summed by ``train.step.sum_grads``, the expert shards gathered to
    global values), under a planted ``fault`` or none."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.transformer import (load_reference_params,
                                                trainable)
    from repro_torch.train.step import sum_grads

    if fault is not None:
        plant(model, fault)
    try:
        params = trainable(load_reference_params(
            cfg, tree, "cpu", experts=model.expert_group))
        batch = SyntheticTokens(cfg, shape, device="cpu", mesh=model.mesh,
                                par=model.par).batch(0)
        loss, met = model.loss(params, batch)
        grads, sharded = sum_grads(model, params, list(torch.autograd.grad(
            loss, leaves(params))))
    finally:
        model.__dict__.pop("_next_rows", None)
    out = {k: float(v.detach()) for k, v in met.items()}
    out["loss"] = float(loss.detach())
    out["grads"] = _global_grads(model, grads, sharded)
    return out


def make_mesh(m, device="cpu"):
    from repro_torch.launch.mesh import make_local_mesh, make_seq2d_mesh
    d, r, u = m
    if u == 1:
        return make_local_mesh(seq=r, data=d, device=device)
    return make_seq2d_mesh(r, u, data=d, device=device)


def world(rank, params_path):
    """One rank of the 4-rank world: every ``WORLD`` case, and every planted
    fault on its multi-rank meshes (balanced), keyed by mesh and schedule
    or by fault and mesh."""
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.parallel.sharding import make_parallel_config

    cfg = smoke_config(get_config(ARCH))
    tree = load_tree(params_path)
    shape = ShapeSpec("tt", T, B, "train")
    meshes = {m: make_mesh(m) for m in MESHES[1:]}
    out = {"rank": rank}

    def model_on(m, sched):
        par = make_parallel_config(meshes[m], shape, schedule=sched)
        return DecoderLM(cfg, "cpu", par=par, mesh=meshes[m])

    for m, sched in WORLD:
        model = model_on(m, sched)
        res = run_case(model, cfg, tree, shape)
        res["contiguous"] = model.positions(T // 4).tolist()
        out[f"{mesh_name(m)}/{sched}"] = res
    for kind, ms in FAULTS.items():
        for m in (m for m in ms if m in meshes):
            out[f"{kind}/{mesh_name(m)}"] = run_case(
                model_on(m, "balanced"), cfg, tree, shape, kind)
    return out
