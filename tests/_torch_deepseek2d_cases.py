"""Cases shared by the two sides of ``tests/test_torch_deepseek2d.py``:
deepseek-v2-lite-16b's smoke config (the dense layer 0 and one MoE layer
of 4 routed + 1 shared experts, top 2; MLA q/k 48, v 32; float32) on a 2D
(data, seq, head) mesh of 4 ranks.  The reference side is one JAX process
on 4 forced host devices; the port side a 4-rank ``gloo`` world on
``launch.mesh.make_seq2d_mesh``.  Plain numpy and the port only: the
world's ranks import this module and must not import jax.
"""
import numpy as np

from _torch_dist_cases import load_tree

ARCH = "deepseek-v2-lite-16b"
T, B = 64, 2
# (data, seq, head) mesh, schedule and capacity factor of each training
# case: at 0.5 each seq shard's 64 rows overflow its experts, so the
# capacity must come from those rows (T/r), not a head rank's 32
TRAIN = (((1, 2, 2), "balanced", 4.0), ((1, 2, 2), "balanced", 0.5),
         ((1, 1, 4), "ring", 4.0))
SERVE_MESH = (1, 2, 2)
T_PROMPT, N_GEN = 32, 4


def train_name(case):
    m, sched, cf = case
    return "%s/%s/%s" % ("x".join(map(str, m)), sched, cf)


def with_capacity(cfg, cf):
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def prompts(vocab):
    return np.random.default_rng(41).integers(
        0, vocab, (B, T_PROMPT)).astype(np.int32)


# ------------------------------------------------------------ port side

def _global_grads(model, grads, sharded):
    """Summed shares (``train.step.sum_grads``) as global numpy arrays:
    the expert shards gathered over the seq axis."""
    out = []
    for g, s in zip(grads, sharded):
        if s:
            g = model.expert_group.all_gather(g.contiguous(), 0)
        out.append(g.detach().numpy().copy())
    return out


def world(rank, params_path):
    """One rank of the 4-rank world: per training case, ``model.loss``'s
    loss, ce and aux and every gradient leaf (summed by ``sum_grads`` and
    gathered to global values), the gradient norm ``adamw.global_norm``
    gives, and the same gradients with the expert shards summed over
    ``head`` not at all and twice; the aux loss's router gradient with its
    statistics reduced over ``head`` too; ``FixedSlotEngine``'s tokens
    and last logits on the serving mesh; the latent ring's refusals."""
    import torch
    from repro_torch.core import dist_attention as da
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_seq2d_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import FixedSlotEngine
    from repro_torch.train.step import norm_groups, sum_grads

    meshes = {m: make_seq2d_mesh(*m[1:], data=m[0], device="cpu")
              for m in sorted({c[0] for c in TRAIN} | {SERVE_MESH})}
    base = smoke_config(get_config(ARCH))
    tree = load_tree(params_path)
    shape = ShapeSpec("tt", T, B, "train")
    out = {"rank": rank}
    for case in TRAIN:
        m, sched, cf = case
        mesh = meshes[m]
        cfg = with_capacity(base, cf)
        par = make_parallel_config(mesh, shape, schedule=sched)
        model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
        params = trainable(load_reference_params(
            cfg, tree, "cpu", experts=model.expert_group))
        batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                par=par).batch(0)
        loss, met = model.loss(params, batch)
        raw = torch.autograd.grad(loss, leaves(params))
        grads, sharded = sum_grads(model, params, [g.clone() for g in raw])
        res = dict(loss=float(loss.detach()), ce=float(met["ce"].detach()),
                   aux=float(met["aux"].detach()),
                   grads=_global_grads(model, grads, sharded),
                   gnorm=float(adamw.global_norm(
                       grads, norm_groups(model, params))),
                   groups=(model.expert_group and model.expert_group.size,
                           model.moe_rows.size,
                           model.expert_grad_group
                           and model.expert_grad_group.size,
                           model.moe_token_group.size))
        if model.expert_grad_group is not None:
            # the expert shards summed over head not at all, and twice
            wrong = {}
            for name, times in (("none", 0), ("twice", 2)):
                gs = [g.clone() for g in raw]
                model.token_group.all_reduce_(
                    [g for g, s in zip(gs, sharded) if not s])
                for _ in range(times):
                    model.expert_grad_group.all_reduce_(
                        [g for g, s in zip(gs, sharded) if s])
                wrong[name] = _global_grads(model, gs, sharded)
            res["wrong_sums"] = wrong
            # the aux statistics reduced over head as well
            right = model.moe_token_group
            model.moe_token_group = model.token_group
            try:
                l2, _ = model.loss(params, batch)
                g2, _ = sum_grads(model, params, list(torch.autograd.grad(
                    l2, leaves(params))))
            finally:
                model.moe_token_group = right
            res["aux_over_head"] = dict(
                loss=float(l2.detach()),
                grads=_global_grads(model, g2, sharded))
        out[train_name(case)] = res
    mesh = meshes[SERVE_MESH]
    par = make_parallel_config(mesh, ShapeSpec("srv", T_PROMPT, B,
                                               "decode"))
    model = DecoderLM(base, "cpu", par=par, mesh=mesh)
    params = load_reference_params(base, tree, "cpu",
                                   experts=model.expert_group)
    toks, logits = FixedSlotEngine(model, params).generate(
        {"tokens": prompts(base.vocab)}, N_GEN)
    out["serve"] = dict(tokens=toks.numpy(), logits=logits[:, -1].numpy(),
                        shards=model.decode_group.size)
    errs = {}
    zz = make_parallel_config(mesh, ShapeSpec("srv", T_PROMPT, B, "decode"),
                              schedule="zigzag")
    try:
        DecoderLM(base, "cpu", par=zz, mesh=mesh, latent_ring=True)
        errs["model"] = "no error"
    except ValueError as e:
        errs["model"] = f"ValueError: {e}"
    q = torch.zeros(B, 8, 4, 48)
    spec = da.DistAttnSpec(axis="seq", axis_size=4, schedule="zigzag",
                           mesh2d=da.Mesh2DSpec(r=2, u=2))
    try:
        da.dist_attn_fwd_latent(q, q, q[..., :32], q[..., 0, :], None, None,
                                spec=spec, group=(mesh.comms["seq"],
                                                  mesh.comms["head"]))
        errs["ring"] = "no error"
    except ValueError as e:
        errs["ring"] = f"ValueError: {e}"
    out["latent_ring"] = errs
    return out
