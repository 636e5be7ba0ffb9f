"""Cases shared by the two sides of ``tests/test_torch_audio.py``: smoke
whisper-tiny (2 encoder and 2 decoder layers, 4 heads of 32, 64 frames,
float32) trained at one rank and at 4 and served by ``FixedSlotEngine``.
The reference side is one JAX process on 4 forced host devices with
Auto-axis ``(data, model)`` meshes; the port side a 4-rank ``gloo``
world.  Plain numpy and the port only: the world's ranks import this
module and must not import jax.
"""
import numpy as np

from _torch_dist_cases import load_tree

ARCH = "whisper-tiny"
WORLD = 4
# 64 decoder tokens a sequence (16 a rank at 4) beside 64 frames
T, B = 64, 2
# the reference's training cases; the port's 4-rank world also runs zigzag,
# held to the reference's balanced run (``audio`` is not among zigzag's
# families), and each checkpoint policy
TRAIN = ((1, "balanced"), (4, "balanced"))
POLICIES = ("remat_aware", "hf", "none")
# serving: 32-token prompts beside their frames, then greedy tokens
T_PROMPT, N_GEN = 32, 6


def case_name(case):
    return "%d/%s" % case


def serve_batch(cfg):
    """The serving batch: prompts and their frames (float32)."""
    rng = np.random.default_rng(53)
    return {"tokens": rng.integers(0, cfg.vocab, (B, T_PROMPT)).astype(
                np.int32),
            "frames": rng.standard_normal(
                (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}


def is_encoder_leaf(params):
    """Per leaf of ``params`` (``core.tree.flatten``'s order): is it the
    encoder's (``enc_layers``, ``ln_enc``)?"""
    from repro_torch.core.tree import leaves
    return leaves({k: [True] * len(leaves(v)) if k in ("enc_layers",
                                                       "ln_enc")
                   else [False] * len(leaves(v)) for k, v in params.items()})


# ------------------------------------------------------------ port side

def _np(t):
    return t.detach().float().numpy().copy()


def train_one(model, params, batch):
    """``model.loss`` and every gradient leaf summed over the ranks, and
    the same with the encoder's leaves summed over them once more."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.train.step import sum_grads
    loss, _ = model.loss(params, batch)
    grads, _ = sum_grads(model, params, list(torch.autograd.grad(
        loss, leaves(params))))
    out = dict(loss=float(loss.detach()), grads=[_np(g) for g in grads])
    if model.token_group is not None and model.token_group.size > 1:
        enc = is_encoder_leaf(params)
        twice = [g.clone() for g in grads]
        model.token_group.all_reduce_([g for g, e in zip(twice, enc) if e])
        out["twice"] = [_np(g) for g in twice]
    return out


def world(rank, params_path):
    """One rank of the 4-rank world: the loss and summed gradients under
    each policy (balanced) and under zigzag, the batch's frames and token
    columns, the encoder's gradients summed twice; ``FixedSlotEngine``'s
    tokens and last logits, and the padded cache's shapes."""
    import torch
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import (EncDecLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import FixedSlotEngine

    cfg = smoke_config(get_config(ARCH))
    mesh = make_local_mesh(seq=WORLD, device="cpu")
    tree = load_tree(params_path)
    shape = ShapeSpec("tt", T, B, "train")
    out = {}
    for sched, policy in ([("balanced", p) for p in POLICIES]
                          + [("zigzag", "remat_aware")]):
        par = make_parallel_config(mesh, shape, schedule=sched,
                                   remat=policy)
        model = EncDecLM(cfg, "cpu", par=par, mesh=mesh)
        params = trainable(load_reference_params(cfg, tree, "cpu"))
        batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                par=par).batch(0)
        res = train_one(model, params, batch)
        res["cols"] = model.positions(batch["tokens"].shape[1]).numpy()
        res["batch"] = {k: _np(v) for k, v in batch.items()}
        out[f"{sched}/{policy}"] = res
    par = make_parallel_config(mesh, ShapeSpec("srv", T_PROMPT, B, "decode"))
    model = EncDecLM(cfg, "cpu", par=par, mesh=mesh)
    params = load_reference_params(cfg, tree, "cpu")
    sb = serve_batch(cfg)
    toks, logits = FixedSlotEngine(model, params).generate(sb, N_GEN)
    _, cache = model.prefill(params, sb["tokens"], sb["frames"])
    S = -(-(T_PROMPT + N_GEN) // WORLD) * WORLD     # as the engine pads
    padded = model.pad_cache(cache, S)
    out["serve"] = dict(tokens=toks.numpy(), logits=_np(logits[:, -1]),
                        shapes={k: tuple(v.shape) for k, v in padded.items()},
                        ek_same=bool(torch.equal(padded["ek"], cache["ek"])))
    return out
