"""Cases shared by the two sides of ``tests/test_torch_vlm.py``: smoke
internvl2-2b (16 image positions before the text; 2 layers, 4 heads / 2
kv heads of 32, float32) trained at one rank and at 4 under balanced and
zigzag, and served by ``FixedSlotEngine``.  The reference side is one JAX
process on 4 forced host devices with Auto-axis ``(data, model)`` meshes;
the port side a 4-rank ``gloo`` world.  Plain numpy and the port only: the
world's ranks import this module and must not import jax.
"""
import numpy as np

from _torch_dist_cases import load_tree

ARCH = "internvl2-2b"
WORLD = 4
# 64 positions a sequence: 16 image rows then 48 text tokens; at 4 ranks
# balanced rank 0 holds the image, zigzag (8-row chunks) ranks 0 and 1
# hold half of it each
T, B = 64, 2
TRAIN = ((1, "balanced"), (4, "balanced"), (4, "zigzag"))
# serving: 32-token prompts after 16 image rows (48 positions, 12 a rank
# at 4), then greedy tokens
T_PROMPT, N_GEN = 32, 6


def case_name(case):
    return "%d/%s" % case


def serve_batch(cfg):
    """The serving batch: prompts and their image rows (float32)."""
    rng = np.random.default_rng(47)
    return {"tokens": rng.integers(0, cfg.vocab, (B, T_PROMPT)).astype(
                np.int32),
            "image_embeds": rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}


def unmasked(model):
    """A planted fault: the image positions labelled with token 0 instead
    of −100 (the loss then counts them)."""
    right = model._labels

    def labels(batch):
        got = right(batch).clone()
        got[:, :batch["image_embeds"].shape[1]] = 0
        return got
    model._labels = labels
    return model


# ------------------------------------------------------------ port side

def _np(t):
    return t.detach().float().numpy().copy()


def train_one(model, params, batch):
    """``model.loss`` and every gradient leaf summed over the ranks."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.train.step import sum_grads
    loss, _ = model.loss(params, batch)
    grads, _ = sum_grads(model, params, list(torch.autograd.grad(
        loss, leaves(params))))
    return dict(loss=float(loss.detach()), grads=[_np(g) for g in grads])


def world(rank, params_path):
    """One rank of the 4-rank world: per 4-rank training case the loss and
    summed gradients, the batch's shard (its image rows and text
    columns), and the loss with the image labels unmasked; the
    ``FixedSlotEngine`` tokens and last logits."""
    import torch
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.serve.engine import FixedSlotEngine

    cfg = smoke_config(get_config(ARCH))
    mesh = make_local_mesh(seq=WORLD, device="cpu")
    tree = load_tree(params_path)
    shape = ShapeSpec("tt", T, B, "train")
    out = {}
    for case in TRAIN:
        if case[0] != WORLD:
            continue
        par = make_parallel_config(mesh, shape, schedule=case[1])
        model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
        params = trainable(load_reference_params(cfg, tree, "cpu"))
        batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                par=par).batch(0)
        res = train_one(model, params, batch)
        res["cols"] = model.positions(batch["tokens"].shape[1] + batch[
            "image_embeds"].shape[1]).numpy()
        res["batch"] = {k: _np(v) for k, v in batch.items()}
        res["unmasked"] = float(unmasked(model).loss(params, batch)[0]
                                .detach())
        out[case_name(case)] = res
    par = make_parallel_config(mesh, ShapeSpec("srv", T_PROMPT, B, "decode"))
    model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
    params = load_reference_params(cfg, tree, "cpu")
    toks, logits = FixedSlotEngine(model, params).generate(
        serve_batch(cfg), N_GEN)
    out["serve"] = dict(tokens=toks.numpy(), logits=_np(logits[:, -1]))
    return out
