"""Cases shared by the two sides of ``tests/test_torch_ssm2d.py``: smoke
mamba2-2.7b and zamba2-2.7b on 2D (data, seq, head) meshes of 4 ranks —
training on (1, 2, 2) and (1, 1, 4), the prefill and the recurrent decode
on (1, 4) and (1, 2, 2).  The reference side is one JAX process on 4
forced host devices with Auto-axis meshes; the port side a 4-rank ``gloo``
world.  Plain numpy and the port only: the world's ranks import this
module and must not import jax.
"""
import numpy as np

from _torch_dist_cases import load_tree

WORLD = 4
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
# each of the 4 ranks holds 32 tokens: two chunks of the smoke SSM's 16
T, B = 128, 2
# ((data, seq, head), schedule) of each training case on the reference;
# a seq axis of one rank runs the ring plan, as the 2D plans require
TRAIN = (((1, 2, 2), "balanced"), ((1, 1, 4), "ring"))
# the port's zigzag on (1, 2, 2), held to the reference's balanced run
# (zigzag falls back to balanced for these families)
ZIGZAG = ((1, 2, 2), "zigzag")
# the prefill and the recurrent decode: a prompt of two chunks, fed token
# by token from the empty cache, then the reference's greedy tokens; the
# hybrid's shared K/V sharded over 4 ranks on each serving mesh
T_PROMPT, N_GEN = 32, 8
SERVE_MESHES = ((1, 4), (1, 2, 2))


def train_name(case):
    m, sched = case
    return "%s/%s" % ("x".join(map(str, m)), sched)


def mesh_name(m):
    return "x".join(map(str, m))


def prompts(vocab):
    return np.random.default_rng(43).integers(
        0, vocab, (B, T_PROMPT)).astype(np.int32)


# ------------------------------------------------------------ port side

def _np(t):
    return t.detach().float().numpy().copy()


def is_ssm_leaf(params):
    """Per leaf of ``params`` (``core.tree.flatten``'s order): is it a
    Mamba2 mixer's?"""
    from repro_torch.core.tree import leaves

    def mark(tree, inside=False):
        if isinstance(tree, dict):
            return {k: mark(v, inside or k == "ssm") for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(x, inside) for x in tree]
        return inside
    return leaves(mark(params))


def _serve(model, params, cfg, stream):
    """The prefill's last logits, then the stream fed token by token from
    the empty cache: every step's logits (float32 numpy)."""
    import torch
    from repro_torch.data.pipeline import empty_decode_cache
    logits, cache = model.prefill(params, stream[:, :T_PROMPT])
    assert cache == {}
    dc = empty_decode_cache(cfg, B, T_PROMPT + N_GEN, "cpu",
                            shards=model.decode_group.size)
    rows = []
    for t in range(T_PROMPT + N_GEN):
        lg = model.decode(params, dc, stream[:, t:t + 1],
                          torch.full((B,), t, dtype=torch.int32))
        rows.append(_np(lg[:, 0]))
    shared = ({k: tuple(dc[k].shape) for k in ("shared_k", "shared_v")}
              if "shared_k" in dc else {})
    return dict(prefill=_np(logits), decode=np.stack(rows), shared=shared)


def world(rank, params_dir, streams):
    """One rank of the 4-rank world, per arch: on each training mesh
    ``model.loss`` and every gradient leaf summed by ``sum_grads``, the
    gradient norm ``adamw.global_norm`` gives, and the same gradients with
    the SSM leaves summed over ``head`` once more (each counted u times);
    the zigzag case; the prefill and the decode over ``streams[arch]`` on
    each serving mesh."""
    import torch
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_local_mesh, make_seq2d_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.train.step import sum_grads

    def mesh_of(m):
        if len(m) == 2:
            return make_local_mesh(seq=m[1], data=m[0], device="cpu")
        return make_seq2d_mesh(*m[1:], data=m[0], device="cpu")

    meshes = {m: mesh_of(m) for m in sorted(
        {c[0] for c in TRAIN} | set(SERVE_MESHES), key=len)}
    shape = ShapeSpec("tt", T, B, "train")
    out = {}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        tree = load_tree(f"{params_dir}/{arch}.npz")
        for case in TRAIN + (ZIGZAG,):
            m, sched = case
            mesh = meshes[m]
            par = make_parallel_config(mesh, shape, schedule=sched)
            model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
            params = trainable(load_reference_params(cfg, tree, "cpu"))
            batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                    par=par).batch(0)
            loss, _ = model.loss(params, batch)
            raw = torch.autograd.grad(loss, leaves(params))
            grads, _ = sum_grads(model, params,
                                 [g.clone() for g in raw])
            ssm = is_ssm_leaf(params)
            twice = [g.clone() for g in grads]
            mesh.comms["head"].all_reduce_(
                [g for g, s in zip(twice, ssm) if s])
            out[f"{arch}/{train_name(case)}"] = dict(
                loss=float(loss.detach()), grads=[_np(g) for g in grads],
                gnorm=float(adamw.global_norm(grads)),
                twice=[_np(g) for g in twice], cols=batch["tokens"].shape[1],
                group=model.seq_group.size, n_ssm=sum(ssm))
        stream = torch.from_numpy(streams[arch])
        for m in SERVE_MESHES:
            mesh = meshes[m]
            par = make_parallel_config(mesh, ShapeSpec(
                "dec", T_PROMPT + N_GEN, B, "decode"))
            model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
            params = load_reference_params(cfg, tree, "cpu")
            with torch.no_grad():
                out[f"{arch}/serve/{mesh_name(m)}"] = _serve(
                    model, params, cfg, stream)
    return out
