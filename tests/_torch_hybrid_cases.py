"""Cases shared by the two sides of ``tests/test_torch_ssm.py`` and
``tests/test_torch_hybrid.py``: the Mamba2 mixer's state relay and the
smoke mamba2-2.7b / zamba2-2.7b decoders over a sequence axis of 4 ranks.
The reference side is one JAX process on 4 forced host devices with
Auto-axis meshes; the port side a 4-rank ``gloo`` world on
``launch.mesh.make_local_mesh``.  Plain numpy and the port only: the
world's ranks import this module and must not import jax.
"""
import numpy as np

from _torch_dist_cases import load_tree

WORLD = 4
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
# the decoders' training batch: each of the 4 ranks holds 32 tokens, two
# chunks of the smoke SSM's 16
T, B = 128, 2
# (ranks, schedule) of each decoder case; zigzag falls back to balanced
CASES = ((1, "balanced"), (4, "balanced"), (4, "zigzag"))
# the recurrent decode: a prompt (two chunks of 16, for the prefill) fed
# token by token, then greedy tokens
T_PROMPT, N_GEN = 32, 8

# the mixer case: smoke mamba2's mixer (d_model 64, 16 heads of 8,
# d_state 16, chunk 16) on (B, T) tokens, 32 a rank; its A is small
# (−0.01 .. −0.1) and its dt below one, so the state a rank carries in
# still weighs at the end of the next rank's shard
MIX_ARCH = "mamba2-2.7b"
MIX_T, MIX_B = 128, 2
# the relay's planted faults: every rank starts from a zero state; the
# conv halo from the previous rank zeroed
FAULTS = ("zero_state", "zero_halo")


def case_name(case):
    return "%d/%s" % case


def mixer_inputs(cfg):
    """(params, x, cotangent) of the mixer case as float32 numpy arrays, in
    the reference's parameter names."""
    s, d = cfg.ssm, cfg.d_model
    di, nh, N = s.d_inner(d), s.n_heads(d), s.d_state
    rng = np.random.default_rng(7)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    p = {"ln": 1.0 + n(d, scale=0.1),
         "in_proj": n(d, 2 * di + 2 * N + nh, scale=d ** -0.5),
         "conv_w": n(di + 2 * N, s.d_conv, scale=0.2),
         "conv_b": n(di + 2 * N, scale=0.1),
         "A_log": np.log(rng.uniform(0.01, 0.1, nh)).astype(np.float32),
         "D": 1.0 + n(nh, scale=0.1),
         "dt_bias": n(nh, scale=0.1) - 1.0,
         "gln": 1.0 + n(di, scale=0.1),
         "out_proj": n(di, d, scale=di ** -0.5)}
    return p, n(MIX_B, MIX_T, d, scale=0.5), n(MIX_B, MIX_T, d)


def prompts(vocab):
    return np.random.default_rng(43).integers(
        0, vocab, (B, T_PROMPT)).astype(np.int32)


# ------------------------------------------------------------ port side

def _np(t):
    return t.detach().numpy().copy()


def mixer_world(rank):
    """One rank of the mixer case: its shard of ``ssm_apply``'s output,
    the gradients of Σ y ⊙ cotangent (its share of the parameters'; its
    shard of x's), and the output under each planted relay fault."""
    import torch
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import ssm

    cfg = smoke_config(get_config(MIX_ARCH))
    mesh = make_local_mesh(seq=WORLD, device="cpu")
    grp = mesh.comms["model"]
    p, x, cot = mixer_inputs(cfg)
    Tl = MIX_T // WORLD
    cols = slice(rank * Tl, (rank + 1) * Tl)
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xs = torch.from_numpy(np.ascontiguousarray(x[:, cols])).requires_grad_()
    y = ssm.ssm_apply(params, xs, cfg, grp)
    g = torch.autograd.grad((y * torch.from_numpy(
        np.ascontiguousarray(cot[:, cols]))).sum(), [xs, *params.values()])
    out = {"y": _np(y), "dx": _np(g[0]),
           "dp": {k: _np(v) for k, v in zip(params, g[1:])}}

    def zero_state(group, decay, state):
        return torch.zeros_like(state)

    def zero_halo(group, xbc, k):
        return torch.zeros_like(xbc[:, -(k - 1):])
    for name, where, fn in (("zero_state", "_device_prefix", zero_state),
                            ("zero_halo", "_halo", zero_halo)):
        right = getattr(ssm, where)
        setattr(ssm, where, fn)
        try:
            with torch.no_grad():
                out[name] = _np(ssm.ssm_apply(params, xs, cfg, grp))
        finally:
            setattr(ssm, where, right)
    return out


def model_world(rank, params_dir):
    """One rank of the decoder cases at 4 ranks: per arch and schedule,
    ``model.loss`` and every gradient leaf summed over the ranks
    (``train.step.sum_grads``), on the reference's weights; and whether
    ``DecoderLM`` builds on a 2D (seq, head) mesh ("accepted", else the
    error it raises)."""
    import torch
    from repro_torch.core.config import ShapeSpec, get_config, smoke_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_local_mesh, make_seq2d_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.parallel.sharding import make_parallel_config
    from repro_torch.train.step import sum_grads

    mesh = make_local_mesh(seq=WORLD, device="cpu")
    mesh2d = make_seq2d_mesh(2, 2, device="cpu")
    shape = ShapeSpec("tt", T, B, "train")
    out = {"refused_2d": {}}
    for arch in ARCHS:
        cfg = smoke_config(get_config(arch))
        tree = load_tree(f"{params_dir}/{arch}.npz")
        try:
            DecoderLM(cfg, "cpu", par=make_parallel_config(mesh2d, shape),
                      mesh=mesh2d)
            out["refused_2d"][arch] = "accepted"
        except ValueError as e:
            out["refused_2d"][arch] = str(e)
        for case in CASES:
            if case[0] != WORLD:
                continue
            par = make_parallel_config(mesh, shape, schedule=case[1])
            model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
            params = trainable(load_reference_params(cfg, tree, "cpu"))
            batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                    par=par).batch(0)
            loss, _ = model.loss(params, batch)
            raw = torch.autograd.grad(loss, leaves(params))
            grads, _ = sum_grads(model, params, list(raw))
            out[f"{arch}/{case_name(case)}"] = dict(
                loss=float(loss.detach()), grads=[_np(g) for g in grads],
                cols=batch["tokens"].shape[1])
    return out
