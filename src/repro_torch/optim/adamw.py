"""AdamW with a warmup-cosine schedule and global-norm clipping (port of the
reference ``optim/adamw.py``).

The moments are float32 trees shaped like the parameters (under FSDP
like this rank's shards: ``init`` runs on them); the update is
computed in float32 and cast back to each parameter's dtype.  Unlike the
reference's pure functions, :func:`update` writes the parameters and the
state **in place** (the reference donates them to jit instead), so a
full-width model needs one copy of each.  Plain tensor code: the reference
has no kernel here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.core.tree import flatten, leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    step: int
    m: dict
    v: dict


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def schedule(step: int, tc: TrainConfig) -> float:
    """Linear warmup to ``tc.lr``, then cosine decay to 0 at
    ``tc.total_steps``."""
    if step < tc.warmup_steps:
        return tc.lr * (step + 1) / max(tc.warmup_steps, 1)
    prog = (step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps,
                                          1)
    return 0.5 * tc.lr * (1 + math.cos(math.pi * min(max(prog, 0.0), 1.0)))


def global_norm(grads, groups=None) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in float32 (0-d tensor).  ``groups`` (a
    Comm or None per leaf, ``core.tree.flatten``'s order; None: every
    leaf whole on this rank) names the group over which each leaf is
    sharded: its squares are summed over that group, so each element
    counts once and every rank gets the same norm (an FSDP shard over the
    FSDP group, an MoE model's routed experts over the sequence axis — on
    a 2D mesh over ``seq``, whose ranks hold distinct experts, not the
    (seq, head) pair, whose head ranks hold the same ones — and over both
    when both shard them; ``train/step.norm_groups``)."""
    gs = leaves(grads)
    groups = groups or [None] * len(gs)
    sq = [g.float().square().sum() for g in gs]
    total = sum(x for x, c in zip(sq, groups) if c is None or c.size == 1)
    done = []
    for c in groups:                   # one all-reduce a group, in the
        if c is None or c.size == 1 or any(c is d for d in done):  # order
            continue                   # of its first leaf
        done.append(c)
        part = torch.stack([x for x, d in zip(sq, groups) if d is c]).sum()
        part = part[None]
        c.all_reduce_([part])
        total = total + part[0]
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(gn, max_norm):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-6), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so their global norm is at most ``max_norm``, norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def update(grads, state: AdamWState, params, tc: TrainConfig, *,
           groups=None) -> dict:
    """One AdamW step, in place on ``params`` and ``state`` (under FSDP
    both are this rank's shards).  Returns the
    metrics ``{"lr", "gnorm"}`` (gnorm before clipping, a 0-d tensor; over
    the sharded leaves as :func:`global_norm`).  The clipped gradient is
    formed one leaf at a time, as :func:`clip_by_global_norm` would give
    it."""
    gn = global_norm(grads, groups)
    scale = _clip_scale(gn, tc.max_grad_norm)
    lr = schedule(state.step, tc)
    state.step += 1
    b1, b2 = tc.beta1, tc.beta2
    bc1, bc2 = 1 - b1 ** state.step, 1 - b2 ** state.step
    ps, _ = flatten(params)
    for p, g, m, v in zip(ps, leaves(grads), leaves(state.m),
                          leaves(state.v)):
        gf = (g * scale.to(g.dtype)).float()
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
        upd.add_(p.float(), alpha=tc.weight_decay)
        p.copy_((p.float() - lr * upd).to(p.dtype))
    return {"lr": lr, "gnorm": gn}
