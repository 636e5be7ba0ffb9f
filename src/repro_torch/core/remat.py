"""Rematerialization-aware gradient checkpointing (paper §3.3; port of the
reference ``core/remat.py``).

Checkpointing at the layer boundary (the ``hf`` policy) reruns the whole
layer forward in the backward pass, attention included, although the
FlashAttention backward only needs ``(q, k, v, o, lse)``.  The paper moves
the checkpoint to the attention output: save ``(o, lse)``, recompute only
the cheap pre- and post-attention stages, and feed the attention backward
directly, so the attention forward runs once per step.

:func:`remat_aware` builds ``layer(params, x) -> y`` from the three stages

    y = post(params, x, o)   where   (o, lse) = attn_fwd(pre(params, x))

as a ``torch.autograd.Function``: the forward runs all three and saves
``(params, x, o, lse)``; the backward recomputes ``pre`` and ``post`` under
``torch.enable_grad()``, takes their vector-Jacobian products with
``torch.autograd.grad``, and calls ``attn_bwd(qkv, o, lse, do)`` — never the
attention forward.  Memory per layer: the layer input ``x`` plus
``(o, lse)``.

Policies (``ParallelConfig.remat``): ``remat_aware`` (the combinator),
``hf`` (``torch.utils.checkpoint`` around the plain layer, which recomputes
the attention forward) and ``none`` (store everything).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import flatten


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


class _RematAware(torch.autograd.Function):
    """apply(stages, rebuild, n_params, h, *params, *aux): ``h`` is the
    hidden state (the only differentiable part of ``x``), ``aux`` the rest
    of ``x`` (rope tables, segment ids), ``params`` the layer's parameters
    as flat tensors."""

    @staticmethod
    def forward(ctx, stages, rebuild, n_params, h, *flat):
        pre, attn_fwd, _, post = stages
        leaves, aux = flat[:n_params], flat[n_params:]
        params, x = rebuild(leaves), (h, *aux)
        o, lse = attn_fwd(pre(params, x))
        y = post(params, x, o)
        ctx.stages, ctx.rebuild, ctx.n_params = stages, rebuild, n_params
        ctx.aux = aux                     # not differentiable
        ctx.save_for_backward(h, o, lse, *leaves)
        return y

    @staticmethod
    def backward(ctx, dy):
        pre, _, attn_bwd, post = ctx.stages
        h, o, lse, *leaves = ctx.saved_tensors
        with torch.enable_grad():
            hd = h.detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
            params, x = ctx.rebuild(ps), (hd, *ctx.aux)
            od = o.detach().requires_grad_(True)
            y = post(params, x, od)
            want = [hd, od] + [p for p in ps if p.requires_grad]
            g_post = torch.autograd.grad(y, want, dy, allow_unused=True)
            qkv = pre(params, x)
        dh, do = g_post[0], g_post[1]
        with torch.no_grad():
            dq, dk, dv = attn_bwd(tuple(t.detach() if torch.is_tensor(t)
                                        else t for t in qkv), o, lse, do)
        want_pre = [hd] + [p for p in ps if p.requires_grad]
        g_pre = torch.autograd.grad(qkv[:3], want_pre, (dq, dk, dv),
                                    allow_unused=True)
        dh = _add(dh, g_pre[0])
        it_post, it_pre = iter(g_post[2:]), iter(g_pre[1:])
        dparams = [_add(next(it_post), next(it_pre)) if p.requires_grad
                   else None for p in ps]
        return (None, None, None, dh, *dparams) + (None,) * len(ctx.aux)


def remat_aware(pre: Callable, attn_fwd: Callable, attn_bwd: Callable,
                post: Callable) -> Callable:
    """``layer(params, x) -> y`` with the paper's checkpoint placement.

      pre:      (params, x) -> qkv, a tuple whose first three entries are
                q, k, v (later entries, e.g. segment ids, pass through)
      attn_fwd: qkv -> (o, lse)
      attn_bwd: (qkv, o, lse, do) -> (dq, dk, dv), from the saved stats
      post:     (params, x, o) -> y

    ``x = (h, *aux)``: only ``h`` gets a gradient.
    """
    stages = (pre, attn_fwd, attn_bwd, post)

    def layer(params, x):
        leaves, rebuild = flatten(params)
        h, *aux = x
        return _RematAware.apply(stages, rebuild, len(leaves), h, *leaves,
                                 *aux)

    return layer


def apply_policy(layer: Callable, policy: str) -> Callable:
    """Wrap a plain ``layer(params, x) -> y`` by checkpoint policy: ``hf``
    checkpoints it at the layer boundary (the attention forward is rerun in
    the backward); ``none`` stores everything.  ``remat_aware`` layers are
    built with :func:`remat_aware` instead."""
    if policy == "none":
        return layer
    if policy == "hf":
        return lambda p, x: checkpoint(layer, p, x, use_reentrant=False)
    raise ValueError(f"unknown remat policy: {policy}")
