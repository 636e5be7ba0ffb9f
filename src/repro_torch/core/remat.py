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
``(o, lse)``.  ``post`` may return a tuple of tensors — an MoE-family
layer's ``(h, aux)``, its load-balance loss — and the layer then returns
that tuple; the backward takes the cotangent of each output and the
vector-Jacobian product of all of them at once (the recomputed ``post``
routes the MoE again, on the same inputs).  ``x = (h, *aux)``: ``h`` gets
a gradient, and so does any tensor of ``aux`` that requires one (an
encoder–decoder's cross-attention layer takes the encoder output there);
the rest of ``aux`` (rope tables, segment ids) is passed through.

Policies (``ParallelConfig.remat``): ``remat_aware`` (the combinator),
``hf`` (``torch.utils.checkpoint`` around the plain layer, which recomputes
the attention forward) and ``none`` (store everything).

FSDP (``parallel/fsdp.py``): a layer built by either takes ``layer(params,
x, gather)``, ``params`` this rank's shards and ``gather`` their
:class:`~repro_torch.parallel.fsdp.Gather`.  The gather runs inside the
checkpointed region, in the forward and again in the backward's
recompute, so the layer's whole weights are dropped after each use and
autograd sees only the shards: under ``remat_aware`` the combinator
gathers (``gather.full``) and reduce-scatters the whole weights'
gradients onto the shards (``gather.reduce``); under ``hf`` the
checkpointed function gathers differentiably (``gather.tree``); under
``none`` so does the layer, and autograd keeps the whole weights its
products saved until the backward.
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
    """apply(stages, rebuild, gather, n_params, h, *params, *aux): ``h`` is
    the hidden state, ``aux`` the rest of ``x`` (rope tables, segment ids;
    an encoder output, which takes a gradient when it requires one),
    ``params`` the layer's parameters as flat tensors — its FSDP shards
    when ``gather`` (a ``parallel.fsdp.Gather``) is given, whole
    otherwise.  Returns ``post``'s output: a tensor, or a tuple."""

    @staticmethod
    def forward(ctx, stages, rebuild, gather, n_params, h, *flat):
        pre, attn_fwd, _, post = stages
        leaves, aux = flat[:n_params], flat[n_params:]
        whole = leaves if gather is None else gather.full(leaves)
        params, x = rebuild(whole), (h, *aux)
        o, lse = attn_fwd(pre(params, x))
        y = post(params, x, o)
        del params, whole                 # the shards are what is kept
        ctx.stages, ctx.rebuild, ctx.n_params = stages, rebuild, n_params
        ctx.gather = gather
        ctx.aux = aux                     # not differentiable
        ctx.save_for_backward(h, o, lse, *leaves)
        return y

    @staticmethod
    def backward(ctx, *dys):
        pre, _, attn_bwd, post = ctx.stages
        h, o, lse, *leaves = ctx.saved_tensors
        gather = ctx.gather
        first = 5 + ctx.n_params                 # aux's first input index
        diff = [i for i in range(len(ctx.aux))
                if ctx.needs_input_grad[first + i]]
        whole = leaves if gather is None else gather.full(leaves)
        with torch.enable_grad():
            hd = h.detach().requires_grad_(True)
            ps = [w.detach().requires_grad_(p.requires_grad)
                  for w, p in zip(whole, leaves)]
            del whole
            aux = list(ctx.aux)
            for i in diff:
                aux[i] = aux[i].detach().requires_grad_(True)
            params, x = ctx.rebuild(ps), (hd, *aux)
            od = o.detach().requires_grad_(True)
            y = post(params, x, od)
            ys = y if isinstance(y, tuple) else (y,)
            # an output that depends on no input (a dense layer's aux of 0)
            # has no vector-Jacobian product to take
            outs = [(t, d) for t, d in zip(ys, dys) if t.requires_grad]
            extra = [aux[i] for i in diff] + [p for p in ps
                                              if p.requires_grad]
            g_post = torch.autograd.grad([t for t, _ in outs],
                                         [hd, od] + extra,
                                         [d for _, d in outs],
                                         allow_unused=True)
            qkv = pre(params, x)
        dh, do = g_post[0], g_post[1]
        with torch.no_grad():
            dq, dk, dv = attn_bwd(tuple(t.detach() if torch.is_tensor(t)
                                        else t for t in qkv), o, lse, do)
        g_pre = torch.autograd.grad(qkv[:3], [hd] + extra, (dq, dk, dv),
                                    allow_unused=True)
        dh = _add(dh, g_pre[0])
        it_post, it_pre = iter(g_post[2:]), iter(g_pre[1:])
        daux = [None] * len(ctx.aux)
        for i in diff:
            daux[i] = _add(next(it_post), next(it_pre))
        dparams = [_add(next(it_post), next(it_pre)) if p.requires_grad
                   else None for p in ps]
        del ps, params, qkv, g_post, g_pre, extra, y, ys, outs
        if gather is not None:
            dparams = gather.reduce(dparams)
        return (None, None, None, None, dh, *dparams, *daux)


def remat_aware(pre: Callable, attn_fwd: Callable, attn_bwd: Callable,
                post: Callable) -> Callable:
    """``layer(params, x) -> y`` with the paper's checkpoint placement.

      pre:      (params, x) -> qkv, a tuple whose first three entries are
                q, k, v (later entries, e.g. segment ids, pass through)
      attn_fwd: qkv -> (o, lse)
      attn_bwd: (qkv, o, lse, do) -> (dq, dk, dv), from the saved stats
      post:     (params, x, o) -> y, a tensor or a tuple of tensors

    ``x = (h, *aux)``: ``h`` gets a gradient, and so does each tensor of
    ``aux`` that requires one.  The layer is ``layer(params, x,
    gather=None)``: with ``gather``, ``params`` are FSDP shards (module
    docstring).
    """
    stages = (pre, attn_fwd, attn_bwd, post)

    def layer(params, x, gather=None):
        leaves, rebuild = flatten(params)
        h, *aux = x
        return _RematAware.apply(stages, rebuild, gather, len(leaves), h,
                                 *leaves, *aux)

    return layer


def apply_policy(layer: Callable, policy: str) -> Callable:
    """Wrap a plain ``layer(params, x) -> y`` (a tensor or a tuple) by
    checkpoint policy: ``hf``
    checkpoints it at the layer boundary (the attention forward is rerun in
    the backward); ``none`` stores everything.  ``remat_aware`` layers are
    built with :func:`remat_aware` instead.  The wrapped layer is
    ``layer(params, x, gather=None)``: with ``gather``, ``params`` are FSDP
    shards, gathered inside the checkpointed function (module
    docstring)."""
    def whole(p, x, gather):
        return layer(p if gather is None else gather.tree(p), x)

    if policy == "none":
        return lambda p, x, gather=None: whole(p, x, gather)
    if policy == "hf":
        return lambda p, x, gather=None: checkpoint(
            whole, p, x, gather, use_reentrant=False)
    raise ValueError(f"unknown remat policy: {policy}")
