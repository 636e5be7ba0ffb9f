"""Train step factory (port of the reference ``train/step.py``).

``make_train_step(model, tc)`` returns ``step(params, opt, batch) ->
metrics``: the loss and its gradients by autograd, then the AdamW update,
which writes ``params`` and ``opt`` in place.

On a process-group mesh each rank holds its shard of the batch and a
replica of the parameters, except an MoE model's routed experts, whose
rows shard over the sequence axis (``DecoderLM.expert_group``; on a 2D
mesh over ``seq`` alone).  After autograd, the replicated leaves'
gradients are summed over the ranks holding distinct tokens
(``models.transformer.token_group``: on a 2D mesh the (seq, head) pair,
times ``data`` where the batch shards over it) and the expert shards'
over the ranks holding the same experts and distinct rows' shares
(``DecoderLM.expert_grad_group``: a 2D mesh's ``head`` axis, and the data
axis when the batch shards over it), so every rank holds the gradient of
the global loss for its leaves; the global gradient norm counts each
expert once (its squares summed over ``expert_group``, whose ranks hold
distinct experts), and the non-finite decision is a max over the world,
so the norm, the clip, the decision and the replicated leaves' update are
the same on every rank.

Under FSDP (a model built with ``fsdp=True``, ``parallel/fsdp.py``) the
parameters and moments are this rank's shards, and a shard's gradient
arrives from autograd already summed over the FSDP axes (``pod``,
``data``) by the gather's reduce-scatter; the step sums it over the rest
of the ranks holding distinct tokens (``DecoderLM.shard_grad_group``:
the sequence ranks, which hold the same shard; an expert shard's over
``shard_expert_grad_group``, a 2D mesh's ``head``), and the norm sums its
squares over the FSDP group (an expert shard's over the experts' axis
and the FSDP axes), so each element counts once
(:func:`leaf_groups`).

The step carries the reference's non-finite guard: when the loss or any
gradient is NaN/Inf (a poisoned batch, an overflow, a kernel bug) the
update is skipped — params and optimizer state stay bit-identical — and
``skipped_nonfinite`` is 1 in the metrics.  Deciding that costs one
device-to-host read per step.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.core.tree import flatten, leaves
from repro_torch.models.transformer import expert_mask
from repro_torch.optim import adamw


def leaf_groups(model, params):
    """Per leaf of ``params`` (``core.tree.flatten``'s order): ``(sum,
    norm)``, the Comm its gradient is summed over after autograd and the
    Comm its squares are summed over in the global norm (None: none),
    by its kind — a routed-expert shard or not, an FSDP shard or not
    (module docstring)."""
    n = len(leaves(params))
    experts = (expert_mask(params) if getattr(model, "expert_group", None)
               is not None else [False] * n)
    fsdp = getattr(model, "fsdp", None)
    shards = ([s is not None for s in leaves(fsdp.layout)]
              if fsdp is not None else [False] * n)
    g = {(False, False): (getattr(model, "token_group", None), None),
         (True, False): (getattr(model, "expert_grad_group", None),
                         getattr(model, "expert_group", None))}
    if fsdp is not None:
        g[(False, True)] = (model.shard_grad_group, fsdp.group)
        g[(True, True)] = (model.shard_expert_grad_group,
                           model.expert_fsdp_group)
    return [g[(e, f)] for e, f in zip(experts, shards)]


def norm_groups(model, params):
    """Per leaf of ``params``: the Comm its squares are summed over in
    ``optim.adamw.global_norm`` (:func:`leaf_groups`' second)."""
    return [ng for _, ng in leaf_groups(model, params)]


def sum_over(grads, groups):
    """Each gradient summed over its Comm of ``groups`` (None: none), in
    place: one all-reduce a group, in the order of its first leaf."""
    grads = list(grads)
    done = []
    for group in groups:
        if group is None or group.size == 1 or any(
                group is d for d in done):
            continue
        done.append(group)
        group.all_reduce_([g for g, sg in zip(grads, groups)
                           if sg is group])
    return grads


def sum_grads(model, params, grads):
    """This rank's share of the gradients (``core.tree.flatten``'s order of
    ``params``) summed over the ranks that hold the rest of it, in place:
    replicated leaves over ``model.token_group``, routed-expert shards over
    ``model.expert_grad_group``, FSDP shards over the groups of
    :func:`leaf_groups`.  Returns (grads, a bool per leaf: is it an expert
    shard?)."""
    sharded = (expert_mask(params) if getattr(model, "expert_group", None)
               is not None else [False] * len(leaves(params)))
    return sum_over(grads, [sg for sg, _ in leaf_groups(model, params)]), \
        sharded


def make_train_step(model, tc: TrainConfig):
    """``step(params, opt, batch) -> {"loss", "ce", "aux", "lr", "gnorm",
    "skipped_nonfinite"}`` (Python numbers): ``loss = ce + aux``, ``aux``
    an MoE model's load-balance loss (0 for a dense one), and with an MTP
    block ``+ 0.3 · mtp_ce`` (its ``"mtp_ce"`` added); ``params`` are
    leaf tensors with ``requires_grad``
    (``models.transformer.trainable``)."""
    def step(params, opt: adamw.AdamWState, batch) -> dict:
        ps, rebuild = flatten(params)
        loss, metrics = model.loss(params, batch)
        groups = leaf_groups(model, params)
        grads = sum_over(torch.autograd.grad(loss, ps),
                         [sg for sg, _ in groups])
        finite = torch.isfinite(loss.detach())
        for g in grads:
            finite &= torch.isfinite(g).all()
        mesh = getattr(model, "mesh", None)
        if mesh is not None and mesh.world.size > 1:
            bad = (~finite).to(torch.float32).reshape(1)
            mesh.world.all_reduce_([bad], op="max")
            finite = bad[0] == 0
        if bool(finite):
            om = adamw.update(rebuild(grads), opt, params, tc,
                              groups=[ng for _, ng in groups])
        else:
            om = {"lr": 0.0, "gnorm": 0.0}
        out = {"loss": loss, **metrics, **om}
        out = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
               for k, v in out.items()}
        out["skipped_nonfinite"] = int(not bool(finite))
        return out
    return step
