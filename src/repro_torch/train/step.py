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

The step carries the reference's non-finite guard: when the loss or any
gradient is NaN/Inf (a poisoned batch, an overflow, a kernel bug) the
update is skipped — params and optimizer state stay bit-identical — and
``skipped_nonfinite`` is 1 in the metrics.  Deciding that costs one
device-to-host read per step.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.core.tree import flatten
from repro_torch.models.transformer import expert_mask
from repro_torch.optim import adamw


def sum_grads(model, params, grads):
    """This rank's share of the gradients (``core.tree.flatten``'s order of
    ``params``) summed over the ranks that hold the rest of it, in place:
    replicated leaves over ``model.token_group``, routed-expert shards over
    ``model.expert_grad_group``.  Returns (grads, a bool per leaf: is it an
    expert shard?)."""
    grads = list(grads)
    sharded = (expert_mask(params) if getattr(model, "expert_group", None)
               is not None else [False] * len(grads))
    for group, mine in ((getattr(model, "token_group", None), False),
                        (getattr(model, "expert_grad_group", None), True)):
        if group is not None and group.size > 1:
            group.all_reduce_([g for g, s in zip(grads, sharded)
                               if s == mine])
    return grads, sharded


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
        grads, sharded = sum_grads(model, params,
                                   torch.autograd.grad(loss, ps))
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
                              sharded=sharded, group=model.expert_group
                              if any(sharded) else None)
        else:
            om = {"lr": 0.0, "gnorm": 0.0}
        out = {"loss": loss, **metrics, **om}
        out = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
               for k, v in out.items()}
        out["skipped_nonfinite"] = int(not bool(finite))
        return out
    return step
