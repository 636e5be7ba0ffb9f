"""Train step factory (port of the reference ``train/step.py``).

``make_train_step(model, tc)`` returns ``step(params, opt, batch) ->
metrics``: the loss and its gradients by autograd, then the AdamW update,
which writes ``params`` and ``opt`` in place.

On a process-group mesh each rank holds its shard of the batch and a
replica of the parameters: after autograd, the gradients are summed over
the ranks holding distinct tokens (``models.transformer.token_group``), so
every rank holds the gradient of the global loss, and the global gradient
norm, the non-finite decision and the update are the same on every rank.

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
from repro_torch.optim import adamw


def make_train_step(model, tc: TrainConfig):
    """``step(params, opt, batch) -> {"loss", "ce", "aux", "lr", "gnorm",
    "skipped_nonfinite"}`` (Python numbers): ``loss = ce + aux``, ``aux``
    an MoE model's load-balance loss (0 for a dense one); ``params`` are
    leaf tensors with ``requires_grad``
    (``models.transformer.trainable``)."""
    def step(params, opt: adamw.AdamWState, batch) -> dict:
        ps, rebuild = flatten(params)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, ps)
        group = getattr(model, "token_group", None)
        if group is not None and group.size > 1:
            grads = group.all_reduce_(list(grads))
        finite = torch.isfinite(loss.detach())
        for g in grads:
            finite &= torch.isfinite(g).all()
        if bool(finite):
            om = adamw.update(rebuild(list(grads)), opt, params, tc)
        else:
            om = {"lr": 0.0, "gnorm": 0.0}
        out = {"loss": loss, **metrics, **om}
        out = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
               for k, v in out.items()}
        out["skipped_nonfinite"] = int(not bool(finite))
        return out
    return step
