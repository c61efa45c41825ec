"""Step factories: the train, prefill and decode steps of a model.

``repro/launch/steps.py:38-74`` in PyTorch. A train step is value and
gradient of ``model.loss`` plus the optimizer's update, functional as
the reference's: it takes and returns the parameter tree and the
optimizer state. With ``compute_dtype="bfloat16"`` (master-weight mixed
precision) the loss sees bf16 copies of the float32 masters
(``tree_cast`` inside the differentiated function), so activations and
gradients run in bf16, and the optimizer updates the float32 masters.
The reference's ``configure_axes`` and ``lowerable`` (mesh axes and
shardings for its dry-run) belong to the launch tooling, which the port
does not have yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import flatten, tree_cast, unflatten_as
from repro_torch.models.model_zoo import Model
from repro_torch.optim.adamw import AdamW


def value_and_grad(loss_fn, params, *args):
    """((loss, aux), grads) of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to every leaf of ``params`` (floating tensors), as
    ``jax.value_and_grad(..., has_aux=True)``; the grads mirror
    ``params``. A leaf the loss does not read (Qwen2-VL's untied
    ``embed/table`` when it trains from embeddings) gets zeros in its
    own type and on its device, as JAX gives it, so the optimizer's
    weight decay still moves it."""
    leaves = {k: t.detach().requires_grad_()
              for k, t in flatten(params).items()}
    loss, aux = loss_fn(unflatten_as(params, leaves), *args)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
            unflatten_as(params, dict(zip(leaves, grads))))


def make_train_step(model: Model, optimizer: AdamW,
                    compute_dtype: Optional[str] = "bfloat16"):
    """compute_dtype="bfloat16": master-weight mixed precision, the loss
    sees bf16 parameters and the optimizer updates the float32 masters;
    None: the loss sees the parameters as they are."""

    def train_step(params, opt_state, batch):
        def loss_fn(p):
            pc = (tree_cast(p, torch.bfloat16)
                  if compute_dtype == "bfloat16" else p)
            return model.loss(pc, batch)

        (loss, metrics), grads = value_and_grad(loss_fn, params)
        new_params, new_state, om = optimizer.update(grads, opt_state,
                                                     params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, cache, batch):
        return model.prefill(params, cache, **batch)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, pos, cache):
        return model.decode_step(params, tokens, pos, cache)

    return decode_step
