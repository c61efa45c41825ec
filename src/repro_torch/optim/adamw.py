"""AdamW with global-norm clipping.

The PyTorch counterpart of ``repro/optim/adamw.py:22-96``, as plain
tensor code (not ``torch.optim.AdamW``), so that one step is the
reference's to the formula: global-norm clipping with
``scale = min(1, clip / max(gnorm, 1e-9))``, bias correction at
``step + 1``, ``delta = mhat / (sqrt(vhat) + eps)``, decoupled decay
added to ``delta`` only for leaves with ``ndim >= 2``, float32 moments.
Parameters, gradients and moments are ``{name: tensor}`` dicts
(``PeronaModel``'s ``state_dict`` names); the update is functional and
returns new tensors, as the reference's does. ``lr`` and
``weight_decay`` may be python floats or 0-d tensors (the trainer's
scalar hyperparameters). The reference's learning-rate schedules
(callable ``lr``) and its ZeRO-1 sharding specs have no user in the
port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.common.tree import tree_global_norm

Tensors = Dict[str, torch.Tensor]
Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass
class OptState:
    m: Tensors
    v: Tensors
    step: torch.Tensor  # 0-d int32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Scalar = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: Scalar = 0.1
    clip_norm: float = 1.0

    def init(self, params: Tensors) -> OptState:
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}
        device = next(iter(params.values())).device
        return OptState(m=zeros(), v=zeros(),
                        step=torch.zeros((), dtype=torch.int32,
                                         device=device))

    def update(self, grads: Tensors, state: OptState, params: Tensors
               ) -> Tuple[Tensors, OptState, Dict[str, torch.Tensor]]:
        """Returns (new_params, new_state, metrics)."""
        gnorm = tree_global_norm(grads)
        one = torch.ones((), dtype=torch.float32, device=gnorm.device)
        scale = torch.minimum(
            one, self.clip_norm / torch.maximum(gnorm, 1e-9 * one))
        step = state.step + 1
        lr = self.lr
        b1c = 1.0 - self.b1 ** step.to(torch.float32)
        b2c = 1.0 - self.b2 ** step.to(torch.float32)
        # a python zero skips the decay; a tensor always applies
        wd = self.weight_decay
        apply_wd = not (isinstance(wd, (int, float)) and wd == 0)

        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32) * scale
            m2 = self.b1 * state.m[k] + (1 - self.b1) * g
            v2 = self.b2 * state.v[k] + (1 - self.b2) * g * g
            mhat = m2 / b1c
            vhat = v2 / b2c
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if apply_wd and p.dim() >= 2:  # no decay on norms/bias
                delta = delta + wd * p.to(torch.float32)
            p2 = p.to(torch.float32) - lr * delta
            new_p[k] = p2.to(p.dtype)
            new_m[k] = m2
            new_v[k] = v2
        return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm,
                                                     "lr": lr}
