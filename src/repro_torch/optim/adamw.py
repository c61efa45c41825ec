"""AdamW with global-norm clipping.

The PyTorch counterpart of ``repro/optim/adamw.py:22-96``, as plain
tensor code (not ``torch.optim.AdamW``), so that one step is the
reference's to the formula: global-norm clipping with
``scale = min(1, clip / max(gnorm, 1e-9))``, summed in the reference's
leaf order, bias correction at ``step + 1``, ``delta = mhat / (sqrt(vhat)
+ eps)``, decoupled decay added to ``delta`` only for leaves with
``ndim >= 2``, moments stored in ``state_dtype`` (float32 by default).
Parameters, gradients and moments are trees of the same structure:
``{name: tensor}`` dicts (``PeronaModel``'s ``state_dict`` names) or an
LM's nested tree of dicts and lists, walked through their dot-joined
leaf names (``common.tree``). The update is functional and returns new
tensors, as the reference's does. ``lr`` and ``weight_decay`` may be
python floats or 0-d tensors (the trainer's scalar hyperparameters);
``lr`` may also be a schedule (``optim.schedule``), called on the step
tensor on its device, so a step never reads the device. The reference's
ZeRO-1 sharding specs belong to the launch tooling, which the port does
not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.common.tree import flatten, tree_global_norm, unflatten_as

Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass
class OptState:
    m: Any  # a tree like the parameters'
    v: Any
    step: torch.Tensor  # 0-d int32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Scalar, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: Scalar = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params) -> OptState:
        flat = flatten(params)
        zeros = lambda: unflatten_as(params, {
            k: torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)
            for k, p in flat.items()})
        device = next(iter(flat.values())).device
        return OptState(m=zeros(), v=zeros(),
                        step=torch.zeros((), dtype=torch.int32,
                                         device=device))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: OptState, params
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
        """Returns (new_params, new_state, metrics)."""
        gnorm = tree_global_norm(grads)
        one = torch.ones((), dtype=torch.float32, device=gnorm.device)
        scale = torch.minimum(
            one, self.clip_norm / torch.maximum(gnorm, 1e-9 * one))
        step = state.step + 1
        lr = self._lr(step)
        b1c = 1.0 - self.b1 ** step.to(torch.float32)
        b2c = 1.0 - self.b2 ** step.to(torch.float32)
        # a python zero skips the decay; a tensor always applies
        wd = self.weight_decay
        apply_wd = not (isinstance(wd, (int, float)) and wd == 0)

        flat_g, flat_m, flat_v = (flatten(t) for t in (grads, state.m,
                                                       state.v))
        new_p, new_m, new_v = {}, {}, {}
        for k, p in flatten(params).items():
            g = flat_g[k].to(torch.float32) * scale
            m2 = self.b1 * flat_m[k] + (1 - self.b1) * g
            v2 = self.b2 * flat_v[k] + (1 - self.b2) * g * g
            mhat = m2 / b1c
            vhat = v2 / b2c
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if apply_wd and p.dim() >= 2:  # no decay on norms/bias
                delta = delta + wd * p.to(torch.float32)
            p2 = p.to(torch.float32) - lr * delta
            new_p[k] = p2.to(p.dtype)
            new_m[k] = m2.to(self.state_dtype)
            new_v[k] = v2.to(self.state_dtype)
        return (unflatten_as(params, new_p),
                OptState(unflatten_as(state.m, new_m),
                         unflatten_as(state.v, new_v), step),
                {"grad_norm": gnorm, "lr": lr})
