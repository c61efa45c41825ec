"""Int8 gradient compression with error feedback.

``repro/optim/compress.py`` in PyTorch: each gradient leaf, plus the
error-feedback buffer, is quantized to int8 with a per-tensor float32
scale (``max|x| / 127``, at least 1e-12 / 127), rounded half to even
and clipped to [-127, 127]; the residual is carried to the next step
(EF-SGD). Gradients are ``{name: tensor}`` dicts or nested dict and list
trees (``common.tree``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.tree import flatten, unflatten_as


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads, error_buf=None):
    """Returns ((q_tree, scale_tree), new_error_buf)."""
    flat = flatten(grads)
    err = ({k: torch.zeros_like(g, dtype=torch.float32)
            for k, g in flat.items()} if error_buf is None
           else flatten(error_buf))
    q, s, new_err = {}, {}, {}
    for k, g in flat.items():
        corrected = g.to(torch.float32) + err[k]
        q[k], s[k] = _quantize(corrected)
        new_err[k] = corrected - q[k].to(torch.float32) * s[k]
    return ((unflatten_as(grads, q), unflatten_as(grads, s)),
            unflatten_as(grads, new_err))


def decompress_gradients(q_tree, s_tree):
    s = flatten(s_tree)
    return unflatten_as(q_tree, {k: q.to(torch.float32) * s[k]
                                 for k, q in flatten(q_tree).items()})
