"""Acquisition functions as batched tensor ops (paper §IV-D).

The port of ``repro/optimizer/acquire.py``: expected improvement and
the Perona acquisition weighting, over a leading lane axis. Expected
improvement mirrors ``tuning.gp.expected_improvement`` (the normal cdf
as ``torch.special.ndtr``, the pdf in ``jax.scipy.stats.norm``'s form)
and the weighting mirrors ``tuning.perona_weights.
PeronaAcquisitionWeighter.__call__``. Inputs arrive precomputed as
matrices (normalized machine-score rows per candidate configuration,
observed utilization per evaluated run), so a weighting step is one
batched matvec.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def expected_improvement(mu: torch.Tensor, sigma: torch.Tensor,
                         best, xi: float = 0.01) -> torch.Tensor:
    """EI for *minimization*; clipped at 0 (EI is non-negative by
    definition — the clip removes float underflow artifacts). ``best``
    broadcasts against ``mu``."""
    imp = best - mu - xi
    z = imp / torch.clamp(sigma, min=1e-9)
    pdf = torch.exp((_LOG_2PI + z * z) / -2.0)
    ei = imp * torch.special.ndtr(z) + sigma * pdf
    return torch.clamp(ei, min=0.0)


def perona_weight_factors(util: torch.Tensor, norm_scores: torch.Tensor,
                          prices: torch.Tensor, any_valid,
                          strength: float = 0.3,
                          per_dollar: bool = True) -> torch.Tensor:
    """Multiplicative acquisition factors of the §IV-D weighting, per
    lane.

    ``util`` (L, 4) mean observed per-aspect utilization of the runs so
    far; ``norm_scores`` (L, C, 4) normalized fingerprint score vector
    of each candidate's machine type; ``prices`` (L, C) on-demand $/h;
    ``any_valid`` (L,). Two-phase prior: capability while no valid
    configuration is known (``any_valid`` False), capability per dollar
    once one exists."""
    util = util / torch.clamp(util.sum(-1, keepdim=True), min=1e-9)
    w = (norm_scores @ util[..., None])[..., 0]
    if per_dollar:
        w = torch.where(any_valid[:, None], w / prices, w)
    w = w / torch.clamp(w.mean(-1, keepdim=True), min=1e-9)
    return 1.0 + strength * (w - 1.0)
