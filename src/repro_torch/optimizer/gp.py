"""Batched RBF Gaussian process in float64 tensors (masked + padded).

The port of ``repro/optimizer/gp.py``, batched over a leading *lane*
axis where the reference is ``vmap``-ed: per-dimension median-heuristic
length scales, y standardization, noise jitter, exact Cholesky
inference, each lane on its own observation set. Observation sets are
carried padded to a fixed slot count (``common.bucketing.next_pow2`` of
the run budget) with a validity mask, so one program serves every lane
at every BO round. Nothing here reads a value back to the host.

Masking convention: padded observation rows contribute an identity
block to the kernel matrix (diagonal 1 + noise, zero cross terms) and a
zero target, so their Cholesky/solve contributions vanish exactly —
fit/predict on a masked set equals fit/predict on the dense subset. The
matrix is therefore always positive definite, and
``torch.linalg.cholesky_ex`` (which does not check ``info`` on the
host) stands in for ``jnp.linalg.cholesky``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class GPState(NamedTuple):
    """Posterior state of a batch of fitted lanes."""

    chol: torch.Tensor  # (L, P, P) lower Cholesky of K + noise*I
    alpha: torch.Tensor  # (L, P) K^-1 y_standardized
    x: torch.Tensor  # (L, P, D) padded observations
    mask: torch.Tensor  # (L, P) observation validity
    scales: torch.Tensor  # (L, D) median-heuristic length scales
    y_mean: torch.Tensor  # (L,)
    y_std: torch.Tensor  # (L,)


def median_scales(x: torch.Tensor, mask: torch.Tensor, m: torch.Tensor,
                  rows: Optional[int] = None) -> torch.Tensor:
    """Per-lane, per-dimension median of |x_i - x_j| over all valid
    pairs (self-pairs included, as in the reference), floored at 1.0
    for near-constant dimensions. ``x`` (L, P, D), ``mask`` (L, P),
    ``m`` (L,) valid counts.

    The |x_i - x_j| matrix is symmetric with a zero diagonal, so the
    m^2-multiset's order statistics are recovered from the unique
    pairs alone: the m smallest entries are the diagonal zeros, and the
    k-th smallest for k >= m is the (k - m)//2-th smallest pair value
    (each pair appears twice). Only the r(r-1)/2 upper-triangle pairs
    are built (``rows``: valid observations live in a prefix of the
    padded slots); invalid pairs sort to the back as +inf, sorted along
    the last (pair) axis."""
    r = x.shape[1] if rows is None else rows
    iu, ju = torch.triu_indices(r, r, 1, device=x.device)
    u = (x[:, iu] - x[:, ju]).abs()  # (L, T, D)
    pair_ok = mask[:, iu] & mask[:, ju]
    u = torch.where(pair_ok[..., None], u,
                    torch.full_like(u, math.inf)).transpose(1, 2)
    u = torch.sort(u, dim=-1).values  # (L, D, T)
    zero = torch.zeros_like(u[..., 0])

    def stat(k):  # k-th smallest of the m*m masked-median multiset
        j = torch.clamp((k - m) // 2, min=0)
        pick = torch.gather(u, 2, j[:, None, None].expand(-1, u.shape[1],
                                                            1))[..., 0]
        return torch.where((k < m)[:, None], zero, pick)

    med = 0.5 * (stat((m * m - 1) // 2) + stat((m * m) // 2))
    return torch.where(med > 1e-9, med, torch.ones_like(med))


def _kernel(a: torch.Tensor, b: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """RBF kernel via the matmul expansion |a'|^2 + |b'|^2 - 2 a'.b'
    of the scaled squared distance (clipped at 0 so self-distances stay
    exactly zero under rounding). ``a`` (L, N, D), ``b`` (L, M, D),
    ``scales`` (L, D) -> (L, N, M)."""
    a = a / scales[:, None, :]
    b = b / scales[:, None, :]
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    sq = na[:, :, None] + nb[:, None, :] - 2.0 * (a @ b.transpose(1, 2))
    return torch.exp(-0.5 * torch.clamp(sq, min=0.0))


def gp_fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
           noise: float = 1e-3,
           median_rows: Optional[int] = None) -> GPState:
    """Fit every lane's GP on its masked observation set.

    ``x`` (L, P, D), ``y`` (L, P), ``mask`` (L, P) — padded rows are
    ignored exactly (see module docstring). Constant-y sets fall back
    to unit std (the reference's degenerate-input guard).
    ``median_rows`` bounds the slots the length-scale median looks at
    (see :func:`median_scales`)."""
    m = mask.sum(-1)
    mf = m.to(y.dtype)
    zero = torch.zeros_like(y)
    y_mean = torch.where(mask, y, zero).sum(-1) / mf
    dev = y - y_mean[:, None]
    var = torch.where(mask, dev * dev, zero).sum(-1) / mf
    y_std = torch.sqrt(var)
    y_std = torch.where(
        y_std <= 1e-12 * torch.clamp(y_mean.abs(), min=1.0),
        torch.ones_like(y_std), y_std)
    yn = torch.where(mask, dev / y_std[:, None], zero)
    scales = median_scales(x, mask, m, rows=median_rows)
    pmask = mask[:, :, None] & mask[:, None, :]
    k = _kernel(x, x, scales)
    k = torch.where(pmask, k, torch.zeros_like(k))
    diag = torch.where(mask, torch.full_like(y, noise),
                       torch.full_like(y, 1.0 + noise))
    k = k + torch.diag_embed(diag)
    chol, _ = torch.linalg.cholesky_ex(k)
    # cho_solve as its two triangular solves (no info check on the host)
    half = torch.linalg.solve_triangular(chol, yn[..., None], upper=False)
    alpha = torch.linalg.solve_triangular(chol.transpose(1, 2), half,
                                          upper=True)[..., 0]
    return GPState(chol=chol, alpha=alpha, x=x, mask=mask, scales=scales,
                   y_mean=y_mean, y_std=y_std)


def gp_predict(state: GPState, xs: torch.Tensor):
    """Posterior (mu, sigma) at candidate points ``xs`` (L, C, D).

    The predictive variance 1 - k* K^-1 k*^T is computed as
    1 - ||L^-1 k*^T||^2, with L^-1 materialized once per fit state (a
    P x P triangular solve against the identity) so the per-candidate
    work is one matmul."""
    ks = _kernel(xs, state.x, state.scales) * state.mask[:, None, :]
    mu = (ks @ state.alpha[..., None])[..., 0]
    p = state.chol.shape[-1]
    eye = torch.eye(p, dtype=ks.dtype, device=ks.device).expand_as(
        state.chol)
    l_inv = torch.linalg.solve_triangular(state.chol, eye, upper=False)
    w = l_inv @ ks.transpose(1, 2)  # (L, P, C)
    var = torch.clamp(1.0 - (w * w).sum(1), min=1e-9)
    return (mu * state.y_std[:, None] + state.y_mean[:, None],
            torch.sqrt(var) * state.y_std[:, None])
