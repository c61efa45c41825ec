"""Perona's five training objectives (paper §III-C/D training notes).

The PyTorch counterpart of ``repro/core/losses.py``:

  MSE  — autoencoder reconstruction
  CBFL — class-balanced focal loss [Cui et al. 2019] for outlier
         detection (binary, heavy normal/anomalous imbalance)
  TML  — triplet margin loss [FaceNet] + hard-pair miner for per-type
         clustering of codes (cosine geometry)
  CEL  — cross entropy on the linear benchmark-type probe
  MRL  — margin ranking loss against the p-norm ground truth within each
         type; anomalous codes must rank below the lowest normal code

All losses are masked-mean over valid nodes and combined additively.
Scalar hyperparameters (CBFL gamma/beta) may be python floats or 0-d
tensors.

Gradients follow the reference's at ties: JAX splits the gradient of a
``max``/``min`` reduction evenly among tied entries and gives half to
each side of ``maximum``/``minimum`` at equality. ``torch.amax``,
``torch.amin``, ``torch.maximum`` and ``torch.minimum`` do the same;
``max(dim)``, ``clamp_min`` and ``relu`` do not, so none is used here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device: a python number is
    filled in place (no host-to-device copy, which a CUDA graph cannot
    capture), a tensor is cast."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _count(valid: torch.Tensor) -> torch.Tensor:
    """max(sum(valid), 1): the masked mean's denominator."""
    return torch.maximum(valid.sum(), _f32(1.0, valid))


def mse_loss(recon, x, valid):
    err = torch.square(recon - x).sum(-1) / x.shape[-1]
    return (err * valid).sum() / _count(valid)


def class_balanced_focal_loss(logit, label, valid, *, gamma=2.0,
                              beta=0.999):
    """Binary CBFL. logit (N,), label (N,) in {0,1}."""
    # cast first so a python-float and a tensor beta give the same
    # float32 arithmetic (1 - beta happens in float32 either way)
    beta = _f32(beta, logit)
    label = label.to(torch.float32)
    n_pos = (label * valid).sum()
    n_neg = ((1 - label) * valid).sum()
    one = _f32(1.0, logit)

    def eff(n):
        return (1.0 - torch.pow(beta, torch.maximum(n, one))) / (1 - beta)

    w_pos = 1.0 / eff(n_pos)
    w_neg = 1.0 / eff(n_neg)
    # normalize weights to sum to 2 (class count), as in the paper's ref
    z = w_pos + w_neg
    w_pos, w_neg = 2 * w_pos / z, 2 * w_neg / z
    p = torch.sigmoid(logit)
    pt = torch.where(label > 0, p, 1 - p)
    w = torch.where(label > 0, w_pos, w_neg)
    focal = (-w * torch.pow(1 - pt, gamma)
             * torch.log(torch.maximum(pt, _f32(1e-12, pt))))
    return (focal * valid).sum() / _count(valid)


def cross_entropy_loss(logits, labels, valid):
    logp = F.log_softmax(logits, -1)
    nll = -torch.take_along_dim(logp, labels.long()[:, None], -1)[:, 0]
    return (nll * valid).sum() / _count(valid)


def triplet_margin_loss(codes, type_id, valid, *, margin: float = 0.3):
    """Cosine-distance TML with a batch-hard miner: per anchor, hardest
    positive (same type, max distance) and hardest negative (other type,
    min distance)."""
    norm = torch.linalg.vector_norm(codes, dim=-1, keepdim=True)
    c = codes / torch.maximum(norm, _f32(1e-9, codes))
    dist = 1.0 - c @ c.T  # (N, N)
    live = (valid[:, None] > 0) & (valid[None, :] > 0)
    same = (type_id[:, None] == type_id[None, :]) & live
    eye = torch.eye(codes.shape[0], dtype=torch.bool, device=codes.device)
    pos_mask = same & ~eye
    neg_mask = (~same) & live
    hardest_pos = torch.amax(torch.where(pos_mask, dist, -1.0), dim=1)
    hardest_neg = torch.amin(torch.where(neg_mask, dist, 4.0), dim=1)
    has_pair = (pos_mask.any(1) & neg_mask.any(1)).to(torch.float32) * valid
    loss = torch.maximum(hardest_pos - hardest_neg + margin,
                         _f32(0.0, codes))
    return (loss * has_pair).sum() / _count(has_pair)


def pnorm(codes, p: float = 10.0):
    return torch.pow(torch.pow(torch.abs(codes) + 1e-12, p).sum(-1),
                     1.0 / p)


def margin_ranking_loss(codes, norm_gt, type_id, anomaly, valid, *,
                        p: float = 10.0, margin: float = 0.01,
                        anom_margin: float = 0.1):
    """Pairwise ranking of code p-norms against the ground-truth p-norm
    ranking of preprocessed vectors, per benchmark type; anomalous codes
    are pushed below the lowest normal score of their type."""
    zero = _f32(0.0, codes)
    s = pnorm(codes, p)  # (N,)
    same = type_id[:, None] == type_id[None, :]
    vpair = (valid[:, None] > 0) & (valid[None, :] > 0) & same
    normal = (anomaly == 0) & (valid > 0)
    both_normal = vpair & normal[:, None] & normal[None, :]
    y = torch.sign(norm_gt[:, None] - norm_gt[None, :])
    ranked = both_normal & (y != 0)
    pair_loss = torch.maximum(-y * (s[:, None] - s[None, :]) + margin, zero)
    pair_loss = torch.where(ranked, pair_loss, zero)
    n_pairs = ranked.to(torch.float32).sum()
    rank_term = pair_loss.sum() / torch.maximum(n_pairs, _f32(1.0, codes))

    # anomalous below the lowest normal score of the same type
    anom = (anomaly == 1) & (valid > 0)
    min_same = torch.amin(torch.where(same & normal[None, :], s[None, :],
                                      torch.inf), dim=1)
    anom_loss = torch.where(
        anom & torch.isfinite(min_same),
        torch.maximum(s - (min_same - anom_margin), zero), zero)
    anom_term = anom_loss.sum() / torch.maximum(
        anom.to(torch.float32).sum(), _f32(1.0, codes))
    return rank_term + anom_term
