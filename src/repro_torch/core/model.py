"""Perona model: autoencoder + graph aggregation + heads (paper §III-C).

The PyTorch counterpart of ``repro/core/model.py``. enc/dec follow the
Bellamy-style MLP design with a sigmoid decoder head; ``agg`` averages
two graph transforms — a TransformerConv-style edge attention (the
edge-softmax CUDA kernels on the card, forward and backward) and a
TAGConv-style hop propagation — preceded by edge dropout and followed
by SELU, alpha dropout and a final linear transform with a root skip.
The anomaly head scores sigma(f1(v_agg - v)); a linear probe predicts
the benchmark type. :meth:`PeronaModel.loss` adds the five objectives
of ``core.losses``.

Parameters keep the reference tree's names and shapes (``enc``,
``dec``, ``wq``/``wk``/``wv``, ``we_k``/``we_v``, ``tag[i]``, ``root``,
``out``, ``f1``, ``cls``; each linear ``{"w": (d_in, d_out), "b"}``),
so ``state_dict`` keys are the reference's slash-joined paths with dots
(``core.params`` carries a reference tree across).

Training mode is the ``train`` argument of :meth:`PeronaModel.forward`,
as in the reference (``nn.Module.training`` is not read). Its three
dropouts draw from an explicit ``torch.Generator`` in the reference's
order: feature dropout on x, edge dropout on the mask, alpha dropout
after the first SELU. Training with no generator applies none, as the
reference's ``rng=None`` does. The draws are not ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import losses as L
from repro_torch.kernels.edge_softmax import ops as edge_softmax
from repro_torch.models.nn import Linear


@dataclasses.dataclass(frozen=True)
class PeronaConfig:
    """The fields and defaults of ``repro.core.model.PeronaConfig``, so a
    configuration crosses between the packages unchanged. ``gnn_impl``
    selects the JAX package's aggregation; the port always goes through
    the kernel wrapper, which launches the CUDA kernels for tensors on
    the card and takes the plain versions for tensors on the CPU."""

    feature_dim: int  # F' (selected metrics + one-hot types)
    edge_dim: int  # A
    n_types: int = 6
    code_dim: int = 32  # K
    hidden: int = 64
    tag_hops: int = 2
    heads: int = 4  # attention heads of the transformer conv
    edge_dropout: float = 0.1
    feature_dropout: float = 0.1
    alpha_dropout: float = 0.05
    use_root_weight: bool = True
    p_norm: float = 10.0
    cbfl_gamma: float = 2.0
    cbfl_beta: float = 0.999
    tml_margin: float = 0.3
    mrl_margin: float = 0.01
    anom_margin: float = 0.1
    loss_weights: Tuple[float, float, float, float, float] = (
        1.0, 1.0, 1.0, 1.0, 1.0)  # mse, cbfl, cel, tml, mrl
    gnn_impl: str = "reference"  # reference | pallas


def _mlp(dims, generator) -> nn.ModuleList:
    return nn.ModuleList(Linear(a, b, generator=generator)
                         for a, b in zip(dims[:-1], dims[1:]))


def _run_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i + 1 < len(layers):
            x = F.selu(x)
    return x


#: SELU's negative saturation, the value alpha dropout drops to
ALPHA_P = -1.7580993408473766


def _keep(shape, rate, generator, device):
    """Bernoulli(1 - rate) keep mask, as ``jax.random.bernoulli``: a
    uniform draw below the keep probability. ``generator`` is a
    ``torch.Generator`` or a source of fixed draws (``rand(shape,
    device)``, as ``core.trainer.FixedDraws``)."""
    if isinstance(generator, torch.Generator):
        u = torch.rand(shape, generator=generator, device=device)
    else:
        u = generator.rand(shape, device)
    return u < 1.0 - rate


def drop_features(x, rate, generator):
    """Inverted dropout: ``x * keep / (1 - rate)``."""
    return x * _keep(x.shape, rate, generator, x.device) / (1.0 - rate)


def drop_edges(mask, rate, generator):
    """Drops each edge of the (N, P) validity mask with ``rate``."""
    return mask & _keep(mask.shape, rate, generator, mask.device)


def alpha_dropout(x, rate: float, generator):
    """SELU-preserving alpha dropout: a dropped unit takes SELU's
    saturation ``ALPHA_P``, then an affine map restores a zero-mean,
    unit-variance input's moments."""
    keep = _keep(x.shape, rate, generator, x.device)
    q = 1.0 - rate
    a = (q + ALPHA_P ** 2 * q * (1 - q)) ** -0.5
    b = -a * ALPHA_P * (1 - q)
    return a * torch.where(keep, x, ALPHA_P) + b


def _gather_neighbors(codes, nbr):
    """codes (N,K), nbr (N,P) -> (N,P,K) with index -1 mapped to row 0
    (masked later), as the reference does."""
    return codes[torch.clamp_min(nbr, 0).long()]


class PeronaModel(nn.Module):
    def __init__(self, cfg: PeronaConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        K, H, A, Fd = cfg.code_dim, cfg.hidden, cfg.edge_dim, cfg.feature_dim
        g = generator
        self.enc = _mlp((Fd, H, K), g)
        self.dec = _mlp((K, H, Fd), g)
        # TransformerConv-style params
        self.wq = Linear(K, K, generator=g)
        self.wk = Linear(K, K, generator=g)
        self.wv = Linear(K, K, generator=g)
        self.we_k = Linear(A, K, generator=g)
        self.we_v = Linear(A, K, generator=g)
        # TAGConv-style hop weights
        self.tag = nn.ModuleList(Linear(K, K, generator=g)
                                 for _ in range(cfg.tag_hops + 1))
        if cfg.use_root_weight:
            self.root = Linear(K, K, generator=g)
        self.out = Linear(K, K, generator=g)
        self.f1 = _mlp((K, H, 1), g)
        self.cls = Linear(K, cfg.n_types, generator=g)

    # ------------------------------------------------------------ graph
    def _transformer_conv(self, codes, nbr, mask, edge):
        q = self.wq(codes)  # (N,K)
        nb = _gather_neighbors(codes, nbr)  # (N,P,K)
        k = self.wk(nb) + self.we_k(edge)
        v = self.wv(nb) + self.we_v(edge)
        K, hN = self.cfg.code_dim, self.cfg.heads
        hd = K // hN
        N, P = mask.shape
        # the (N, H, hd) head layout of the reference, straight into
        # the kernel: no per-head loop, no (hN*N, P, hd) flattening
        out, _ = edge_softmax.edge_softmax_aggregate(
            q.reshape(N, hN, hd), k.reshape(N, P, hN, hd),
            v.reshape(N, P, hN, hd), mask)
        return out.reshape(N, K)

    def _tag_conv(self, codes, nbr, mask):
        """Hop propagation with masked-mean neighbor aggregation."""
        out = self.tag[0](codes)
        x = codes
        maskf = mask.to(codes.dtype)
        denom = torch.clamp_min(maskf.sum(1, keepdim=True), 1.0)
        for hop in range(1, self.cfg.tag_hops + 1):
            nb = _gather_neighbors(x, nbr)  # (N,P,K)
            x = (nb * maskf[..., None]).sum(1) / denom
            out = out + self.tag[hop](x)
        return out

    def aggregate(self, codes, nbr, mask, edge, *, generator=None,
                  train: bool = False, edge_dropout=None):
        """The paper's agg: edge dropout -> mean(TransformerConv,
        TAGConv) -> SELU -> alpha dropout -> linear (+root skip) -> SELU.

        ``edge_dropout`` optionally overrides ``cfg.edge_dropout`` (a
        float or a 0-d tensor); when given, dropout is always applied.
        """
        cfg = self.cfg
        drop = train and generator is not None
        if drop and (edge_dropout is not None or cfg.edge_dropout > 0):
            rate = cfg.edge_dropout if edge_dropout is None else edge_dropout
            mask = drop_edges(mask, rate, generator)
        t_out = self._transformer_conv(codes, nbr, mask, edge)
        g_out = self._tag_conv(codes, nbr, mask)
        out = F.selu(0.5 * (t_out + g_out))
        if drop and cfg.alpha_dropout > 0:
            out = alpha_dropout(out, cfg.alpha_dropout, generator)
        out = self.out(out)
        if self.cfg.use_root_weight:
            out = out + self.root(codes)
        return F.selu(out)

    # ------------------------------------------------------------ model
    def forward(self, batch: Dict[str, torch.Tensor], *,
                generator: Optional[torch.Generator] = None,
                train: bool = False, hypers: Optional[Dict] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: dict with x (N,F'), nbr (N,P) int, nbr_mask (N,P) bool,
        edge (N,P,A). Returns dict(codes, recon, agg, anom_logit,
        type_logits).

        With ``train`` and a ``generator`` the dropouts are drawn from
        it. ``hypers`` optionally carries scalar hyperparameters
        (``feature_dropout``, ``edge_dropout``; floats or 0-d tensors)
        overriding the config's; a dropout named there is always
        applied, so the draws follow the static path for positive
        static rates (``repro/core/model.py:178-205``).
        """
        hypers = hypers or {}
        cfg = self.cfg
        x = batch["x"]
        if train and generator is not None and (
                "feature_dropout" in hypers or cfg.feature_dropout > 0):
            x = drop_features(
                x, hypers.get("feature_dropout", cfg.feature_dropout),
                generator)
        codes = _run_mlp(self.enc, x)
        recon = torch.sigmoid(_run_mlp(self.dec, codes))
        agg = self.aggregate(codes, batch["nbr"], batch["nbr_mask"],
                             batch["edge"], generator=generator,
                             train=train,
                             edge_dropout=hypers.get("edge_dropout"))
        anom_logit = _run_mlp(self.f1, agg - codes)[:, 0]
        type_logits = self.cls(codes)
        return {"codes": codes, "recon": recon, "agg": agg,
                "anom_logit": anom_logit, "type_logits": type_logits}

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             hypers: Optional[Dict] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {mse, cbfl, cel, tml, mrl}) of the training-mode
        forward. batch adds type_id, anomaly and norm_gt (N,) and an
        optional ``valid`` (N,) float weight (ones when absent);
        ``hypers`` may also carry ``cbfl_gamma`` and ``cbfl_beta``."""
        hypers = hypers or {}
        cfg = self.cfg
        out = self.forward(batch, generator=generator, train=True,
                           hypers=hypers)
        x = batch["x"]
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(x.shape[0], dtype=torch.float32,
                               device=x.device)
        w = cfg.loss_weights
        mse = L.mse_loss(out["recon"], x, valid)
        cbfl = L.class_balanced_focal_loss(
            out["anom_logit"], batch["anomaly"], valid,
            gamma=hypers.get("cbfl_gamma", cfg.cbfl_gamma),
            beta=hypers.get("cbfl_beta", cfg.cbfl_beta))
        cel = L.cross_entropy_loss(out["type_logits"], batch["type_id"],
                                   valid)
        tml = L.triplet_margin_loss(out["codes"], batch["type_id"], valid,
                                    margin=cfg.tml_margin)
        mrl = L.margin_ranking_loss(
            out["codes"], batch["norm_gt"], batch["type_id"],
            batch["anomaly"], valid, p=cfg.p_norm, margin=cfg.mrl_margin,
            anom_margin=cfg.anom_margin)
        total = (w[0] * mse + w[1] * cbfl + w[2] * cel + w[3] * tml
                 + w[4] * mrl)
        return total, {"mse": mse, "cbfl": cbfl, "cel": cel, "tml": tml,
                       "mrl": mrl}
