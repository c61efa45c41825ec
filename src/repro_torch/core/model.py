"""Perona model: autoencoder + graph aggregation + heads (paper §III-C).

The PyTorch counterpart of ``repro/core/model.py``, forward in eval
mode. enc/dec follow the Bellamy-style MLP design with a sigmoid
decoder head; ``agg`` averages two graph transforms — a
TransformerConv-style edge attention (the edge-softmax CUDA kernel on
the card) and a TAGConv-style hop propagation — followed by SELU and a
final linear transform with a root skip. The anomaly head scores
sigma(f1(v_agg - v)); a linear probe predicts the benchmark type.

Parameters keep the reference tree's names and shapes (``enc``,
``dec``, ``wq``/``wk``/``wv``, ``we_k``/``we_v``, ``tag[i]``, ``root``,
``out``, ``f1``, ``cls``; each linear ``{"w": (d_in, d_out), "b"}``),
so ``state_dict`` keys are the reference's slash-joined paths with dots
(``core.params`` carries a reference tree across). Dropout belongs to
training and is not part of this forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.edge_softmax import ops as edge_softmax
from repro_torch.models.nn import Linear


@dataclasses.dataclass(frozen=True)
class PeronaConfig:
    """The fields and defaults of ``repro.core.model.PeronaConfig``, so a
    configuration crosses between the packages unchanged. The dropout
    rates and loss fields serve training. ``gnn_impl`` selects the JAX
    package's aggregation; the port always goes through the kernel
    wrapper, which launches the CUDA kernel for tensors on the card and
    takes the plain version for tensors on the CPU."""

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

    def aggregate(self, codes, nbr, mask, edge):
        """The paper's agg in eval mode: mean(TransformerConv, TAGConv)
        -> SELU -> linear (+root skip) -> SELU."""
        t_out = self._transformer_conv(codes, nbr, mask, edge)
        g_out = self._tag_conv(codes, nbr, mask)
        out = F.selu(0.5 * (t_out + g_out))
        out = self.out(out)
        if self.cfg.use_root_weight:
            out = out + self.root(codes)
        return F.selu(out)

    # ------------------------------------------------------------ model
    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch: dict with x (N,F'), nbr (N,P) int, nbr_mask (N,P) bool,
        edge (N,P,A). Returns dict(codes, recon, agg, anom_logit,
        type_logits)."""
        if self.training:
            raise NotImplementedError(
                "PeronaModel has an eval-mode forward only (no dropout); "
                "call .eval() first")
        x = batch["x"]
        codes = _run_mlp(self.enc, x)
        recon = torch.sigmoid(_run_mlp(self.dec, codes))
        agg = self.aggregate(codes, batch["nbr"], batch["nbr_mask"],
                             batch["edge"])
        anom_logit = _run_mlp(self.f1, agg - codes)[:, 0]
        type_logits = self.cls(codes)
        return {"codes": codes, "recon": recon, "agg": agg,
                "anom_logit": anom_logit, "type_logits": type_logits}
