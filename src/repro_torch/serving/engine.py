"""Batched fingerprint scoring engine on the card.

The PyTorch counterpart of ``repro/serving/engine.py``.
``FingerprintEngine`` runs Perona's inference path — feature
normalization/orientation/imputation (paper §III-B), edge-attribute
assembly, the GNN forward pass (§III-C) and the sigmoid anomaly head —
on one device, over inputs padded to a power-of-two row bucket as the
reference pads them, so that the outputs at ``[:n]`` do not depend on
the bucket and the two packages score the same arrays.

Only the statistics-free graph topology (chain membership, predecessor
indices, raw gauge gathering) stays in numpy (:func:`prepare_inputs`,
a copy of the reference's); everything numeric runs in the scoring
function of :func:`make_score_fn`, which the fleet scorer
(``fleet.shard.ShardedScorer``) runs too. Each engine accounts its calls
on a :class:`repro_torch.obs.DispatchSite` (one signature per bucket),
and ``trace_count`` reads it as the reference's reads its jit site.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.common.bucketing import next_pow2
from repro_torch.common.device import resolve_device
from repro_torch.core.graph_data import graph_structure
from repro_torch.core.model import PeronaModel
from repro_torch.core.params import flat_params
from repro_torch.core.preprocess import Preprocessor
from repro_torch.fingerprint.frame import (BenchmarkFrame, FrameOrRecords,
                                           as_frame)
from repro_torch.obs.dispatch import DispatchSite, instance_site

MIN_BUCKET = 64

# positional argument order of the scoring function (after params)
ARG_NAMES = ("raw", "present", "type_ids", "nbr", "nbr_mask",
             "edge_src", "dt", "t_src")


def bucket_size(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power-of-two bucket >= n (>= min_bucket)."""
    return next_pow2(n, min_bucket)


@dataclasses.dataclass
class ScoreResult:
    anomaly_prob: np.ndarray  # (N,) sigmoid of the anomaly head
    type_logits: np.ndarray  # (N, T) benchmark-type probe
    codes: np.ndarray  # (N, K) fingerprint codes
    n_padded: int  # bucket the batch was padded to


def make_score_fn(model: PeronaModel, preproc: Preprocessor,
                  device: torch.device):
    """(params, *ARG_NAMES tensors) -> dict scoring function.

    ``params`` maps ``model``'s ``state_dict`` names to tensors on
    ``device`` (:func:`repro_torch.core.params.flat_params`). The
    preprocessor statistics live on ``device`` as float32, as the
    reference closes over them as float32 constants.
    """
    f32 = {"dtype": torch.float32, "device": device}
    lo = torch.as_tensor(preproc.lo, **f32)
    hi = torch.as_tensor(preproc.hi, **f32)
    maximize = torch.as_tensor(preproc.maximize, device=device)
    fill = torch.as_tensor(preproc.fill_mean, **f32)
    elo = torch.as_tensor(preproc.edge_lo, **f32)
    ehi = torch.as_tensor(preproc.edge_hi, **f32)
    types = torch.arange(len(preproc.benchmark_types), device=device)

    def _score(params, raw, present, type_ids, nbr, nbr_mask,
               edge_src, dt, t_src):
        # §III-B normalization / orientation / imputation / one-hot
        norm = torch.clamp((raw - lo) / (hi - lo), 0.0, 1.0)
        norm = torch.where(maximize, norm, 1.0 - norm)
        norm = torch.where(present, norm, fill)
        # jax.nn.one_hot semantics: an id outside [0, T) gives a zero row
        # where F.one_hot would raise (padded rows carry id 0)
        onehot = (type_ids[:, None] == types).to(torch.float32)
        x = torch.cat([norm, onehot], dim=1)
        # edge attributes: scaled source-run gauges + time encodings,
        # on the float32 dt / t_src the reference computes them from
        efeat = torch.clamp((edge_src - elo) / (ehi - elo), 0.0, 1.0)
        hod = torch.remainder(t_src / 3600.0, 24.0)
        ang = 2 * math.pi * hod / 24
        enc = torch.stack([
            torch.log1p(dt) / 12.0,
            torch.clamp_max(dt / 3600.0, 1.0),
            0.5 + 0.5 * torch.sin(ang),
            0.5 + 0.5 * torch.cos(ang),
        ], dim=-1)
        edge = torch.cat([efeat, enc], dim=-1)
        edge = torch.where(nbr_mask[..., None], edge, 0.0)
        batch = {"x": x, "nbr": nbr, "nbr_mask": nbr_mask, "edge": edge}
        out = functional_call(model, params, (batch,), strict=True)
        return {
            "anomaly_prob": torch.sigmoid(out["anom_logit"]),
            "type_logits": out["type_logits"],
            "codes": out["codes"],
        }

    return _score


def device_params(model: PeronaModel, params, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """``params`` (the reference's nested tree or ``state_dict`` names,
    :func:`repro_torch.core.params.flat_params`) as float32 tensors on
    ``device``, checked against ``model``'s parameter shapes."""
    placed = {k: v.to(device, torch.float32)
              for k, v in flat_params(params).items()}
    shapes = {k: tuple(v.shape) for k, v in placed.items()}
    expected = {k: tuple(v.shape) for k, v in model.named_parameters()}
    if shapes != expected:
        raise ValueError(f"params do not match the model: got "
                         f"{shapes}, expected {expected}")
    return placed


def prepare_features(preproc: Preprocessor, frame: BenchmarkFrame
                     ) -> Dict[str, np.ndarray]:
    """Per-row feature columns of a frame, ready for the scoring call
    (un-padded; row-aligned with the frame)."""
    raw, present = preproc.raw_features(frame)
    return {
        "raw": raw.astype(np.float32),
        "present": present,
        "type_ids": preproc.type_ids(frame),
        "edge_raw": preproc.raw_edges(frame).astype(np.float32),
    }


def assemble_inputs(features: Dict[str, np.ndarray], nbr: np.ndarray,
                    dt: np.ndarray, t_src: np.ndarray, bucket: int
                    ) -> Dict[str, np.ndarray]:
    """Pad per-row features + graph topology to ``bucket`` rows and
    gather the per-edge source-run gauges: the numpy dict of ARG_NAMES
    arrays consumed by the scoring call. Padded rows have raw=0 and
    present=False (so they take ``fill_mean``), type id 0 and no
    predecessors (nbr=-1)."""
    n = nbr.shape[0]

    def padf(arr, dtype=None, fillv=0.0):
        out = np.full((bucket,) + arr.shape[1:],
                      fillv, dtype or arr.dtype)
        out[:n] = arr
        return out

    nbr_p = padf(nbr, fillv=-1)
    # gather source-run gauges after padding (index -1 -> row 0,
    # masked out in the scoring call like the model's neighbor gather)
    src = np.maximum(nbr_p, 0)
    return {
        "raw": padf(features["raw"], np.float32),
        "present": padf(features["present"]),
        "type_ids": padf(features["type_ids"]),
        "nbr": nbr_p,
        "nbr_mask": nbr_p >= 0,
        "edge_src": padf(features["edge_raw"], np.float32)[src],
        "dt": padf(dt, np.float32),
        "t_src": padf(t_src, np.float32),
    }


def prepare_inputs(preproc: Preprocessor, frame: BenchmarkFrame,
                   bucket: int) -> Dict[str, np.ndarray]:
    """Full numpy input assembly for one frame (features + topology)."""
    gs = graph_structure(frame)
    return assemble_inputs(prepare_features(preproc, frame),
                           gs.nbr, gs.dt, gs.t_src, bucket)


class FingerprintEngine:
    """preprocess -> forward -> sigmoid on one device (the card unless
    ``device="cpu"``)."""

    def __init__(self, model: PeronaModel, params, preproc: Preprocessor,
                 min_bucket: int = MIN_BUCKET, device="cuda"):
        self.device = resolve_device(device)
        # full float32 matmuls: parity with the float32 reference (TF32
        # keeps about three decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model.eval()
        self.params = device_params(model, params, self.device)
        self.preproc = preproc
        self.min_bucket = min_bucket
        self._score = make_score_fn(self.model, preproc, self.device)
        # per-instance dispatch accounting on the obs registry
        self.site = DispatchSite(instance_site("serving.engine"))

    @property
    def trace_count(self) -> int:
        """Distinct buckets scored so far (the reference's jit
        tracings, one per bucket)."""
        return self.site.count

    def prepare(self, frame: BenchmarkFrame):
        """Device inputs in ARG_NAMES order, and the bucket."""
        b = bucket_size(len(frame), self.min_bucket)
        inputs = prepare_inputs(self.preproc, frame, b)
        return tuple(torch.from_numpy(inputs[k]).to(self.device)
                     for k in ARG_NAMES), b

    def score(self, data: FrameOrRecords) -> ScoreResult:
        """Score one batch of benchmark executions (frame or records)."""
        frame = as_frame(data)
        n = len(frame)
        args, b = self.prepare(frame)
        with torch.inference_mode(), \
                self.site.dispatch((b,), "engine.score",
                                   args={"rows": n, "bucket": b}):
            out = self._score(self.params, *args)
            host = {k: v[:n].cpu().numpy() for k, v in out.items()}
        return ScoreResult(anomaly_prob=host["anomaly_prob"],
                           type_logits=host["type_logits"],
                           codes=host["codes"], n_padded=b)
