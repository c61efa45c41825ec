"""Perona training loop (AdamW, additive multi-task loss, <=100 epochs).

The PyTorch counterpart of the host-driven trainer of
``repro/core/trainer.py``: :func:`train_perona_reference` (`:274-341`),
the reference's parity oracle and sequential-HPO baseline. One step per
epoch on the full batch (the §IV-C acquisition is one batch), then the
validation loss and outlier F1, checkpoint selection on ``(f1,
-val_loss)`` and early stopping on the validation loss, on the host.
The device-resident scanned trainer (``train_perona``) is not ported
yet.

The port never reproduces ``jax.random``: the trainer takes a
``PeronaModel`` that already holds its initial parameters, and draws its
dropout masks from a ``torch.Generator`` seeded with ``seed + 1`` (the
reference's epoch key is ``PRNGKey(seed + 1)``). Runs agree with the
reference's step for step only at dropout 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.common.device import resolve_device
from repro_torch.core.graph_data import PeronaBatch
from repro_torch.core.model import PeronaConfig, PeronaModel
from repro_torch.core.params import flat_params
from repro_torch.optim.adamw import AdamW

BATCH_FIELDS = {"x": torch.float32, "type_id": None, "anomaly": None,
                "nbr": None, "nbr_mask": None, "edge": torch.float32,
                "norm_gt": torch.float32}


def batch_to_torch(batch: PeronaBatch, device) -> Dict[str, torch.Tensor]:
    """The model's input dict on ``device`` (``batch_to_jnp``)."""
    return {k: torch.as_tensor(np.asarray(getattr(batch, k)), dtype=dt,
                               device=device)
            for k, dt in BATCH_FIELDS.items()}


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]  # the selected parameters
    history: list
    best_epoch: int


def _f1_outlier(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Outlier F1 from confusion counts on the device, in float32
    (``repro/core/trainer.py:82-93``): sigmoid(x) >= 0.5 <=> x >= 0."""
    pred = logits >= 0.0
    pos = y == 1
    tp = (pred & pos).sum().to(torch.float32)
    fp = (pred & ~pos).sum().to(torch.float32)
    fn = (~pred & pos).sum().to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=logits.device)
    prec = tp / torch.maximum(tp + fp, one)
    rec = tp / torch.maximum(tp + fn, one)
    return 2.0 * prec * rec / torch.maximum(prec + rec, 1e-9 * one)


def _f1_host(logits: np.ndarray, y: np.ndarray) -> float:
    """Outlier F1 in python floats, as the host loop of the reference
    computes it (its selection compares these values)."""
    pred = logits >= 0.0  # sigmoid(x) >= 0.5
    tp = int(np.sum(pred & (y == 1)))
    fp = int(np.sum(pred & (y == 0)))
    fn = int(np.sum(~pred & (y == 1)))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def model_hypers(cfg: PeronaConfig, lr: float, weight_decay: float,
                 device) -> Dict[str, torch.Tensor]:
    """Scalar hypers as float32 0-d tensors on ``device``. Dropout keys
    are included only when the static rate is positive, so the draws
    follow the static-config path exactly (``trainer.py:96-110``)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    h = {"cbfl_gamma": f32(cfg.cbfl_gamma), "cbfl_beta": f32(cfg.cbfl_beta),
         "lr": f32(lr), "weight_decay": f32(weight_decay)}
    if cfg.feature_dropout > 0:
        h["feature_dropout"] = f32(cfg.feature_dropout)
    if cfg.edge_dropout > 0:
        h["edge_dropout"] = f32(cfg.edge_dropout)
    return h


def train_perona_reference(model: PeronaModel, train_batch: PeronaBatch,
                           val_batch: Optional[PeronaBatch] = None, *,
                           epochs: int = 100, lr: float = 3e-3,
                           weight_decay: float = 1e-4, patience: int = 25,
                           seed: int = 0, device="cuda") -> TrainResult:
    """Host-driven loop: one step per epoch, validation scoring and
    checkpoint selection on the host. Trains ``model`` in place from the
    parameters it holds, on ``device`` (the card unless ``"cpu"``), and
    leaves the selected parameters in it; they are also returned."""
    dev = resolve_device(device)
    # full float32 products: parity with the float32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.to(dev)
    params = dict(model.named_parameters())
    opt = AdamW(lr=lr, b2=0.999, weight_decay=weight_decay, clip_norm=5.0)
    state = opt.init(params)
    tb = batch_to_torch(train_batch, dev)
    vb = batch_to_torch(val_batch, dev) if val_batch is not None else None
    y_val = (np.asarray(val_batch.anomaly)
             if val_batch is not None else None)
    rng = torch.Generator(device=dev).manual_seed(seed + 1)
    val_rng = torch.Generator(device=dev)

    def snapshot():
        return {k: p.detach().clone() for k, p in params.items()}

    history = []
    loss_best = (np.inf, 0)  # early-stopping tracker (val total loss)
    best = ((-1.0, -np.inf), snapshot(), 0)  # selection: (f1, -loss)
    for epoch in range(epochs):
        loss, _ = model.loss(tb, rng)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            new, state, _ = opt.update(dict(zip(params, grads)), state,
                                       {k: p.detach()
                                        for k, p in params.items()})
            for k, p in params.items():
                p.copy_(new[k])
        entry = {"epoch": epoch, "train_loss": float(loss.detach())}
        if vb is not None:
            with torch.no_grad():
                # training mode, the same masks every epoch: the
                # reference's model.loss(params, vb, PRNGKey(0))
                vl, _ = model.loss(vb, val_rng.manual_seed(0))
                logits = model(vb)["anom_logit"]
            vl = float(vl)
            f1 = _f1_host(logits.cpu().numpy(), y_val)
            entry["val_loss"] = vl
            entry["val_f1_outlier"] = f1
            if (f1, -vl) > best[0]:
                best = ((f1, -vl), snapshot(), epoch)
            if vl < loss_best[0]:
                loss_best = (vl, epoch)
            elif epoch - loss_best[1] > patience:
                history.append(entry)
                break
        history.append(entry)
    selected = best[1] if vb is not None else snapshot()
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(selected[k])
    return TrainResult(params=selected, history=history,
                       best_epoch=best[2] if vb is not None else epochs - 1)


def evaluate(model: PeronaModel, params, batch: PeronaBatch) -> Dict:
    """§IV-C metrics: recon MSE, type accuracy, outlier P/R/F1, weighted
    accuracy. ``params``: a ``{state_dict name: tensor}`` dict or the
    reference's nested tree, on the model's device."""
    dev = next(model.parameters()).device
    b = batch_to_torch(batch, dev)
    with torch.no_grad():
        out = functional_call(model, flat_params(params), (b,))
        x = b["x"].cpu().numpy()
        recon = out["recon"].cpu().numpy()
        type_pred = out["type_logits"].argmax(-1).cpu().numpy()
        prob = torch.sigmoid(out["anom_logit"]).cpu().numpy()
    mse = float(np.mean((recon - x) ** 2))
    type_acc = float(np.mean(type_pred == batch.type_id))
    pred = (prob >= 0.5).astype(int)
    y = batch.anomaly

    def f1(cls):
        tp = int(np.sum((pred == cls) & (y == cls)))
        fp = int(np.sum((pred == cls) & (y != cls)))
        fn = int(np.sum((pred != cls) & (y == cls)))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        return 2 * prec * rec / max(prec + rec, 1e-9)

    acc = float(np.mean(pred == y))
    n0, n1 = int(np.sum(y == 0)), int(np.sum(y == 1))
    weighted_acc = float(
        (np.mean(pred[y == 0] == 0) * n0 + np.mean(pred[y == 1] == 1) * n1)
        / max(n0 + n1, 1)) if n1 else acc
    return {
        "mse": mse,
        "type_accuracy": type_acc,
        "f1_normal": f1(0),
        "f1_outlier": f1(1),
        "accuracy": acc,
        "weighted_accuracy": weighted_acc,
        "codes": out["codes"].cpu().numpy(),
        "anomaly_prob": prob,
    }
