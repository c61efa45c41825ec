"""Perona training loop (AdamW, additive multi-task loss, <=100 epochs).

The PyTorch counterpart of ``repro/core/trainer.py``. One step per
epoch on the full batch (the §IV-C acquisition is one batch), then the
validation loss and outlier F1, checkpoint selection on ``(f1,
-val_loss)`` and early stopping on the validation loss.

:func:`train_perona` is device-resident, as the reference's scanned
trainer (`:60-271`) is: the epoch is one function over static tensors
(:class:`EpochProgram`) that selects the best checkpoint with
``torch.where`` on the device, stops early by a masked ``stopped`` flag
and writes its history row at a device-side index. On the card it is
captured once into a CUDA graph and replayed ``epochs`` times; on the
CPU the same function runs eagerly in a loop. Neither reads the device
inside the loop: the history and the selected parameters come back
once, at the end. Programs are cached per (canonical configuration,
epochs, patience, validation or not, batch shapes, device), so the
trials of an HPO bucket share one capture.

:func:`train_perona_reference` is the host-driven loop (`:274-341`), the
reference's parity oracle and sequential-HPO baseline.

The port never reproduces ``jax.random``: the trainers take a
``PeronaModel`` that already holds its initial parameters, and draw the
training dropout masks from a ``torch.Generator`` seeded with ``seed +
1`` (the reference's epoch key is ``PRNGKey(seed + 1)``); the
validation loss takes the same masks every epoch (the reference's
``PRNGKey(0)``), drawn from a generator seeded 0. Runs agree with the
reference's step for step only at dropout 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

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
    stats: Optional[Dict] = None  # train_perona: captured, replays


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


def canonical_config(cfg: PeronaConfig) -> PeronaConfig:
    """``cfg`` with the scalar hypers pinned to canonical values: the
    reference's ``canonical_model`` (`:113-128`), on the configuration
    (a port model holds its parameters). The epoch program takes
    dropouts and CBFL gamma/beta as tensors, so it depends only on the
    dropouts' positivity (whether it draws), not on their values."""
    return dataclasses.replace(
        cfg, feature_dropout=0.1 if cfg.feature_dropout > 0 else 0.0,
        edge_dropout=0.1 if cfg.edge_dropout > 0 else 0.0,
        cbfl_gamma=2.0, cbfl_beta=0.999)


def _tree_where(pred: torch.Tensor, a: Dict[str, torch.Tensor],
                b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar-predicate select over matching parameter dicts."""
    return {k: torch.where(pred, a[k], b[k]) for k in a}


def _assign(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    for k, t in dst.items():
        t.copy_(src[k])


class FixedDraws:
    """The uniforms of one training-mode pass, drawn once from a
    generator seeded 0 and handed out again, in the same order, on every
    pass after :meth:`rewind`: the validation loss's masks, the same
    every epoch, as static tensors that a CUDA graph reads (a reseed
    would not happen at replay). The draws are the ones the host loop
    takes from its validation generator reseeded to 0 every epoch."""

    def __init__(self, device):
        self._gen = torch.Generator(device=device).manual_seed(0)
        self._draws = []
        self._next = 0

    def rewind(self) -> "FixedDraws":
        self._next = 0
        return self

    def rand(self, shape, device) -> torch.Tensor:
        if self._next == len(self._draws):
            self._draws.append(torch.rand(shape, generator=self._gen,
                                          device=device))
        u = self._draws[self._next]
        if u.shape != torch.Size(shape):
            raise ValueError(f"fixed draw {self._next} has shape "
                             f"{tuple(u.shape)}, asked {tuple(shape)}")
        self._next += 1
        return u


#: Epoch programs built so far (plain count; callers read differences):
#: one CUDA graph capture each on the card, one eager set-up on the CPU.
#: The counterpart of the reference's ``TRAINER_TRACES``.
CAPTURES = 0
#: Eager epochs run on a side stream before a capture: the kernels'
#: build and library load, cuBLAS's workspace and autograd's set-up
#: happen there and not inside the capture.
WARMUP_EPOCHS = 3


class EpochProgram:
    """One epoch of the scanned trainer's ``body`` (`:148-187`) as a
    function over static tensors on one device: the training step
    (``model.loss``, ``torch.autograd.grad``, ``AdamW.update``, each
    masked by ``active``), the validation loss under the fixed masks,
    the outlier F1, selection of the best checkpoint on (f1, -loss),
    early stopping, and the history row ``(train_loss, val_loss, f1,
    active)`` written at the device-side epoch counter. Without a
    validation batch it is ``train_noval`` (`:189-205`): ``active``
    stays true and only the training loss is kept.

    :meth:`run` loads a run's inputs into the static tensors (initial
    parameters, batches, scalar hypers, the generator's seed) and runs
    every epoch: on the card as replays of a CUDA graph captured at the
    first run (under ``torch.cuda.set_sync_debug_mode("error")``), on
    the CPU eagerly. :meth:`result` reads the run back."""

    def __init__(self, cfg: PeronaConfig, epochs: int, patience: int,
                 has_val: bool, device: torch.device):
        global CAPTURES
        CAPTURES += 1
        self.epochs, self.patience, self.has_val = epochs, patience, has_val
        self.device = device
        self.graph = None
        # the parameters are loaded at each run; the seeded draw only
        # keeps construction off the global generator
        self.model = PeronaModel(
            cfg, generator=torch.Generator().manual_seed(0)).to(device)
        self.params = dict(self.model.named_parameters())
        self.hypers = model_hypers(cfg, 0.0, 0.0, device)
        self.opt = AdamW(lr=self.hypers["lr"], b2=0.999,
                         weight_decay=self.hypers["weight_decay"],
                         clip_norm=5.0)
        self.state = self.opt.init(self.params)
        self.best = {k: torch.zeros_like(p.detach())
                     for k, p in self.params.items()}
        f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)
        i64 = lambda: torch.zeros((), dtype=torch.int64, device=device)
        self.best_f1, self.best_nl, self.ls_best = f32(), f32(), f32()
        self.best_e, self.ls_epoch, self.epoch = i64(), i64(), i64()
        self.stopped = torch.zeros((), dtype=torch.bool, device=device)
        self.history = torch.zeros((epochs, 4), dtype=torch.float32,
                                   device=device)
        self.gen = torch.Generator(device=device)
        self.val_draws = FixedDraws(device)
        self.tb = self.vb = None  # static copies, made at the first run

    # ------------------------------------------------------------- epoch
    def _epoch(self):
        params = self.params
        active = ~self.stopped
        tl, _ = self.model.loss(self.tb, self.gen, self.hypers)
        grads = torch.autograd.grad(tl, list(params.values()))
        with torch.no_grad():
            cur = {k: p.detach() for k, p in params.items()}
            new_p, new_s, _ = self.opt.update(dict(zip(params, grads)),
                                              self.state, cur)
            s = self.state
            new_m = _tree_where(active, new_s.m, s.m)
            new_v = _tree_where(active, new_s.v, s.v)
            step = torch.where(active, new_s.step, s.step)
            _assign(cur, _tree_where(active, new_p, cur))
            _assign(s.m, new_m)
            _assign(s.v, new_v)
            s.step.copy_(step)
            tl = tl.detach()
            if self.has_val:
                vl, f1 = self._validate()
                row = torch.stack([tl, vl, f1, active.to(torch.float32)])
            else:
                nan = torch.full((), math.nan, device=tl.device)
                row = torch.stack([tl, nan, nan, active.to(torch.float32)])
            self.history.index_copy_(0, self.epoch.view(1), row[None])
            self.epoch.add_(1)

    def _validate(self):
        """The validation loss and F1 at the updated parameters, then
        checkpoint selection and early stopping, as the reference."""
        active, epoch = ~self.stopped, self.epoch
        vl, _ = self.model.loss(self.vb, self.val_draws.rewind(),
                                self.hypers)
        logits = self.model(self.vb)["anom_logit"]
        f1 = _f1_outlier(logits, self.vb["anomaly"])
        # checkpoint selection: lexicographic (f1, -loss) max
        better = active & ((f1 > self.best_f1)
                           | ((f1 == self.best_f1) & (-vl > self.best_nl)))
        cur = {k: p.detach() for k, p in self.params.items()}
        _assign(self.best, _tree_where(better, cur, self.best))
        self.best_f1.copy_(torch.where(better, f1, self.best_f1))
        self.best_nl.copy_(torch.where(better, -vl, self.best_nl))
        self.best_e.copy_(torch.where(better, epoch, self.best_e))
        # early stopping on the validation total loss ("elif": the
        # patience check fires only on epochs that do not improve)
        improved = vl < self.ls_best
        stop_now = active & ~improved & (epoch - self.ls_epoch
                                         > self.patience)
        self.ls_best.copy_(torch.where(active & improved, vl, self.ls_best))
        self.ls_epoch.copy_(torch.where(active & improved, epoch,
                                        self.ls_epoch))
        self.stopped.copy_(self.stopped | stop_now)
        return vl, f1

    # --------------------------------------------------------------- run
    def _load(self, params0, tb, vb, hypers, seed):
        with torch.no_grad():
            _assign(self.params, params0)
            _assign(self.best, params0)
            for t in (*self.state.m.values(), *self.state.v.values(),
                      self.state.step, self.best_e, self.ls_epoch,
                      self.epoch, self.history):
                t.zero_()
            self.best_f1.fill_(-1.0)
            self.best_nl.fill_(-math.inf)
            self.ls_best.fill_(math.inf)
            self.stopped.fill_(False)
            for k, t in self.hypers.items():
                t.fill_(hypers[k])
            if self.tb is None:
                self.tb = {k: v.clone() for k, v in tb.items()}
                self.vb = None if vb is None else {
                    k: v.clone() for k, v in vb.items()}
            else:
                _assign(self.tb, tb)
                if vb is not None:
                    _assign(self.vb, vb)
        self.gen.manual_seed(seed + 1)

    def _capture(self):
        dev = self.device
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_EPOCHS):
                self.epoch.zero_()  # keeps the history index in range
                self._epoch()
        torch.cuda.current_stream(dev).wait_stream(side)
        # the graph itself is kept beside its executable, so that its
        # nodes can be counted (``raw_cuda_graph``)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # new training masks at every replay, from the seed set before
        # the run
        graph.register_generator_state(self.gen)
        with torch.cuda.graph(graph):
            self._epoch()
        graph.instantiate()
        self.graph = graph

    def run(self, params0: Dict[str, torch.Tensor],
            tb: Dict[str, torch.Tensor],
            vb: Optional[Dict[str, torch.Tensor]],
            hypers: Dict[str, float], seed: int):
        """Every epoch from ``params0`` (``{state_dict name: tensor}``
        on the device), with the scalar ``hypers`` (``model_hypers``'
        keys, as floats) and dropout masks from ``seed + 1``."""
        self._load(params0, tb, vb, hypers, seed)
        if self.device.type == "cpu":
            for _ in range(self.epochs):
                self._epoch()
            return
        if self.graph is None:
            self._capture()
            self._load(params0, tb, vb, hypers, seed)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(self.epochs):
                self.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def release(self) -> None:
        """Drop the graph (its memory pool goes back to the allocator
        once the program's tensors are gone too) and the static
        batches; the program is spent."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        self.tb = self.vb = None

    def result(self) -> Tuple[Dict[str, torch.Tensor], list, int]:
        """(selected parameters, history, best epoch) of the last run,
        read back once."""
        hist = self.history.cpu().numpy()
        history = []
        for e in range(self.epochs):
            tl, vl, f1, active = (float(x) for x in hist[e])
            if not active:
                break
            entry = {"epoch": e, "train_loss": tl}
            if self.has_val:
                entry.update(val_loss=vl, val_f1_outlier=f1)
            history.append(entry)
        src = self.best if self.has_val else self.params
        params = {k: p.detach().clone() for k, p in src.items()}
        best_epoch = (int(self.best_e.cpu()) if self.has_val
                      else self.epochs - 1)
        return params, history, best_epoch


@functools.lru_cache(maxsize=None)
def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream of every program's warm-up on ``device``: cuBLAS
    keeps a workspace for each stream it has run on, which a new stream
    a program would leave behind at every capture."""
    return torch.cuda.Stream(device)


def _shapes(batch):
    return None if batch is None else tuple(
        (k, tuple(v.shape), v.dtype) for k, v in batch.items())


@functools.lru_cache(maxsize=16)
def _program(cfg: PeronaConfig, epochs: int, patience: int, has_val: bool,
             shapes, device: torch.device) -> EpochProgram:
    """The cached epoch program of a canonical configuration: what
    ``_make_train_fn``'s ``lru_cache`` does for the reference."""
    del shapes  # a key only: the static batches come with the first run
    return EpochProgram(cfg, epochs, patience, has_val, device)


def train_perona(model: PeronaModel, train_batch: PeronaBatch,
                 val_batch: Optional[PeronaBatch] = None, *,
                 epochs: int = 100, lr: float = 3e-3,
                 weight_decay: float = 1e-4, patience: int = 25,
                 seed: int = 0, device="cuda",
                 cache: bool = True) -> TrainResult:
    """Device-resident training: the epoch as a CUDA graph replayed
    ``epochs`` times on the card (eagerly on the CPU). Trains ``model``
    from the parameters it holds, on ``device`` (the card unless
    ``"cpu"``), and leaves the selected parameters in it; they are also
    returned. ``epochs = 0`` returns the initial parameters, as the
    reference's zero-length scan does.

    With ``cache=False`` the program serves this run only: its graph,
    the graph's memory pool and its static tensors are released, and
    the allocator's cache emptied, before the return. That is for a
    one-off training in a long-lived process (the serve modes' model, a
    retrain on a growing store), where a cached program would keep its
    pool, tens of GB at some 30,000 rows, for the life of the
    process."""
    dev = resolve_device(device)
    # full float32 products, set before any capture: parity with the
    # float32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.to(dev)
    has_val = val_batch is not None
    live = dict(model.named_parameters())
    if epochs == 0:
        params = {k: p.detach().clone() for k, p in live.items()}
        return TrainResult(params=params, history=[],
                           best_epoch=0 if has_val else -1,
                           stats={"captured": 0, "replays": 0})
    tb = batch_to_torch(train_batch, dev)
    vb = batch_to_torch(val_batch, dev) if has_val else None
    captures = CAPTURES
    key = (canonical_config(model.cfg), epochs, patience, has_val)
    prog = (_program(*key, (_shapes(tb), _shapes(vb)), dev) if cache
            else EpochProgram(*key, dev))
    hypers = {k: float(v) for k, v in model_hypers(
        model.cfg, lr, weight_decay, "cpu").items()}
    prog.run({k: p.detach() for k, p in live.items()}, tb, vb, hypers,
             seed)
    params, history, best_epoch = prog.result()
    if not cache:
        prog.release()
        del prog, tb, vb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with torch.no_grad():
        _assign(live, params)
    return TrainResult(params=params, history=history,
                       best_epoch=best_epoch,
                       stats={"captured": CAPTURES - captures,
                              "replays": epochs})


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
