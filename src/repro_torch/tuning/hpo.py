"""Hyperparameter search for the Perona model (paper Table II).

The PyTorch counterpart of ``repro/tuning/hpo.py``: a seeded random
search over the paper's space (attention heads, feature and edge
dropout, root weight, CBFL gamma/beta, learning rate, weight decay)
that returns the best trial under the trainer's checkpoint-selection
rank (validation outlier F1, total loss as tie-break).
:func:`sample_config` is the reference's, draw for draw, so both
packages run the same trials from one seed.

:func:`search` runs the trials in trial order on the graphed trainer
and counts its buckets, the two hypers that change the program
(``heads``, ``use_root_weight``), as the reference does; the scalar
hypers (dropouts, CBFL gamma/beta, learning rate, weight decay) are the
program's static tensors. Each bucket's trials share one cached epoch
program of ``core.trainer.train_perona`` (one CUDA graph capture on the
card): a trial copies its initial parameters and scalar hypers into the
program's static tensors, reseeds its generator and replays. The
reference stacks a bucket's trials into one ``jax.vmap``-ed program;
the port runs them one after another. Only the best trial keeps its
trained parameters and history.

Initial parameters come from the port's seeded initialisation
(``PeronaModel`` with a generator seeded ``seed + t``), or from an
``init_params(t, cfg)`` hook that returns the reference's nested tree
(``core.params``), so that a test can hand in the JAX package's
``PRNGKey(seed + t)`` parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import trainer as trainer_mod
from repro_torch.core.graph_data import PeronaBatch
from repro_torch.core.model import PeronaConfig, PeronaModel
from repro_torch.core.params import flat_params, params_from_numpy
from repro_torch.core.trainer import TrainResult, train_perona

# Table II search space
SPACE = {
    "heads": (1, 2, 4, 8),
    "feature_dropout": (0.0, 0.3),  # uniform range
    "edge_dropout": (0.0, 0.3),
    "use_root_weight": (True, False),
    "cbfl_gamma": (0.5, 4.0),
    "cbfl_beta": (0.9, 0.9999),
    "lr": (1e-4, 1e-2),  # log-uniform
    "weight_decay": (1e-6, 1e-3),  # log-uniform
}

@dataclasses.dataclass
class Trial:
    params: Dict
    val_loss: float
    val_f1: float = 0.0
    result: Optional[TrainResult] = None

    @property
    def score(self) -> Tuple[float, float]:
        """Rank key matching train_perona's checkpoint selection:
        max val outlier F1, then min val loss as tie-break."""
        return (self.val_f1, -self.val_loss)


@dataclasses.dataclass
class SearchStats:
    """What a search ran (asserted by the tests)."""

    n_buckets: int
    bucket_sizes: Dict[Tuple[int, bool], int]
    device_calls: int  # trial runs, each ``epochs`` replays
    trace_count: int  # epoch programs captured during this search


def sample_config(rng: np.random.Generator) -> Dict:
    return {
        "heads": int(rng.choice(SPACE["heads"])),
        "feature_dropout": float(rng.uniform(*SPACE["feature_dropout"])),
        "edge_dropout": float(rng.uniform(*SPACE["edge_dropout"])),
        "use_root_weight": bool(rng.choice(SPACE["use_root_weight"])),
        "cbfl_gamma": float(rng.uniform(*SPACE["cbfl_gamma"])),
        "cbfl_beta": float(1.0 - 10 ** rng.uniform(
            np.log10(1 - SPACE["cbfl_beta"][1]),
            np.log10(1 - SPACE["cbfl_beta"][0]))),
        "lr": float(10 ** rng.uniform(np.log10(SPACE["lr"][0]),
                                      np.log10(SPACE["lr"][1]))),
        "weight_decay": float(10 ** rng.uniform(
            np.log10(SPACE["weight_decay"][0]),
            np.log10(SPACE["weight_decay"][1]))),
    }


def _trial_cfg(base_cfg: PeronaConfig, hp: Dict) -> PeronaConfig:
    return dataclasses.replace(
        base_cfg, heads=hp["heads"],
        feature_dropout=hp["feature_dropout"],
        edge_dropout=hp["edge_dropout"],
        use_root_weight=hp["use_root_weight"],
        cbfl_gamma=hp["cbfl_gamma"], cbfl_beta=hp["cbfl_beta"])


def _sel_score(history) -> Tuple[float, float]:
    """Score of the checkpoint the trainer actually kept: the F1-best
    epoch (loss as tie-break), mirroring its selection rule."""
    sel = [(h.get("val_f1_outlier", 0.0), -h["val_loss"])
           for h in history if "val_loss" in h]
    return max(sel) if sel else (0.0, -float("inf"))


def _run_trial(train_fn: Callable, base_cfg: PeronaConfig, hp: Dict,
               t: int, train_batch, val_batch, *, epochs, seed, patience,
               device, init_params: Optional[Callable]) -> Trial:
    """Trial ``t``: its model from its initial parameters, trained with
    its hypers, scored by the checkpoint the trainer kept."""
    cfg = _trial_cfg(base_cfg, hp)
    model = PeronaModel(cfg,
                        generator=torch.Generator().manual_seed(seed + t))
    if init_params is not None:
        model.load_state_dict(flat_params(params_from_numpy(
            init_params(t, cfg))))
    res = train_fn(model, train_batch, val_batch, epochs=epochs,
                   lr=hp["lr"], weight_decay=hp["weight_decay"],
                   patience=patience, seed=seed + t, device=device)
    f1, neg_vl = _sel_score(res.history)
    return Trial(params=hp, val_loss=-neg_vl, val_f1=f1, result=res)


def search_sequential(base_cfg: PeronaConfig, train_batch: PeronaBatch,
                      val_batch: PeronaBatch, *, n_trials: int = 100,
                      epochs: int = 60, seed: int = 0,
                      patience: int = 25, verbose: bool = False,
                      train_fn: Optional[Callable] = None, device="cuda",
                      init_params: Optional[Callable] = None
                      ) -> Tuple[Trial, List[Trial]]:
    """One training per trial, in trial order. ``train_fn`` defaults to
    the graphed trainer; pass ``trainer.train_perona_reference`` for the
    host loop (the baseline)."""
    train_fn = train_perona if train_fn is None else train_fn
    rng = np.random.default_rng(seed)
    trials: List[Trial] = []
    best: Optional[Trial] = None
    for t in range(n_trials):
        hp = sample_config(rng)
        trial = _run_trial(train_fn, base_cfg, hp, t, train_batch,
                           val_batch, epochs=epochs, seed=seed,
                           patience=patience, device=device,
                           init_params=init_params)
        trials.append(trial)
        # only the best trial keeps its result, to bound memory; the
        # earlier trial wins a tie
        if best is None or trial.score > best.score:
            if best is not None:
                best.result = None
            best = trial
        else:
            trial.result = None
        if verbose:
            print(f"[hpo {t + 1}/{n_trials}] f1={trial.val_f1:.4f} "
                  f"val={trial.val_loss:.4f} best_f1={best.val_f1:.4f} "
                  f"{hp}")
    return best, trials


def search(base_cfg: PeronaConfig, train_batch: PeronaBatch,
           val_batch: PeronaBatch, *, n_trials: int = 100,
           epochs: int = 60, seed: int = 0, patience: int = 25,
           verbose: bool = False, return_stats: bool = False,
           device="cuda", init_params: Optional[Callable] = None):
    """Returns (best trial with trained result, all trials) — plus a
    :class:`SearchStats` when ``return_stats`` is set. The trials are
    :func:`search_sequential`'s on the graphed trainer, whose cached
    programs make one capture per (heads, use_root_weight) bucket."""
    captures = trainer_mod.CAPTURES
    best, trials = search_sequential(
        base_cfg, train_batch, val_batch, n_trials=n_trials, epochs=epochs,
        seed=seed, patience=patience, verbose=verbose, device=device,
        init_params=init_params)
    if not return_stats:
        return best, trials
    sizes: Dict[Tuple[int, bool], int] = {}
    for trial in trials:
        key = (trial.params["heads"], trial.params["use_root_weight"])
        sizes[key] = sizes.get(key, 0) + 1
    stats = SearchStats(n_buckets=len(sizes), bucket_sizes=sizes,
                        device_calls=len(trials),
                        trace_count=trainer_mod.CAPTURES - captures)
    return best, trials, stats
