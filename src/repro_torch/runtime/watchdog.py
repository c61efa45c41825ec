"""Perona degradation watchdog (paper §III-C applied to a live cluster).

The PyTorch counterpart of ``repro/runtime/watchdog.py``.
It periodically re-fingerprints cluster nodes with the standardized
suite, pushes the new executions through the trained Perona model, and
flags nodes whose anomaly probability stays above threshold. A node is
flagged in a round only when a *quorum* of its new executions scores
anomalous, strikes reset on clean rounds, and a flag is *confirmed*
after ``confirm_runs`` consecutive anomalous rounds.

The rolling history lives in a :class:`repro_torch.fleet.store.
FingerprintStore` (compacted to ``history_per_chain`` rows per (node x
benchmark type) chain after every round when the watchdog owns the
store; a shared service store stays append-only); ``drift_report()``
exposes the store-backed per-node / per-aspect EWMAs of
:mod:`repro_torch.fleet.drift`. Scoring goes through one of two
interchangeable paths: one :class:`FingerprintEngine` call over the
round's context (the default), or a
:class:`repro_torch.fleet.FleetScoringService` when one is passed
(``service=``) — then the watchdog and the fleet serve entry point share
one micro-batched, stacked scoring path *and* one store.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.model import PeronaModel
from repro_torch.core.preprocess import Preprocessor
from repro_torch.fingerprint.frame import (BenchmarkFrame, FrameOrRecords,
                                           as_frame)
from repro_torch.fingerprint.records import BenchmarkExecution
from repro_torch.fleet.drift import drift_report
from repro_torch.fleet.store import FingerprintStore
from repro_torch.serving.engine import FingerprintEngine


@dataclasses.dataclass
class WatchdogDecision:
    node: str
    anomaly_prob: float  # mean probability over the round's executions
    flag_fraction: float  # share of the round's executions >= threshold
    flagged: bool
    confirmed: bool
    # running EWMA over the rounds this watchdog observed (same
    # recurrence as drift.ewma_series)
    anomaly_ewma: float = float("nan")


class PeronaWatchdog:
    def __init__(self, model: PeronaModel, params, preproc: Preprocessor,
                 threshold: float = 0.5, confirm_runs: int = 2,
                 quorum: float = 1 / 3,
                 engine: Optional[FingerprintEngine] = None,
                 history_per_chain: int = 64,
                 service=None, drift_alpha: float = 0.3, device="cuda"):
        self.model = model
        self.params = params
        self.preproc = preproc
        self.threshold = threshold
        self.quorum = quorum
        self.confirm_runs = confirm_runs
        self.drift_alpha = drift_alpha
        self.service = service
        if service is not None:
            # the service governs scoring context and store lifecycle;
            # reflect its cap so history_per_chain is never silently
            # different from what actually bounds the context
            self.history_per_chain = service.context_per_chain
            self.engine = engine  # unused unless provided explicitly
            self.store = service.store
        else:
            self.history_per_chain = history_per_chain
            self.engine = engine or FingerprintEngine(
                model, params, preproc, device=device)
            self.store = FingerprintStore()
        self._strikes: Dict[str, int] = {}
        # running per-node anomaly EWMA, updated incrementally with
        # each round's new scores
        self._ewma: Dict[str, float] = {}

    # ------------------------------------------------------------- history
    @property
    def history(self) -> List[BenchmarkExecution]:
        """Rolling context as records (compat view of the store)."""
        frame = self.store.frame
        return [] if frame is None else frame.to_records()

    @history.setter
    def history(self, data: FrameOrRecords) -> None:
        if self.service is not None:
            # the service's store may hold fleet-wide history owned by
            # other producers — never wipe it as a side effect
            if len(self.store):
                raise ValueError(
                    "the shared service store already holds history; "
                    "seed it through the service (seed_history) or "
                    "attach a fresh FleetScoringService instead")
            if len(data):
                self.service.seed_history(as_frame(data))
        else:
            self.store.clear()
            if len(data):
                self.store.append(as_frame(data))
        self._ewma.clear()

    @property
    def history_frame(self) -> Optional[BenchmarkFrame]:
        return self.store.frame

    # ------------------------------------------------------------- observe
    def observe(self, data: FrameOrRecords) -> List[WatchdogDecision]:
        """Score a new fingerprinting round (frame or records from the
        suite runner) in the context of previous rounds."""
        new = as_frame(data)
        if len(new) == 0:  # nothing observed: no scoring dispatch
            return []
        if self.service is not None:
            # the service's store is shared, so the watchdog does not
            # compact it — scoring context is capped by the service.
            # Drain requests other producers queued first, so this
            # round's quorum judges only the observed executions.
            self.service.flush()
            results = self.service.score_round(new)
            probs_of_node = {node: r.anomaly_prob
                             for node, r in results.items()}
        else:
            # context rule shared with the fleet service
            # (store.context_with_new): the newest history rows per
            # chain *as of before this round*, plus every new execution
            first_id = self.store.append(new)
            frame = self.store.frame
            sel, is_new = self.store.context_with_new(
                first_id, self.history_per_chain)
            if len(sel) == 0:  # empty round on an empty store
                return []
            res = self.engine.score(frame.select(sel))
            self.store.attach(sel[is_new], res.anomaly_prob[is_new],
                              res.codes[is_new])
            codes = frame.machine_code[sel[is_new]]
            probs = res.anomaly_prob[is_new]
            probs_of_node = {
                frame.machines[c]: probs[codes == c]
                for c in np.unique(codes)}
            self.store.compact(self.history_per_chain)

        decisions = []
        for node in sorted(probs_of_node):
            p_runs = probs_of_node[node]
            frac = float((p_runs >= self.threshold).mean())
            flagged = frac >= self.quorum
            if flagged:
                self._strikes[node] = self._strikes.get(node, 0) + 1
            else:
                self._strikes[node] = 0
            confirmed = self._strikes[node] >= self.confirm_runs
            decisions.append(WatchdogDecision(
                node=node, anomaly_prob=float(p_runs.mean()),
                flag_fraction=frac, flagged=flagged,
                confirmed=confirmed,
                anomaly_ewma=self._update_ewma(node, p_runs)))
        return decisions

    def _update_ewma(self, node: str, probs) -> float:
        """Fold a round's new scores into the node's running EWMA
        (same recurrence as drift.ewma_series, in observation order)."""
        acc = self._ewma.get(node)
        a = self.drift_alpha
        for p in probs:
            acc = float(p) if acc is None else (1 - a) * acc + a * float(p)
        if acc is None:
            return float("nan")
        self._ewma[node] = acc
        return acc

    # --------------------------------------------------------------- drift
    def drift_report(self, alpha: Optional[float] = None):
        """Per-node drift summaries over the stored, scored history
        (see :func:`repro_torch.fleet.drift.drift_report`)."""
        return drift_report(self.store,
                            self.drift_alpha if alpha is None else alpha)

    def excluded_nodes(self) -> List[str]:
        return [n for n, s in self._strikes.items()
                if s >= self.confirm_runs]
