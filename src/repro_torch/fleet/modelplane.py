"""Model management plane: versioned checkpoints, canary gates,
zero-downtime promote/rollback on the live fleet service.

The PyTorch counterpart of ``repro/fleet/modelplane.py``: the same
registry file (``registry.json``, ``checkpoints/step_<v>.npz``), so a
registry written by either package loads in the other, and the same
lifecycle, counters and tracer instants. Parameters are the port's
``{state_dict name: tensor}`` dicts; the default retrain trains a
fresh model (see :meth:`ModelPlane._default_retrain`).

A Perona deployment is long-lived: the ingestion daemon streams
telemetry for weeks while the model it scores with ages. This module
closes the loop between the drift analytics (which *detect* that the
fleet has moved away from the fingerprinted baseline) and the trainer
(which can produce a fresh model from the durable store history) — by
making the scoring parameters a *managed, versioned artifact* instead
of a constructor argument.

Two layers:

- :class:`ModelRegistry` — versioned parameter checkpoints on top of
  :class:`repro_torch.checkpointing.manager.CheckpointManager` (atomic
  ``step_<v>.npz`` writes, keep-last-K GC with the incumbent and its
  predecessor pinned) plus a crash-safe ``registry.json`` (tmp file +
  ``os.replace``, the same durability idiom as ``store.atomic_savez``)
  recording each version's source, lifecycle status
  (candidate -> canary -> incumbent / rejected / rolled_back ->
  retired), tags and canary verdict.

- :class:`ModelPlane` — the live controller. It hooks the
  :class:`~repro_torch.fleet.ingest.IngestionDaemon`'s flush boundary and
  drives a three-phase lifecycle:

  *canary*: a submitted candidate is shadow-scored side by side with
  the incumbent on the daemon's real micro-batches
  (``service.rescore(first_id, params=candidate)`` — the exact flush
  path, store untouched) and gated on score divergence vs the
  incumbent's attached scores, NaN/Inf checks over every output head,
  false-positive rate on known-clean nodes, and a latency budget
  against the service's per-flush wall-clock histogram. The verdict is
  recorded in the registry either way.

  *promote*: the candidate's sharded programs are warmed through every
  stacked shape seen so far (``service.warm``) *before*
  ``service.swap_params`` flips the reference under the service lock —
  the swap lands at a flush boundary, in-flight submissions are never
  dropped or double-scored, and the first post-swap flush pays no
  compile.

  *watch*: for a bounded number of flushes after the swap, the plane
  monitors the candidate's live output (NaN/Inf, or flush-mean anomaly
  regressing past the steady-state EWMA baseline plus a MAD-derived
  noise floor — the same :class:`~repro_torch.fleet.drift.EwmaMean` +
  ``obs.regress`` noise machinery as the perf gate). A regression
  triggers automatic rollback: parameters swap back, every row scored
  by the bad candidate is re-scored with the incumbent through the
  flush path (``rescore(attach=True)``) so the store ends bit-identical
  to a run that never promoted, and the in-flight flush's results are
  repaired in place before the daemon folds them into drift state.

  *steady*: flush-mean anomaly folds into the health baseline, and the
  drift analytics are polled — nodes degrading for
  ``drift_flag_flushes`` consecutive flushes trigger one
  retrain-on-store-history -> canary -> promote episode
  (``retrain_fn``, defaulting to ``build_graphs`` + ``train_perona``
  of a fresh model over the stored frame).

Every transition is observable: ``modelplane.*`` counters in the
metrics registry and ``CAT_PLANE`` tracer instants (canary_start /
canary_pass / canary_fail / promote / rollback / retrain) in the
daemon's clock domain, so promote/rollback markers line up with flush
spans on the exported timeline.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.core.graph_data import build_graphs
from repro_torch.core.model import PeronaModel
from repro_torch.core.trainer import train_perona
from repro_torch.fleet.drift import EwmaMean, degrading_nodes
from repro_torch.obs import metrics as obs_metrics
# a module, not its function: importing ``obs.regress`` first imports
# this module through ``fleet/__init__``
from repro_torch.obs import regress as obs_regress
from repro_torch.obs import trace as obs_trace

STATUS_CANDIDATE = "candidate"
STATUS_CANARY = "canary"
STATUS_REJECTED = "rejected"
STATUS_INCUMBENT = "incumbent"
STATUS_ROLLED_BACK = "rolled_back"
STATUS_RETIRED = "retired"

PHASE_STEADY = "steady"
PHASE_CANARY = "canary"
PHASE_WATCH = "watch"


class ModelRegistry:
    """Versioned parameter store with a crash-safe JSON index.

    Checkpoints live under ``<dir>/checkpoints`` (one ``step_<v>.npz``
    per version via :class:`CheckpointManager`, synchronous writes so a
    returned version id is always durable); lifecycle state lives in
    ``<dir>/registry.json``, rewritten atomically on every mutation.
    The current incumbent and its predecessor are pinned against
    keep-last GC — rollback must always find both on disk."""

    def __init__(self, directory, keep_last: int = 8):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manager = CheckpointManager(
            self.dir / "checkpoints", keep_last=keep_last,
            async_save=False)
        self.path = self.dir / "registry.json"
        if self.path.exists():
            self._state = json.loads(self.path.read_text())
        else:
            self._state = {"versions": {}, "incumbent": None,
                           "previous": None, "next_version": 1}
        self._repin()

    # ------------------------------------------------------- persistence
    def _write(self) -> None:
        tmp = self.dir / ".tmp_registry.json"
        tmp.write_text(json.dumps(self._state, indent=2,
                                  sort_keys=True))
        os.replace(tmp, self.path)

    def _repin(self) -> None:
        self.manager.pinned = {
            v for v in (self._state["incumbent"],
                        self._state["previous"]) if v is not None}

    def _entry(self, vid: int) -> Dict:
        try:
            return self._state["versions"][str(int(vid))]
        except KeyError:
            raise KeyError(f"unknown model version {vid}") from None

    # ------------------------------------------------------------ writes
    def save_version(self, params, *, source: str = "manual",
                     extra: Optional[Dict] = None) -> int:
        """Checkpoint ``params`` as a new version (status: candidate);
        returns the version id. The write is synchronous and atomic —
        when this returns, the version is durable."""
        vid = int(self._state["next_version"])
        self._state["next_version"] = vid + 1
        self.manager.save(vid, params,
                          extra={"source": source, **(extra or {})})
        self._state["versions"][str(vid)] = {
            "version": vid, "source": source,
            "status": STATUS_CANDIDATE, "tags": [], "verdict": None,
            "extra": dict(extra or {})}
        self._write()
        return vid

    def set_status(self, vid: int, status: str) -> None:
        self._entry(vid)["status"] = status
        self._write()

    def tag(self, vid: int, tag: str) -> None:
        tags = self._entry(vid)["tags"]
        if tag not in tags:
            tags.append(tag)
            self._write()

    def record_verdict(self, vid: int, verdict: Dict) -> None:
        """Attach a canary verdict (criteria + pass/fail) to a
        version — the audit trail of why a candidate was (not)
        promoted."""
        self._entry(vid)["verdict"] = verdict
        self._write()

    def set_incumbent(self, vid: int) -> None:
        """Make ``vid`` the incumbent; the old incumbent becomes
        ``previous`` (status retired) and both are pinned against
        checkpoint GC."""
        self._entry(vid)  # must exist
        old = self._state["incumbent"]
        if old is not None and int(old) != int(vid):
            self._state["previous"] = int(old)
            self._entry(old)["status"] = STATUS_RETIRED
        self._state["incumbent"] = int(vid)
        self._entry(vid)["status"] = STATUS_INCUMBENT
        self._repin()
        self._write()

    # ------------------------------------------------------------- reads
    @property
    def incumbent(self) -> Optional[int]:
        v = self._state["incumbent"]
        return None if v is None else int(v)

    @property
    def previous(self) -> Optional[int]:
        v = self._state["previous"]
        return None if v is None else int(v)

    def entry(self, vid: int) -> Dict:
        return dict(self._entry(vid))

    def list_versions(self) -> List[Dict]:
        return [dict(e) for _, e in sorted(
            self._state["versions"].items(), key=lambda kv: int(kv[0]))]

    def load_version(self, template, vid: Optional[int] = None):
        """Restore a version's parameters into the structure of
        ``template`` (default: the incumbent), each on its template
        tensor's device: the service's ``{state_dict name: tensor}``
        gives the same dict back."""
        if vid is None:
            vid = self.incumbent
        if vid is None:
            raise RuntimeError("registry has no incumbent to load")
        tree, _ = self.manager.restore(template, step=int(vid))
        if tree is None:
            raise FileNotFoundError(
                f"checkpoint for version {vid} not on disk")
        return tree


class ModelPlane:
    """Live model lifecycle controller over a
    :class:`~repro_torch.fleet.service.FleetScoringService` (and optionally
    the :class:`~repro_torch.fleet.ingest.IngestionDaemon` that drives it).
    See the module docstring for the canary -> promote -> watch ->
    steady lifecycle."""

    def __init__(self, service,
                 registry: Union[ModelRegistry, str, "os.PathLike"], *,
                 daemon=None,
                 canary_flushes: int = 2,
                 watch_flushes: int = 3,
                 divergence_budget: float = 1e-3,
                 fp_budget: float = 0.25,
                 fp_threshold: float = 0.5,
                 latency_budget: float = 3.0,
                 health_alpha: float = 0.3,
                 health_window: int = 64,
                 min_health_shift: float = 0.15,
                 drift_flag_flushes: int = 3,
                 drift_ewma_threshold: float = 0.5,
                 drift_min_scored: int = 3,
                 retrain_fn: Optional[Callable] = None,
                 retrain_epochs: int = 40,
                 retrain_seed: int = 0,
                 clean_nodes: Optional[Sequence[str]] = None):
        self.service = service
        self.registry = (registry if isinstance(registry, ModelRegistry)
                         else ModelRegistry(registry))
        self.canary_flushes = canary_flushes
        self.watch_flushes = watch_flushes
        self.divergence_budget = divergence_budget
        self.fp_budget = fp_budget
        self.fp_threshold = fp_threshold
        self.latency_budget = latency_budget
        self.min_health_shift = min_health_shift
        self.drift_flag_flushes = drift_flag_flushes
        self.drift_ewma_threshold = drift_ewma_threshold
        self.drift_min_scored = drift_min_scored
        self.retrain_fn = retrain_fn
        self.retrain_epochs = retrain_epochs
        self.retrain_seed = retrain_seed
        self.clean_nodes = (None if clean_nodes is None
                            else set(clean_nodes))

        self.phase = PHASE_STEADY
        self._incumbent_params = None
        self._candidate: Optional[Dict] = None  # canary in flight
        self._watch: Optional[Dict] = None  # post-promote watch
        self._health = EwmaMean(health_alpha)
        self._health_values: collections.deque = collections.deque(
            maxlen=health_window)
        self._flag_streak = 0
        self._retrained_episode = False

        self._promotions = 0
        self._rollbacks = 0
        self._canary_pass = 0
        self._canary_fail = 0
        self._retrains = 0
        self._shadow_flushes = 0
        self._repaired_rows = 0
        reg = obs_metrics.registry()
        self._m_promotions = reg.counter("modelplane.promotions")
        self._m_rollbacks = reg.counter("modelplane.rollbacks")
        self._m_canary = {
            "pass": reg.counter("modelplane.canary", verdict="pass"),
            "fail": reg.counter("modelplane.canary", verdict="fail")}
        self._m_retrains = reg.counter("modelplane.retrains")
        self._m_shadow = reg.counter("modelplane.shadow_flushes")
        self._m_repaired = reg.counter("modelplane.repaired_rows")

        self.daemon = None
        self.tracer = obs_trace.tracer()
        if daemon is not None:
            self.attach(daemon)

    # -------------------------------------------------------------- wiring
    def attach(self, daemon) -> None:
        """Hook the daemon's flush boundary; plane instants move into
        the daemon's clock domain so they line up with flush spans on
        the exported timeline."""
        self.daemon = daemon
        self.tracer = daemon.tracer
        daemon.add_flush_hook(self.on_flush)

    def _instant(self, name: str,
                 args: Optional[Dict[str, object]] = None) -> None:
        ts = self.daemon.now if self.daemon is not None else None
        self.tracer.instant(name, obs_trace.CAT_PLANE, args=args,
                            ts=ts)

    # ---------------------------------------------------------- lifecycle
    def bootstrap(self, params=None, *,
                  source: str = "bootstrap") -> int:
        """Register the service's current parameters (or ``params``)
        as version 1 / the incumbent. Call once before streaming."""
        if params is None:
            params = self.service.params
        vid = self.registry.save_version(params, source=source)
        self.registry.set_incumbent(vid)
        if params is not self.service.params:
            self.service.swap_params(params)
        self._incumbent_params = params
        return vid

    def submit_candidate(self, params, *, source: str = "manual",
                         extra: Optional[Dict] = None) -> int:
        """Checkpoint ``params`` as a new version and start its canary
        on the next flushes. One candidate at a time: raises if a
        canary or post-promote watch is already in flight."""
        vid = self.registry.save_version(params, source=source,
                                         extra=extra)
        self._begin_canary(vid, params)
        return vid

    def promote(self, vid: int, *, force: bool = False) -> int:
        """Promote a registered version. Without ``force`` the version
        (re-)enters the canary gate and promotes only on a pass; with
        ``force`` it skips straight past the gate to the swap — the
        post-promote watch still applies, so a bad forced promote is
        rolled back automatically."""
        params = self._params_for(vid)
        if force:
            if self._watch is not None:
                self._commit_watch()
            if self._candidate is not None:
                self.registry.set_status(self._candidate["vid"],
                                         STATUS_CANDIDATE)
                self._candidate = None
                self.phase = PHASE_STEADY
            self._do_promote(vid, params, forced=True)
        else:
            self._begin_canary(vid, params)
        return vid

    def rollback(self) -> Optional[int]:
        """Manual rollback. During a post-promote watch this behaves
        exactly like an automatic health rollback (store repaired);
        otherwise the registry's ``previous`` version is restored and
        swapped in. Returns the version rolled back to."""
        if self._watch is not None:
            vid = self._watch["old_vid"]
            self._rollback_watch({}, reason="manual")
            return vid
        prev = self.registry.previous
        if prev is None:
            raise RuntimeError("no previous version to roll back to")
        cur = self.registry.incumbent
        params = self.registry.load_version(self.service.params, prev)
        self.service.warm(params)
        self.service.swap_params(params)
        self.registry.set_incumbent(prev)
        if cur is not None:
            self.registry.set_status(cur, STATUS_ROLLED_BACK)
        self._incumbent_params = params
        self._rollbacks += 1
        self._m_rollbacks.inc()
        self._instant("modelplane.rollback",
                      args={"version": cur, "to": prev,
                            "reason": "manual"})
        return prev

    def _params_for(self, vid: int):
        if self._candidate is not None and self._candidate["vid"] == vid:
            return self._candidate["params"]
        return self.registry.load_version(self.service.params, vid)

    def _begin_canary(self, vid: int, params) -> None:
        if self.phase != PHASE_STEADY:
            raise RuntimeError(
                f"cannot start a canary while in phase {self.phase!r}")
        self.registry.set_status(vid, STATUS_CANARY)
        self._candidate = {
            "vid": vid, "params": params, "flushes": 0,
            "div_max": 0.0, "div_sum": 0.0, "div_n": 0,
            "nonfinite": 0, "fp": 0, "fp_n": 0, "lat_max": 0.0}
        self.phase = PHASE_CANARY
        self._instant("modelplane.canary_start",
                      args={"version": vid})

    # -------------------------------------------------------- flush hook
    def on_flush(self, results: Dict[str, object],
                 trigger: str) -> None:
        """Daemon flush hook — runs under the daemon lock after
        scoring, *before* results are folded into drift state, so a
        rollback can repair the flush's results in place."""
        if not results:
            return
        if self.phase == PHASE_CANARY:
            self._canary_step(results)
            # these results were scored by the incumbent either way
            self._fold_health(results)
        elif self.phase == PHASE_WATCH:
            self._watch_step(results)
        else:
            self._fold_health(results)
            self._check_drift()

    # ------------------------------------------------------------- canary
    def _canary_step(self, results) -> None:
        c = self._candidate
        row_mins = [int(r.row_ids.min()) for r in results.values()
                    if len(r.row_ids)]
        if not row_mins:
            return
        first_id = min(row_mins)
        t0 = time.perf_counter()
        shadow = self.service.rescore(first_id, params=c["params"],
                                      attach=False)
        shadow_wall = time.perf_counter() - t0
        self._shadow_flushes += 1
        self._m_shadow.inc()
        clean = self._clean_set(results)
        for node, cur in results.items():
            sh = shadow.get(node)
            if sh is None or len(cur.row_ids) == 0:
                continue
            sel = np.isin(sh.row_ids, cur.row_ids)
            prob = np.asarray(sh.anomaly_prob, np.float64)[sel]
            div = np.abs(prob
                         - np.asarray(cur.anomaly_prob, np.float64))
            if len(div):
                # NaN-poisoned divergence counts as maximal, not as
                # silently-ignored
                c["div_max"] = max(
                    c["div_max"],
                    float(np.nanmax(div)) if np.isfinite(div).any()
                    else float("inf"))
                c["div_sum"] += float(np.nansum(div))
                c["div_n"] += int(len(div))
            c["nonfinite"] += int(
                (~np.isfinite(prob)).sum()
                + (~np.isfinite(np.asarray(sh.codes)[sel])).sum()
                + (~np.isfinite(np.asarray(sh.type_logits)[sel])).sum())
            if node in clean and len(prob):
                c["fp"] += int((prob > self.fp_threshold).sum())
                c["fp_n"] += int(len(prob))
        base = self.service._h_flush.quantile(0.5)
        if np.isfinite(base) and base > 0:
            c["lat_max"] = max(c["lat_max"], shadow_wall / base)
        c["flushes"] += 1
        if c["flushes"] >= self.canary_flushes:
            self._finish_canary()

    def _clean_set(self, results) -> set:
        if self.clean_nodes is not None:
            return self.clean_nodes
        if self.daemon is not None:
            flagged = set(degrading_nodes(
                self.daemon.drift.report(),
                ewma_threshold=self.drift_ewma_threshold,
                min_scored=self.drift_min_scored))
            return set(results) - flagged
        return set(results)

    def _finish_canary(self) -> None:
        c, self._candidate = self._candidate, None
        fp_rate = c["fp"] / max(c["fp_n"], 1)
        checks = {
            "divergence": c["div_max"] <= self.divergence_budget,
            "finite": c["nonfinite"] == 0,
            "false_positives": fp_rate <= self.fp_budget,
            "latency": c["lat_max"] <= self.latency_budget,
        }
        verdict = {
            "passed": all(checks.values()),
            "failed_checks": sorted(k for k, ok in checks.items()
                                    if not ok),
            "flushes": c["flushes"],
            "divergence_max": c["div_max"],
            "divergence_mean": c["div_sum"] / max(c["div_n"], 1),
            "nonfinite_outputs": c["nonfinite"],
            "false_positive_rate": fp_rate,
            "latency_ratio_max": c["lat_max"],
        }
        self.registry.record_verdict(c["vid"], verdict)
        if verdict["passed"]:
            self._canary_pass += 1
            self._m_canary["pass"].inc()
            self.phase = PHASE_STEADY  # _do_promote re-enters watch
            self._instant("modelplane.canary_pass",
                          args={"version": c["vid"]})
            self._do_promote(c["vid"], c["params"])
        else:
            self._canary_fail += 1
            self._m_canary["fail"].inc()
            self.registry.set_status(c["vid"], STATUS_REJECTED)
            self.phase = PHASE_STEADY
            self._instant("modelplane.canary_fail",
                          args={"version": c["vid"],
                                "failed": verdict["failed_checks"]})

    # ---------------------------------------------------- promote / watch
    def _do_promote(self, vid: int, params, *,
                    forced: bool = False) -> None:
        old_vid = self.registry.incumbent
        old_params = self._incumbent_params
        if old_params is None:
            old_params = self.service.params
        warmed = self.service.warm(params)  # compile OFF the hot path
        self.service.swap_params(params)
        self.registry.set_incumbent(vid)
        self._watch = {"vid": vid, "params": params,
                       "old_vid": old_vid, "old_params": old_params,
                       "first_id": self.service.store.next_id,
                       "flushes": 0}
        self.phase = PHASE_WATCH
        self._promotions += 1
        self._m_promotions.inc()
        self._instant("modelplane.promote",
                      args={"version": vid, "from": old_vid,
                            "warmed_shapes": warmed,
                            "forced": forced})

    def _watch_step(self, results) -> None:
        w = self._watch
        w["flushes"] += 1
        probs = [np.asarray(r.anomaly_prob, np.float64)
                 for r in results.values() if len(r.anomaly_prob)]
        flat = (np.concatenate(probs) if probs
                else np.empty(0, np.float64))
        nonfinite = bool(len(flat)) and not bool(
            np.isfinite(flat).all())
        mean = float(flat.mean()) if len(flat) else float("nan")
        baseline = self._health.ewma
        regressed = (not nonfinite and baseline is not None
                     and np.isfinite(mean)
                     and mean > baseline + self._health_floor())
        if nonfinite or regressed:
            self._rollback_watch(
                results,
                reason="nonfinite" if nonfinite else "health")
            self._fold_health(results)  # repaired = incumbent-scored
            return
        if w["flushes"] >= self.watch_flushes:
            self._commit_watch()
            self._fold_health(results)
        # mid-watch flushes are compared against the baseline but not
        # folded into it — a slow regression must not normalize itself

    def _health_floor(self) -> float:
        """Absolute allowed shift: the MAD-based robust scatter of the
        recent flush-mean window (``obs.regress`` noise machinery),
        floored at ``min_health_shift``."""
        vals = np.asarray(self._health_values, np.float64)
        floor = 0.0
        if len(vals) >= 2:
            med = float(np.median(vals))
            floor = obs_regress.series_noise_pct(vals) / 100.0 * abs(med)
        return max(floor, self.min_health_shift)

    def _fold_health(self, results) -> None:
        probs = [np.asarray(r.anomaly_prob, np.float64)
                 for r in results.values() if len(r.anomaly_prob)]
        if not probs:
            return
        flat = np.concatenate(probs)
        flat = flat[np.isfinite(flat)]
        if len(flat):
            m = float(flat.mean())
            self._health.update(m)
            self._health_values.append(m)

    def _commit_watch(self) -> None:
        w, self._watch = self._watch, None
        self.phase = PHASE_STEADY
        self._incumbent_params = w["params"]
        # fresh model, fresh drift-retrain episode
        self._flag_streak = 0
        self._retrained_episode = False
        self._instant("modelplane.watch_pass",
                      args={"version": w["vid"],
                            "flushes": w["flushes"]})

    def _rollback_watch(self, results, *, reason: str) -> None:
        w, self._watch = self._watch, None
        old = w["old_params"]
        self.service.swap_params(old)
        # repair: every row the candidate scored is re-scored by the
        # incumbent through the exact flush path; the store ends
        # bit-identical to a run that never promoted
        repaired = self.service.rescore(w["first_id"], params=old,
                                        attach=True)
        n_rep = sum(len(r.row_ids) for r in repaired.values())
        for node, cur in list(results.items()):
            rep = repaired.get(node)
            if rep is None:
                continue
            sel = np.isin(rep.row_ids, cur.row_ids)
            results[node] = dataclasses.replace(
                cur,
                anomaly_prob=np.asarray(rep.anomaly_prob)[sel],
                type_logits=np.asarray(rep.type_logits)[sel],
                codes=np.asarray(rep.codes)[sel],
                row_ids=np.asarray(rep.row_ids)[sel])
        if w["old_vid"] is not None:
            self.registry.set_incumbent(w["old_vid"])
        self.registry.set_status(w["vid"], STATUS_ROLLED_BACK)
        self._incumbent_params = old
        self.phase = PHASE_STEADY
        self._rollbacks += 1
        self._m_rollbacks.inc()
        self._repaired_rows += n_rep
        self._m_repaired.inc(n_rep)
        self._instant("modelplane.rollback",
                      args={"version": w["vid"], "to": w["old_vid"],
                            "reason": reason,
                            "after_flushes": w["flushes"],
                            "repaired_rows": n_rep})

    # ------------------------------------------------------ drift retrain
    def _check_drift(self) -> None:
        report = (self.daemon.drift.report()
                  if self.daemon is not None else {})
        flagged = degrading_nodes(
            report, ewma_threshold=self.drift_ewma_threshold,
            min_scored=self.drift_min_scored)
        if flagged:
            self._flag_streak += 1
        else:
            self._flag_streak = 0
            self._retrained_episode = False
        if (self._flag_streak < self.drift_flag_flushes
                or self._retrained_episode):
            return
        # one retrain episode per sustained degradation: re-arm only
        # after the fleet goes clean (or a promote commits)
        self._retrained_episode = True
        self._retrains += 1
        self._m_retrains.inc()
        nodes = sorted(flagged)
        self._instant("modelplane.retrain", args={"nodes": nodes})
        fn = self.retrain_fn or self._default_retrain
        params = fn(self.service)
        if params is not None:
            self.submit_candidate(params, source="drift-retrain",
                                  extra={"nodes": nodes})

    def _default_retrain(self, service):
        """Retrain on the durable store history (`build_graphs` over
        the stored frame, labels from its stress column) on the
        service's device. The reference trains from
        ``model.init(PRNGKey(retrain_seed))``; the port's
        ``train_perona`` trains the model it is given from the
        parameters it holds, and writes the selected ones into it, so
        the retrain trains a fresh model seeded by ``retrain_seed`` and
        leaves ``service.model`` and ``service.params`` untouched.

        The store grows between episodes, so each retrain trains at a
        new batch shape: its program is not cached, and the card's
        memory goes back to what it was before the retrain (less the
        returned parameters)."""
        frame = service.store.frame
        if frame is None or len(frame) < 8:
            return None
        batch = build_graphs(frame, service.preproc)
        model = PeronaModel(service.model.cfg,
                            generator=torch.Generator().manual_seed(
                                self.retrain_seed))
        res = train_perona(model, batch, epochs=self.retrain_epochs,
                           seed=self.retrain_seed,
                           device=service.scorer.devices[0], cache=False)
        return res.params

    # -------------------------------------------------------------- stats
    def status(self) -> Dict[str, object]:
        reg = self.registry
        if self._candidate is not None:
            candidate = self._candidate["vid"]
        elif self._watch is not None:
            candidate = self._watch["vid"]
        else:
            candidate = None
        return {
            "phase": self.phase,
            "incumbent": reg.incumbent,
            "previous": reg.previous,
            "candidate": candidate,
            "versions": len(reg.list_versions()),
            "promotions": self._promotions,
            "rollbacks": self._rollbacks,
            "canary_pass": self._canary_pass,
            "canary_fail": self._canary_fail,
            "retrains": self._retrains,
            "shadow_flushes": self._shadow_flushes,
            "repaired_rows": self._repaired_rows,
            "health_ewma": (float(self._health.ewma)
                            if self._health.ewma is not None
                            else None),
        }
