"""Fleet scoring service: micro-batched, store-backed, stacked.

The PyTorch counterpart of ``repro/fleet/service.py``.
``FleetScoringService`` is the request front-end of the fleet
subsystem: per-node scoring requests (``submit``) are coalesced into
shape-bucketed micro-batches (power-of-two row buckets via
``common.bucketing.next_pow2``, the ``FingerprintEngine`` policy) and
dispatched as ONE stacked call per (bucket, flush) through
:class:`repro_torch.fleet.shard.ShardedScorer`, which scores the stack
as one flat graph on the card — instead of one device dispatch per
request. Context assembly ("previous executions of this node", paper
§III-C) is a pure array gather from the
:class:`repro_torch.fleet.store.FingerprintStore` feature cache; scored
rows are appended back to the store, which makes the history durable
(``store.save``) and feeds the drift analytics
(``repro_torch.fleet.drift``).

Flush flow:

1. all pending request rows are preprocessed once (one vectorized
   §III-B pass) and appended to the store with their feature columns;
2. per node, the scoring context (the newest ``context_per_chain``
   rows of each of the node's chains *as of before the round*, plus
   every new row) is gathered from the store and padded to its row
   bucket;
3. requests sharing a bucket are stacked (request axis padded to a
   power of two divisible by the device count) and scored in one
   stacked dispatch;
4. new-row scores are attached to the store and returned per node.

The default context depth exploits the model's bounded receptive
field: the §III-C graph chains executions to their P=3 immediate
predecessors, the TransformerConv aggregates 1 hop and the TAGConv
``tag_hops`` hops, so a new execution's score depends on at most
``P * max(1, tag_hops)`` preceding chain rows. With streaming rounds
(timestamps after the stored history) the minimal context therefore
produces the scores of rescoring the full history (asserted in
``tests/test_torch_fleet.py``) at a fraction of the compute.

The service runs on the card unless ``device="cpu"``; ``devices=`` (a
list) splits each stacked dispatch's request axis over several
devices. A failed dispatch is retried on the same devices (never on
another device or route); a terminal failure raises to the caller.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.bucketing import next_pow2
from repro_torch.common.mesh import stack_padded
from repro_torch.common.rng import STREAM_RETRY, folded_generator
from repro_torch.core.graph_data import P_PREDECESSORS, chain_structure
from repro_torch.core.model import PeronaModel
from repro_torch.core.preprocess import Preprocessor
from repro_torch.fingerprint.frame import (FrameOrRecords, as_frame,
                                           concat_frames)
from repro_torch.fleet.shard import ShardedScorer
from repro_torch.fleet.store import FEATURE_KEYS, FingerprintStore
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import (MIN_BUCKET, assemble_inputs,
                                        prepare_features)


@dataclasses.dataclass
class FleetResult:
    """Scores for one node's new executions (chronological order)."""

    node: str
    anomaly_prob: np.ndarray  # (n_new,)
    type_logits: np.ndarray  # (n_new, T)
    codes: np.ndarray  # (n_new, K)
    row_ids: np.ndarray  # (n_new,) global store row ids
    context_row_ids: np.ndarray  # history rows scored alongside
    bucket: int  # row bucket the request padded to

    @property
    def n_context(self) -> int:
        return len(self.context_row_ids)


class FleetScoringService:
    """Accepts per-node requests, flushes shape-bucketed micro-batches
    through one stacked dispatch per bucket, persists to the store.

    ``params``: the reference's nested tree or ``state_dict`` names
    (:func:`repro_torch.core.params.flat_params`), on any device; each
    dispatch places them on the scoring device."""

    def __init__(self, model: PeronaModel, params,
                 preproc: Preprocessor, *,
                 store: Optional[FingerprintStore] = None,
                 context_per_chain: Optional[int] = None,
                 min_bucket: int = MIN_BUCKET,
                 device="cuda",
                 devices: Optional[Sequence] = None,
                 on_invalid: str = "quarantine",
                 dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 retry_seed: int = 0):
        self.model = model
        self.params = params
        self.preproc = preproc
        self.store = store if store is not None else FingerprintStore()
        # None -> the model's exact receptive field (see module doc)
        self.context_per_chain = (
            context_per_chain if context_per_chain is not None
            else P_PREDECESSORS * max(1, model.cfg.tag_hops))
        self.min_bucket = min_bucket
        if on_invalid not in ("quarantine", "raise", "off"):
            raise ValueError(f"unknown on_invalid policy {on_invalid!r}")
        self.on_invalid = on_invalid
        self.scorer = ShardedScorer(
            model, preproc, devices=[device] if devices is None else devices)
        self.dispatch_retries = dispatch_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_seed = retry_seed
        # re-entrant: model-plane swaps land at flush boundaries by
        # taking this lock, and a flush hook promoting from inside a
        # flush re-enters it on the same thread
        self._lock = threading.RLock()
        self._pending: List[object] = []  # frames queued for flush
        self._quarantine: List[object] = []  # rejected rows, as frames
        # stacked-shape signatures seen so far, so warm() can run a
        # candidate through every live shape before a hot swap
        self._stack_sigs: Dict[Tuple[int, int],
                               Dict[str, Tuple[tuple, object]]] = {}
        self._requests_served = 0
        self._rows_scored = 0
        self._flushes = 0
        self._dispatches = 0
        self._shadow_dispatches = 0
        self._scorer_retries = 0
        self._swaps = 0
        self._warm_dispatches = 0
        self._quarantined_nonfinite = 0
        self._quarantined_unknown_type = 0
        self._wall_s = 0.0
        # registry mirrors (program logic keeps the plain ints above —
        # they must stay correct under obs.disable())
        reg = obs_metrics.registry()
        site = self.scorer.site.site
        self._m_quarantined = {
            "nonfinite": reg.counter("fleet.quarantined",
                                     kind="nonfinite", site=site),
            "unknown_type": reg.counter("fleet.quarantined",
                                        kind="unknown_type", site=site),
        }
        self._m_flushes = reg.counter("fleet.flushes", site=site)
        self._m_rows = reg.counter("fleet.rows_scored", site=site)
        self._m_retries = reg.counter("fleet.scorer_retries", site=site)
        self._m_swaps = reg.counter("fleet.param_swaps", site=site)
        # per-flush wall-clock histogram: the model plane's canary gate
        # reads its quantiles as the incumbent latency baseline
        self._h_flush = reg.histogram("fleet.flush_wall_s", site=site)

    # --------------------------------------------------------- validation
    def validate_frame(self, frame) -> Dict[str, np.ndarray]:
        """Row masks of telemetry that must never reach the scorer:
        ``nonfinite`` (NaN/Inf in a present metric/gauge cell or the
        timestamp — they would poison the normalized feature cache and
        every padded batch they share a dispatch with) and
        ``unknown_type`` (benchmark types the preprocessor was never
        fitted on — unscorable, and ``type_ids`` would raise)."""
        known = set(self.preproc.benchmark_types or ())
        bad_type_codes = [c for c, name
                          in enumerate(frame.benchmark_types)
                          if name not in known]
        unknown = np.isin(frame.type_code, bad_type_codes)
        nonfinite = (
            ~np.isfinite(np.where(frame.metrics_present,
                                  frame.metrics, 0.0)).all(axis=1)
            | ~np.isfinite(np.where(frame.node_metrics_present,
                                    frame.node_metrics, 0.0)).all(axis=1)
            | ~np.isfinite(frame.t))
        return {"nonfinite": nonfinite, "unknown_type": unknown}

    def _admit(self, frame):
        """Apply the ``on_invalid`` policy; returns the clean subset
        (or the frame untouched when validation is off)."""
        if self.on_invalid == "off":
            return frame
        masks = self.validate_frame(frame)
        bad = masks["nonfinite"] | masks["unknown_type"]
        if not bad.any():
            return frame
        n_nf = int(masks["nonfinite"].sum())
        n_ut = int((masks["unknown_type"] & ~masks["nonfinite"]).sum())
        if self.on_invalid == "raise":
            raise ValueError(
                f"rejected {int(bad.sum())} telemetry rows: {n_nf} "
                f"with NaN/Inf metric values, {n_ut} with benchmark "
                "types the preprocessor was not fitted on")
        self._quarantined_nonfinite += n_nf
        self._quarantined_unknown_type += n_ut
        self._m_quarantined["nonfinite"].inc(n_nf)
        self._m_quarantined["unknown_type"].inc(n_ut)
        self._quarantine.append(frame.select(np.nonzero(bad)[0]))
        return frame.select(np.nonzero(~bad)[0])

    @property
    def quarantine(self) -> List[object]:
        """Quarantined (rejected) rows, as frames, in intake order."""
        return list(self._quarantine)

    # ------------------------------------------------------------- intake
    def submit(self, data: FrameOrRecords) -> None:
        """Queue new executions for the next flush. Rows are grouped
        into per-node requests by their machine column at flush time,
        so a frame may carry one node's round or a whole fleet round.
        Rows with NaN/Inf metrics or unfitted benchmark types are
        quarantined (or rejected, per ``on_invalid``) — they never
        reach the store or the scorer."""
        frame = self._admit(as_frame(data))
        if len(frame):
            with self._lock:
                self._pending.append(frame)

    def seed_history(self, data: FrameOrRecords) -> None:
        """Append unscored context rows (e.g. a prior acquisition) with
        their cached feature columns (validated like submissions —
        poisoned context would contaminate every later request)."""
        frame = self._admit(as_frame(data))
        if len(frame):
            self.store.append(
                frame, features=prepare_features(self.preproc, frame))

    def score_round(self, data: FrameOrRecords
                    ) -> Dict[str, "FleetResult"]:
        """Convenience: queue a whole (multi-node) re-fingerprinting
        round and flush once; one request per node in the round."""
        self.submit(data)
        return self.flush()

    # -------------------------------------------------------------- flush
    def flush(self) -> Dict[str, FleetResult]:
        """Score every pending request in shape-bucketed micro-batches
        (one stacked dispatch per distinct row bucket). Holds the
        service lock end to end, so parameter swaps
        (:meth:`swap_params`) only ever land at flush boundaries."""
        with self._lock:
            if not self._pending:
                return {}
            t0 = time.perf_counter()
            span_args: Dict[str, object] = {}
            with obs_trace.span("fleet.flush", args=span_args):
                results = self._flush_locked(t0, span_args)
            return results

    def _flush_locked(self, t0: float,
                      span_args: Dict[str, object]
                      ) -> Dict[str, FleetResult]:
        pending, self._pending = self._pending, []

        # one vectorized preprocessing pass over all new rows, appended
        # to the store before assembly so context gathers see them
        new_all = (concat_frames(pending) if len(pending) > 1
                   else pending[0])
        first_id = self.store.append(
            new_all, features=prepare_features(self.preproc, new_all))

        requests = self._assemble_requests(first_id)
        results, n_buckets = self._dispatch_requests(
            self.params, requests, attach=True)
        self._requests_served += len(requests)
        self._flushes += 1
        dt = time.perf_counter() - t0
        self._wall_s += dt
        self._m_flushes.inc()
        self._h_flush.observe(dt)
        self._m_rows.inc(sum(len(r.row_ids) for r in results.values()))
        span_args.update(requests=len(requests), buckets=n_buckets,
                         rows=int(len(new_all)))
        return results

    def _assemble_requests(self, first_id: int) -> List[dict]:
        """Per-node context gather + input assembly (pure numpy) for
        every store row with id >= ``first_id`` ("the round")."""
        frame = self.store.frame
        feats = self.store.features
        n_types = max(len(frame.benchmark_types), 1)
        key_all = (frame.machine_code.astype(np.int64) * n_types
                   + frame.type_code)
        requests = []
        row_id = self.store.row_id
        new_codes = frame.machine_code[row_id >= first_id]
        for m_code in np.unique(new_codes):
            node = frame.machines[m_code]
            # context rule shared with the watchdog + benchmarks:
            # before-round window per chain + every new row of the node
            idx, is_new = self.store.context_with_new(
                first_id, self.context_per_chain, node=node)
            gs = chain_structure(key_all[idx], frame.t[idx])
            bucket = next_pow2(len(idx), self.min_bucket)
            inputs = assemble_inputs(
                {k: feats[k][idx] for k in FEATURE_KEYS},
                gs.nbr, gs.dt, gs.t_src, bucket)
            requests.append(
                {"node": node, "idx": idx, "is_new": is_new,
                 "bucket": bucket, "inputs": inputs})
        return requests

    def _dispatch_requests(self, params, requests: List[dict], *,
                           attach: bool
                           ) -> Tuple[Dict[str, FleetResult], int]:
        """Bucket-grouped stacked dispatches of assembled requests
        with the given ``params``. ``attach=True`` is the live flush
        path (scores written to the store, throughput counters);
        ``attach=False`` is read-only shadow scoring (canary gates) —
        the store is never touched."""
        results: Dict[str, FleetResult] = {}
        buckets: Dict[int, List[dict]] = {}
        for req in requests:
            buckets.setdefault(req["bucket"], []).append(req)
        for bucket, group in buckets.items():
            with obs_trace.span("fleet.stack",
                                args={"bucket": bucket,
                                      "requests": len(group)}):
                stack = stack_padded(
                    [req["inputs"] for req in group],
                    self.scorer.pad_requests(len(group)))
            r_pad = stack[next(iter(stack))].shape[0]
            self._stack_sigs[(r_pad, bucket)] = {
                k: (v.shape, v.dtype) for k, v in stack.items()}
            out = self._dispatch_with_retry(params, stack)
            if attach:
                self._dispatches += 1
            else:
                self._shadow_dispatches += 1
            for r, req in enumerate(group):
                idx, is_new = req["idx"], req["is_new"]
                m = len(idx)
                prob = out["anomaly_prob"][r, :m]
                codes = out["codes"][r, :m]
                logits = out["type_logits"][r, :m]
                if attach:
                    self.store.attach(idx[is_new], prob[is_new],
                                      codes[is_new])
                    self._rows_scored += int(is_new.sum())
                results[req["node"]] = FleetResult(
                    node=req["node"],
                    anomaly_prob=prob[is_new],
                    type_logits=logits[is_new],
                    codes=codes[is_new],
                    row_ids=self.store.row_id[idx[is_new]],
                    context_row_ids=self.store.row_id[idx[~is_new]],
                    bucket=bucket)
        return results, len(buckets)

    def _dispatch_with_retry(self, params, stack):
        """One stacked dispatch with bounded retry-with-backoff for
        transient scorer failures (seeded jitter via ``common.rng`` so
        backoff schedules replay deterministically). The stacked numpy
        buffers are only read (each attempt copies them to the device
        anew), so a retry re-runs the identical dispatch on the same
        devices."""
        for attempt in range(self.dispatch_retries + 1):
            try:
                return self.scorer.score_stack(params, stack)
            except Exception:
                if attempt >= self.dispatch_retries:
                    raise
                self._scorer_retries += 1
                self._m_retries.inc()
                base = self.retry_backoff_s * (2 ** attempt)
                jitter = folded_generator(
                    self.retry_seed, STREAM_RETRY,
                    self._scorer_retries).uniform(0.0, base)
                time.sleep(min(base + jitter, 1.0))

    # ----------------------------------------------------- model plane
    def swap_params(self, new_params):
        """Atomically replace the scoring parameters; returns the old
        ones. Taken under the service lock, so the swap lands at a
        flush boundary — every request of one flush is scored by
        exactly one parameter set, and nothing pending is dropped or
        rescored (the model plane's hot-swap path)."""
        with self._lock:
            old, self.params = self.params, new_params
            self._swaps += 1
            self._m_swaps.inc()
            return old

    def warm(self, params) -> int:
        """Pre-dispatch ``params`` through every stacked shape seen so
        far (zero-filled inputs, outputs discarded), so the scoring
        function has run on ``params`` at every live shape before the
        subsequent :meth:`swap_params`. Returns the number of shapes
        warmed."""
        with self._lock:
            sigs = list(self._stack_sigs.items())
        for _, sig in sigs:
            stack = {k: np.zeros(shape, dtype)
                     for k, (shape, dtype) in sig.items()}
            self._dispatch_with_retry(params, stack)
            self._warm_dispatches += 1
        return len(sigs)

    def rescore(self, first_id: int, params=None, *,
                attach: bool = False) -> Dict[str, FleetResult]:
        """Re-score every store row with id >= ``first_id`` through
        the exact flush path (same per-node context windows, row
        buckets and stacked dispatches) without re-appending anything.
        With ``attach=False`` (shadow mode) the store is untouched —
        this is the canary gate's side-by-side scoring of a candidate
        against the incumbent's attached scores. ``attach=True``
        overwrites the stored scores (the rollback repair path).
        Scores are bit-identical to what the original flushes computed
        for the same parameters: each row's score depends only on its
        own chain's receptive field, which this gather reproduces."""
        with self._lock:
            if len(self.store) == 0 or first_id >= self.store.next_id:
                return {}
            p = self.params if params is None else params
            requests = self._assemble_requests(first_id)
            results, _ = self._dispatch_requests(p, requests,
                                                 attach=attach)
            return results

    # -------------------------------------------------------------- stats
    @property
    def trace_count(self) -> int:
        return self.scorer.trace_count

    @property
    def stats(self) -> obs_metrics.StatsDict:
        return {
            "requests_served": self._requests_served,
            "rows_scored": self._rows_scored,
            "flushes": self._flushes,
            "dispatches": self._dispatches,
            "shadow_dispatches": self._shadow_dispatches,
            "scorer_retries": self._scorer_retries,
            "param_swaps": self._swaps,
            "warm_dispatches": self._warm_dispatches,
            "quarantined_nonfinite": self._quarantined_nonfinite,
            "quarantined_unknown_type": self._quarantined_unknown_type,
            "quarantined_rows": (self._quarantined_nonfinite
                                 + self._quarantined_unknown_type),
            "traces": self.scorer.trace_count,
            "devices": self.scorer.n_devices,
            "store_rows": len(self.store),
            "wall_s": self._wall_s,
            "requests_per_s": (self._requests_served
                               / max(self._wall_s, 1e-9)),
        }
