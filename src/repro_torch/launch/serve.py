"""Serving entry point: slot-based LM prefill + decode, and Perona's
fingerprint-scoring modes; the port of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --scale small --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --scale full --max-len 4112
    python -m repro_torch.launch.serve --fingerprint --rounds 20
    python -m repro_torch.launch.serve --fleet --nodes 16 --rounds 8
    python -m repro_torch.launch.serve --daemon --faults --nodes 6 \
        --rounds 12

A fixed pool of batch slots serves a request queue: a finished sequence
releases its slot, the next request prefills into it, and all slots
decode in lockstep, one ``decode_step`` per token. The reference
prefills a full batch with only the slot's row active and merges that
row into the live cache (``merge_cache_slot``); here the request is
prefilled as a batch of one straight into the slot's rows of the live
cache (``transformer.cache_rows``: views at batch axis 1 in the body,
0 in head and tail), where every layer writes its state in place
(K/V rings, conv histories, RG-LRU and xLSTM states). Rows are
independent in every layer, so the tokens are the same.

``--fingerprint`` trains a small Perona model (``_trained_perona``: the
graphed ``core.trainer.train_perona``, 40 epochs) and streams watchdog
rounds through one :class:`repro_torch.fleet.FleetScoringService`.
``--fleet`` runs the raw fleet service loop (per-node requests flushed
as one stacked dispatch a row bucket) and reports requests/s, dispatches
and the store-backed drift summary. ``--daemon`` streams seeded per-node
telemetry through an :class:`repro_torch.fleet.IngestionDaemon`;
``--faults`` routes the stream through the seeded fault injector with
one genuinely degraded node. ``--metrics`` dumps the metrics registry
every ``--metrics-interval`` seconds and at exit. The model plane
(``--modelplane``, ``--modelplane-cmd``, ``--registry``, ``--version``)
and ``--timeline`` are not ported yet and are refused.

Every mode runs on the card unless ``--device cpu`` is given, and fails
when there is no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    tokens: Optional[List[int]] = None
    # host clock (time.perf_counter): when the request reached the server
    # (``serve`` stamps its own start on requests that carry none)
    arrival_s: Optional[float] = None
    ttft_s: float = 0.0  # arrival -> first token on the host
    prefill_s: float = 0.0  # prefill start -> first token: one layer's part


class SlotServer:
    """Slot-based continuous batching on top of prefill/decode_step."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 512):
        self.model = model
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = model.init_cache(n_slots, max_len, device=self.device)
        self.pos = np.zeros(n_slots, np.int64)
        self.remaining = np.zeros(n_slots, np.int64)
        self.live = np.zeros(n_slots, bool)
        self.request_of_slot: List[Optional[Request]] = [None] * n_slots
        self.last_token = np.zeros(n_slots, np.int64)
        self.decode_s = 0.0  # host clock over all decode steps
        self.decode_tokens = 0  # tokens handed to live requests by decode

    def _prefill_slot(self, slot: int, request: Request):
        """Prefill one sequence as a batch of one, into ``slot``'s rows
        of the live cache."""
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(request.prompt, np.int64)[None],
                               device=self.device)
        rows = tfm.cache_rows(self.cache, slice(slot, slot + 1))
        logits, _ = self.model.prefill(self.params, rows, tokens=toks)
        nxt = int(torch.argmax(logits[0]))
        t1 = time.perf_counter()
        request.prefill_s = t1 - t0
        request.ttft_s = t1 - request.arrival_s
        request.tokens = [nxt]
        self.last_token[slot] = nxt
        self.pos[slot] = len(request.prompt)
        self.remaining[slot] = request.max_new - 1
        self.live[slot] = True
        self.request_of_slot[slot] = request

    def step(self):
        t0 = time.perf_counter()
        toks = torch.as_tensor(self.last_token[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, _ = self.model.decode_step(self.params, toks, pos,
                                           self.cache)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        for s in range(self.n_slots):
            if not self.live[s]:
                continue
            req = self.request_of_slot[s]
            req.tokens.append(int(nxt[s]))
            self.decode_tokens += 1
            self.last_token[s] = int(nxt[s])
            self.pos[s] += 1
            self.remaining[s] -= 1
            if self.remaining[s] <= 0 or self.pos[s] >= self.max_len - 1:
                self.live[s] = False
                self.request_of_slot[s] = None

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> dict:
        start = time.perf_counter()
        for r in requests:
            if r.arrival_s is None:
                r.arrival_s = start
        queue = list(requests)
        done: List[Request] = []
        steps = 0
        while queue or self.live.any():
            for s in range(self.n_slots):
                if not self.live[s] and queue:
                    self._prefill_slot(s, queue.pop(0))
            before = [self.request_of_slot[s] for s in range(self.n_slots)]
            self.step()
            steps += 1
            for s, req in enumerate(before):
                if req is not None and self.request_of_slot[s] is None:
                    done.append(req)
        return {"completed": done, "decode_steps": steps}


def make_requests(n: int, vocab: int, max_new: int, seed: int,
                  lengths=None) -> List[Request]:
    """Prompts of seeded random tokens. Unless ``lengths`` are given,
    each request draws its length from [4, 16] and then its prompt, in
    the order of the reference's ``main``, so that one seed serves the
    same prompts in both packages."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        return [Request(rid=i, max_new=max_new,
                        prompt=rng.integers(0, vocab, rng.integers(4, 17))
                        .astype(np.int32))
                for i in range(n)]
    return [Request(rid=i, max_new=max_new,
                    prompt=rng.integers(0, vocab, s).astype(np.int32))
            for i, s in enumerate(lengths)]


def _trained_perona(machines, runs_per_type: int, seed: int, device):
    """Acquire + fit + train one small Perona model for the serving
    loops (shared by every Perona mode), on ``device``."""
    from repro_torch.core.graph_data import build_graphs
    from repro_torch.core.model import PeronaConfig, PeronaModel
    from repro_torch.core.preprocess import Preprocessor
    from repro_torch.core.trainer import train_perona
    from repro_torch.fingerprint.runner import SuiteRunner

    runner = SuiteRunner(seed=seed)
    frame = runner.run_frame(machines, runs_per_type=runs_per_type,
                             stress_fraction=0.2)
    pre = Preprocessor().fit(frame)
    batch = build_graphs(frame, pre)
    cfg = PeronaConfig(feature_dim=pre.feature_dim,
                       edge_dim=batch.edge.shape[-1])
    model = PeronaModel(cfg, generator=torch.Generator().manual_seed(seed))
    res = train_perona(model, batch, epochs=40, seed=seed, device=device)
    return runner, frame, pre, model, res.params


def serve_fingerprints(rounds: int, runs_per_type: int = 2,
                       seed: int = 0, device="cuda") -> dict:
    """Fingerprint-scoring service loop: train a small Perona model,
    then stream watchdog rounds through one FleetScoringService (the
    watchdog and the fleet entry point share this scoring path)."""
    from repro_torch.fleet import FleetScoringService
    from repro_torch.runtime.watchdog import PeronaWatchdog

    machines = {f"serve-{i}": "e2-medium" for i in range(3)}
    runner, frame, pre, model, params = _trained_perona(
        machines, runs_per_type=40, seed=seed, device=device)

    service = FleetScoringService(model, params, pre,
                                  context_per_chain=40, device=device)
    wd = PeronaWatchdog(model, params, pre, service=service,
                        history_per_chain=40)
    wd.history = frame
    t0 = time.time()
    scored = 0
    for k in range(rounds):
        round_frame = runner.run_frame(machines,
                                       runs_per_type=runs_per_type,
                                       t_offset=(k + 1) * 86400.0)
        wd.observe(round_frame)
        scored += len(round_frame)
    dt = time.time() - t0
    return {"rounds": rounds, "scored": scored, "seconds": dt,
            "traces": service.trace_count,
            "stats": service.stats,
            "excluded": wd.excluded_nodes()}


def serve_fleet(nodes: int = 16, rounds: int = 10,
                runs_per_type: int = 1, seed: int = 0,
                device="cuda") -> dict:
    """Raw fleet-service loop: per-node requests micro-batched through
    the stacked scoring path, with store-backed drift analytics."""
    from repro_torch.fleet import FleetScoringService, drift_report

    machines = {f"fleet-{i}": "e2-medium" for i in range(nodes)}
    runner, frame, pre, model, params = _trained_perona(
        machines, runs_per_type=10, seed=seed, device=device)

    service = FleetScoringService(model, params, pre,
                                  context_per_chain=16, device=device)
    service.seed_history(frame)
    t0 = time.time()
    for k in range(rounds):
        round_frame = runner.run_frame(machines,
                                       runs_per_type=runs_per_type,
                                       t_offset=(k + 1) * 86400.0)
        service.score_round(round_frame)
    dt = time.time() - t0
    report = drift_report(service.store)
    worst = max(report.values(), key=lambda d: d.anomaly_ewma,
                default=None)
    return {"rounds": rounds, "seconds": dt, "stats": service.stats,
            "drift_nodes": len(report),
            "worst_node": None if worst is None else
            (worst.node, round(worst.anomaly_ewma, 3))}


# the --faults mix of serve_daemon (seeded with seed + 2)
DAEMON_FAULTS = dict(dropout=0.05, delay=0.2, duplicate=0.2, reorder=0.2,
                     corrupt=0.15, burst=0.2, burst_window=3.0)


def serve_daemon(nodes: int = 6, rounds: int = 12,
                 runs_per_type: int = 1, seed: int = 0,
                 faults: bool = False, device="cuda") -> dict:
    """Streaming ingestion loop: telemetry events through the bounded
    staging ring of an :class:`repro_torch.fleet.IngestionDaemon`,
    optionally perturbed by the seeded fault injector (``faults=True``
    also marks one node genuinely degraded halfway through the run)."""
    from repro_torch.fleet import (FaultPlan, FleetScoringService,
                                   IngestionDaemon, fleet_telemetry,
                                   inject_faults)

    machines = {f"fleet-{i}": "e2-medium" for i in range(nodes)}
    _, frame, pre, model, params = _trained_perona(
        machines, runs_per_type=10, seed=seed, device=device)

    service = FleetScoringService(model, params, pre,
                                  context_per_chain=16, device=device)
    service.seed_history(frame)
    daemon = IngestionDaemon(service, capacity_rows=64 * nodes,
                             flush_interval=0.5,
                             min_flush_gap=0.05)
    degraded_node = f"fleet-{nodes - 1}"
    events = fleet_telemetry(
        machines, rounds=rounds, runs_per_type=runs_per_type,
        seed=seed + 1, interval=1.0, jitter=0.25,
        degraded={degraded_node: rounds // 2} if faults else None)
    fault_counts = None
    if faults:
        events, log = inject_faults(
            events, FaultPlan(seed=seed + 2, **DAEMON_FAULTS))
        fault_counts = log.counts()
    daemon.run(events)
    return {"rounds": rounds, "stats": daemon.stats(),
            "faults": fault_counts,
            "degraded_node": degraded_node if faults else None,
            "flagged": daemon.flagged_nodes(),
            # the daemon's private virtual-clock tracer
            "tracer": daemon.tracer}


def _start_metrics_dumper(interval: float) -> threading.Event:
    """Background thread printing the metrics registry every
    ``interval`` seconds until the returned event is set."""
    from repro_torch import obs

    stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            text = obs.registry().render()
            if text:
                print(f"[metrics @ {time.strftime('%H:%M:%S')}]\n"
                      f"{text}", flush=True)

    threading.Thread(target=loop, name="perona-metrics",
                     daemon=True).start()
    return stop


# the reference's flags that wait for the operations layer
NOT_PORTED = ("modelplane", "modelplane_cmd", "registry", "version",
              "timeline")


def _run_perona(args) -> dict:
    """Dispatch one Perona serving mode and print its summary lines."""
    if args.fingerprint:
        out = serve_fingerprints(args.rounds, seed=args.seed,
                                 device=args.device)
        print(f"[serve-fp] {out['rounds']} rounds, {out['scored']} "
              f"executions, {out['seconds']:.2f}s "
              f"({out['scored'] / max(out['seconds'], 1e-9):.0f} exec/s), "
              f"{out['traces']} signatures, excluded={out['excluded']}")
        return out
    if args.daemon:
        out = serve_daemon(args.nodes, args.rounds, seed=args.seed,
                           faults=args.faults, device=args.device)
        st = out["stats"]
        svc = st["service"]
        req_s = st["events_seen"] / max(st["run_wall_s"], 1e-9)
        print(f"[serve-daemon] {out['rounds']} rounds, "
              f"{st['events_seen']} events ({st['rows_staged_total']} "
              f"rows), {req_s:.1f} sustained req/s, "
              f"p99 queue latency {st['latency_p99']:.3f}s, "
              f"peak staging {st['peak_staged_rows']}/"
              f"{st['capacity_rows']} rows")
        print(f"[serve-daemon] flushes: {st['deadline_flushes']} "
              f"deadline / {st['row_trigger_flushes']} row-trigger / "
              f"{st['forced_flushes']} forced / "
              f"{st['drain_flushes']} drain; backpressure: "
              f"{st['shed_rows']} shed rows, "
              f"{st['degraded_flushes']} degraded flushes "
              f"({st['degrade_unscored_rows']} sampled-out rows); "
              f"dedup dropped {st['duplicates_dropped']}; "
              f"quarantined {svc['quarantined_rows']} rows")
        if out["faults"] is not None:
            print(f"[serve-daemon] injected faults: {out['faults']}; "
                  f"degraded node {out['degraded_node']} -> "
                  f"flagged={out['flagged']}")
        return out
    out = serve_fleet(args.nodes, args.rounds, seed=args.seed,
                      device=args.device)
    s = out["stats"]
    print(f"[serve-fleet] {out['rounds']} rounds, "
          f"{s['requests_served']} requests, {s['rows_scored']} "
          f"rows, {s['dispatches']} dispatches on {s['devices']} "
          f"device(s), {s['traces']} signatures, "
          f"{s['requests_per_s']:.0f} req/s; "
          f"drift tracked for {out['drift_nodes']} nodes, "
          f"worst={out['worst_node']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--scale", choices=["full", "small"], default="small")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--fingerprint", action="store_true",
                    help="serve Perona fingerprint scoring rounds")
    ap.add_argument("--fleet", action="store_true",
                    help="raw fleet service loop (micro-batched, "
                         "stacked scoring + drift report)")
    ap.add_argument("--daemon", action="store_true",
                    help="streaming ingestion daemon over the fleet "
                         "service (bounded staging, deadline/row "
                         "flushes, rolling drift)")
    ap.add_argument("--faults", action="store_true",
                    help="with --daemon: inject seeded stream faults "
                         "+ one genuinely degraded node")
    ap.add_argument("--nodes", type=int, default=16,
                    help="fleet size for --fleet and --daemon")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--metrics", action="store_true",
                    help="dump the metrics registry periodically and "
                         "at exit")
    ap.add_argument("--metrics-interval", type=float, default=10.0,
                    help="seconds between --metrics dumps")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        nargs="?", const=True, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    refused = [f for f in NOT_PORTED if getattr(args, f) is not None]
    if refused:
        ap.error(f"--{refused[0].replace('_', '-')} is not ported yet: "
                 "the model plane and the timeline come with queue 1 "
                 "item 3 of ROADMAP.md (the operations layer)")

    from repro_torch import obs

    resolve_device(args.device)
    dumper = (_start_metrics_dumper(args.metrics_interval)
              if args.metrics else None)
    try:
        if args.fingerprint or args.fleet or args.daemon:
            return _run_perona(args)
        return _serve_lm(args)
    finally:
        if dumper is not None:
            dumper.set()
        if args.metrics:
            text = obs.registry().render()
            if text:
                print(f"[metrics final]\n{text}", flush=True)


def _serve_lm(args) -> dict:
    """The LM mode: ``args.requests`` seeded requests through a
    :class:`SlotServer`."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "small":
        cfg = cfg.scaled_down(max_seq=args.max_len)
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    requests = make_requests(args.requests, cfg.vocab_size, args.max_new,
                             args.seed)
    server = SlotServer(model, params, n_slots=args.slots,
                        max_len=args.max_len)
    t0 = time.perf_counter()
    out = server.serve(requests)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens) for r in out["completed"])
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} ({args.scale}) on {where}: "
          f"{len(out['completed'])} requests, {n_tokens} tokens, "
          f"{out['decode_steps']} decode steps, {dt:.1f}s "
          f"({n_tokens / max(dt, 1e-9):.1f} tok/s)")
    return out

if __name__ == "__main__":
    main()
