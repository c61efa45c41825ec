"""Fault-tolerant training runtime: checkpoint/restart + elastic hosts.

``repro/runtime/fault.py`` in PyTorch. ``TrainingRuntime`` owns the step
loop of a model. Failures (injected in tests, reported by the platform
in production) trigger:

  1. drop to the last durable checkpoint (``CheckpointManager``, in the
     reference's ``step_<n>.npz`` format, so a training state written by
     either package restores in the other),
  2. drop the failed or excluded hosts from the host list,
  3. resume the data pipeline at the restored step (deterministic
     ``batch_at(step)``: the replayed steps see the same batches).

Straggler events route through the port's Perona watchdog: a
fingerprint-confirmed degradation excludes the node like a failure; an
unconfirmed one only logs. Periodic fingerprint rounds
(``fingerprint_every``) score the live hosts through the same watchdog.
The state is whatever ``init_state`` builds (the LM trainer's
``{"params": tree, "opt": OptState}``); the runtime itself runs on the
host and never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.data.tokens import TokenPipeline


class FailureInjector:
    """Deterministic failure schedule: {step: [hosts]}. Each scheduled
    failure fires exactly once (a crashed host stays crashed — the
    restored run must not re-trip on the same step)."""

    def __init__(self, schedule: Optional[Dict[int, Sequence[str]]] = None):
        self.schedule = {int(k): list(v)
                         for k, v in (schedule or {}).items()}

    def check(self, step: int) -> List[str]:
        return self.schedule.pop(step, [])


@dataclasses.dataclass
class RuntimeEvent:
    step: int
    kind: str  # failure | restart | exclusion | straggler
    detail: str


class TrainingRuntime:
    def __init__(self, *, hosts: Sequence[str], train_step: Callable,
                 init_state: Callable[[Sequence[str]], Any],
                 pipeline: TokenPipeline, ckpt: CheckpointManager,
                 checkpoint_every: int = 10,
                 failure_injector: Optional[FailureInjector] = None,
                 watchdog=None, suite_runner=None, machines=None,
                 straggler_monitor=None,
                 host_time_fn: Optional[Callable] = None,
                 fingerprint_every: int = 0):
        self.hosts = list(hosts)
        self.train_step = train_step
        self.init_state = init_state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.failures = failure_injector or FailureInjector()
        self.watchdog = watchdog
        self.suite_runner = suite_runner
        self.machines = dict(machines or {})
        self.straggler = straggler_monitor
        self.host_time_fn = host_time_fn
        self.fingerprint_every = fingerprint_every
        self.events: List[RuntimeEvent] = []
        self.restarts = 0

    # ------------------------------------------------------------------ run
    def run(self, total_steps: int) -> Dict[str, Any]:
        state = self.init_state(self.hosts)
        start = 0
        restored, meta = self.ckpt.restore(state)
        if restored is not None:
            state = restored
            start = int(meta["step"]) + 1
            self.events.append(RuntimeEvent(start, "restart",
                                            "resumed from checkpoint"))
        step = start
        losses = []
        while step < total_steps:
            failed = self.failures.check(step)
            if failed:
                self._handle_failure(step, failed)
                state = self.init_state(self.hosts)
                restored, meta = self.ckpt.restore(state)
                if restored is not None:
                    state = restored
                    step = int(meta["step"]) + 1
                else:
                    step = 0
                self.restarts += 1
                continue

            batch = self.pipeline.batch_at(step)
            state, metrics = self.train_step(state, batch, self.hosts)
            losses.append(float(metrics.get("loss", np.nan)))

            if self.straggler is not None and self.host_time_fn is not None:
                times = self.host_time_fn(step, self.hosts)
                for ev in self.straggler.record_step(step, times):
                    self.events.append(RuntimeEvent(
                        step, "straggler", ev.host))
                    self._confirm_and_exclude(step, ev.host)

            if (self.fingerprint_every and self.watchdog is not None
                    and self.suite_runner is not None
                    and step > 0 and step % self.fingerprint_every == 0):
                self._fingerprint_round(step)

            if step % self.checkpoint_every == 0:
                self.ckpt.save(step, state, extra={"hosts": self.hosts})
                self.ckpt.wait()
            step += 1
        return {"state": state, "losses": losses, "events": self.events,
                "final_hosts": list(self.hosts), "restarts": self.restarts}

    # ----------------------------------------------------------- internals
    def _handle_failure(self, step: int, failed: Sequence[str]):
        for h in failed:
            if h in self.hosts:
                self.hosts.remove(h)
                self.events.append(RuntimeEvent(step, "failure", h))

    def _confirm_and_exclude(self, step: int, host: str):
        if self.watchdog is None or self.suite_runner is None:
            return
        mtype = self.machines.get(host)
        if mtype is None:
            return
        confirmed = False
        for _ in range(self.watchdog.confirm_runs):
            records = self.suite_runner.run({host: mtype}, runs_per_type=1,
                                            degraded_machines=[host])
            decisions = self.watchdog.observe(records)
            confirmed = any(d.node == host and d.confirmed
                            for d in decisions)
        if confirmed and host in self.hosts:
            self.hosts.remove(host)
            self.events.append(RuntimeEvent(step, "exclusion", host))

    def _fingerprint_round(self, step: int):
        live = {h: self.machines[h] for h in self.hosts
                if h in self.machines}
        records = self.suite_runner.run(live, runs_per_type=1)
        for d in self.watchdog.observe(records):
            if d.confirmed and d.node in self.hosts:
                self.hosts.remove(d.node)
                self.events.append(RuntimeEvent(step, "exclusion", d.node))
