"""Training driver: Perona-aware fault-tolerant LM training.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 --scale small

``repro/launch/train.py`` in PyTorch, with the reference's flags and
defaults plus ``--device`` (the card unless ``--device cpu``) and
``--dtype`` (the configuration's unless given: the small DeepSeek-V2-Lite,
whose latent attention is (24, 16) wide, trains on the card in float32,
since the flash kernel's bf16 route does not take that pair). The flow:
  1. fingerprint the cluster's hosts (``--hosts`` n2-standard-4 nodes)
     with the standardized suite, train Perona on the executions and rank
     the hosts (:func:`fingerprint_cluster`);
  2. run the fault-tolerant step loop (``runtime.fault.TrainingRuntime``:
     checkpoint/restart, a failure injected at ``--fail-at``, the
     straggler monitor routed through the Perona watchdog) over the
     deterministic token pipeline (batch = f(seed, step), so a restart
     replays the same batches). A step is value and gradient of
     ``model.loss`` plus AdamW under a cosine schedule, in the model's
     own type, as the reference's ``main`` (no cast; the bf16 master-
     weight step is ``launch.steps.make_train_step``).
``--scale full`` trains at the configuration's full width;
``--scale small`` at ``scaled_down(max_seq=--seq)``. The hosts are
virtual, the model runs on one device. An encoder-decoder (whisper) is
refused with ``ValueError`` before any of it: its loss takes frames,
which the token pipeline does not draw (the reference's ``main`` fails
on that batch with ``KeyError``); :func:`make_step` trains it on a batch
with frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.fault import FailureInjector, TrainingRuntime
from repro_torch.runtime.straggler import StragglerMonitor

from repro_torch.common.device import resolve_device
from repro_torch.core.graph_data import build_graphs, chronological_split
from repro_torch.core.model import PeronaConfig, PeronaModel
from repro_torch.core.params import flat_params, params_from_numpy
from repro_torch.core.preprocess import Preprocessor
from repro_torch.core.ranking import aspect_scores, rank_machines
from repro_torch.core.trainer import batch_to_torch, train_perona
from repro_torch.fingerprint.runner import SuiteRunner
from repro_torch.runtime.watchdog import PeronaWatchdog


def train_on_records(records, *, seed=0, epochs=40, device="cuda",
                        params0=None):
    """Perona trained on ``records`` (70/30 chronological split) and the
    codes of every record: (model holding the selected parameters,
    training result, preprocessor, codes). ``params0``: initial
    parameters as the reference's nested tree (``core.params``), else
    the port's seeded initialisation."""
    dev = resolve_device(device)
    train_r, val_r, _ = chronological_split(records, (0.7, 0.3, 0.0))
    pre = Preprocessor().fit(train_r)
    tb, vb = build_graphs(train_r, pre), build_graphs(val_r, pre)
    cfg = PeronaConfig(feature_dim=pre.feature_dim,
                       edge_dim=tb.edge.shape[-1])
    model = PeronaModel(cfg, generator=torch.Generator().manual_seed(seed))
    if params0 is not None:
        model.load_state_dict(flat_params(params_from_numpy(params0)))
    res = train_perona(model, tb, vb, epochs=epochs, seed=seed, device=dev)
    with torch.no_grad():
        out = model(batch_to_torch(build_graphs(records, pre), dev))
    return model, res, pre, out["codes"].cpu().numpy()


def fingerprint_cluster(machines, *, seed=0, epochs=40, runs_per_type=8,
                        device="cuda", params0=None):
    """Rank cluster nodes with Perona; returns (watchdog, ranked_nodes,
    runner). ``machines``: {node: machine type}."""
    runner = SuiteRunner(seed=seed)
    records = runner.run(machines, runs_per_type=runs_per_type)
    model, res, pre, codes = train_on_records(
        records, seed=seed, epochs=epochs, device=device, params0=params0)
    scores = aspect_scores(codes, [r.benchmark_type for r in records],
                           [r.machine for r in records])
    ranked = rank_machines(scores)
    watchdog = PeronaWatchdog(model, res.params, pre, device=device)
    watchdog.history = list(records)
    return watchdog, ranked, runner


def make_step(model, opt):
    """The step of :func:`main`: value and gradient of ``model.loss`` plus
    ``opt.update``, in the parameters' own type (the reference's
    ``main``, ``:105-110``). ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``."""

    def step(params, opt_state, batch):
        (loss, _), grads = value_and_grad(model.loss, params, batch)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--scale", choices=["full", "small"], default="small")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a host failure at this step (0 = none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the run goes: the card unless 'cpu'")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    help="the model's type (default: the configuration's)")
    return ap


def main(argv=None):
    """Run the training; returns the runtime's result (``state``,
    ``losses``, ``events``, ``final_hosts``, ``restarts``) plus
    ``step_ms``, each executed step's time (CUDA events on the card, the
    host clock on the CPU)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "small":
        cfg = cfg.scaled_down(max_seq=args.seq)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if cfg.n_encoder_layers:
        # the reference's main fails here too, later: its loss reads
        # batch["frames"], which a token pipeline's batch lacks
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its loss takes frames (B, "
            f"{cfg.n_audio_frames}, {cfg.d_model}), which the token "
            f"pipeline does not draw; train it through make_step on a "
            f"batch with frames")
    model = build_model(cfg)

    # --- 1. Perona: fingerprint + rank the cluster ----------------------
    machines = {f"host-{i}": "n2-standard-4" for i in range(args.hosts)}
    t0 = time.time()
    watchdog, ranked, runner = fingerprint_cluster(machines, seed=args.seed,
                                                   device=dev)
    print(f"[perona] cluster ranked in {time.time()-t0:.1f}s: {ranked}")

    # --- 2/3. fault-tolerant training loop ------------------------------
    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
    pipeline = TokenPipeline(cfg.vocab_size, args.seq, args.batch,
                             seed=args.seed, device=dev)

    def init_state(hosts):
        params = model.init(args.seed, device=dev)
        return {"params": params, "opt": opt.init(params)}

    _step = make_step(model, opt)
    timers = []

    def train_step(state, batch, hosts):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        else:
            t = time.perf_counter()
        params, opt_state, loss = _step(state["params"], state["opt"],
                                        batch)
        if dev.type == "cuda":
            end.record()
            timers.append((start, end))
        loss = float(loss)  # waits for the step
        if dev.type != "cuda":
            timers.append((time.perf_counter() - t) * 1e3)
        return {"params": params, "opt": opt_state}, {"loss": loss}

    injector = FailureInjector(
        {args.fail_at: ["host-1"]} if args.fail_at else None)
    rt = TrainingRuntime(
        hosts=list(machines), train_step=train_step, init_state=init_state,
        pipeline=pipeline,
        ckpt=CheckpointManager(Path(args.ckpt_dir) / args.arch),
        checkpoint_every=args.checkpoint_every,
        failure_injector=injector, watchdog=watchdog, suite_runner=runner,
        machines=machines, straggler_monitor=StragglerMonitor())
    result = rt.run(args.steps)
    rt.ckpt.close()
    losses = result["losses"]
    print(f"[train] steps={len(losses)} loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-5:]):.3f}; restarts={result['restarts']}; "
          f"hosts={result['final_hosts']}")
    for ev in result["events"]:
        print(f"[event] step={ev.step} {ev.kind}: {ev.detail}")
    result["step_ms"] = [t if isinstance(t, float) else
                         t[0].elapsed_time(t[1]) for t in timers]
    return result


if __name__ == "__main__":
    main()
