#!/usr/bin/env python3
"""Measure how far Perona training runs drift from the JAX reference
trainer, to set the whole-run tolerances of ``chip_smoke.py`` phase [14]
and of ``tests/test_torch_train.py``.

    PYTHONPATH=src python tools/train_tolerance.py --device cpu --runs 8
    PYTHONPATH=src python tools/train_tolerance.py --device cpu --runs 8 \
        --trainer scan

From the training golden file (``src/repro_torch/assets/
perona_train_golden.npz``; the §IV-C batch at dropout 0 from its
initial parameters) it prints, against one of the JAX package's two
trainers stored there, the other one and the port's counterpart run
here on ``--device`` (the card unless ``cpu``): with ``--trainer host``
(phase [14c]) against JAX's ``train_perona_reference``, the port's
``train_perona_reference``; with ``--trainer scan`` (phase [15b])
against JAX's scanned ``train_perona``, the port's device-resident
``train_perona``. For each: the largest relative error of the train and
validation losses over the first epochs, per block of 10 epochs and over
the whole run as a share of the limits, the largest validation-F1
difference, the best epochs and the selected parameters' relative L2
error (all leaves but the key biases, and the largest single leaf).
The port runs ``--runs`` times: its sums are not in a fixed order on a
CPU with several threads, so each run rounds differently. Then the
port's loss terms, gradients and one AdamW step at the initial
parameters. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--trainer", choices=("host", "scan"), default="host")
    args = ap.parse_args(argv)
    cs = _chip_smoke()
    from repro_torch.common.device import resolve_device
    from repro_torch.core.params import load_train_golden
    from repro_torch.core.trainer import train_perona, train_perona_reference

    device = resolve_device(args.device)
    golden = load_train_golden()
    tb, vb = cs.train_batches()
    m = golden.meta
    # (the port's trainer, the JAX run it is held to, the other JAX run)
    train, ref, other = {
        "scan": (train_perona, "train_perona (scanned)",
                 "train_perona_reference"),
        "host": (train_perona_reference, "train_perona_reference",
                 "train_perona (scanned)")}[args.trainer]
    jax_runs = {"train_perona (scanned)": golden.scan,
                "train_perona_reference": golden.ref}
    runs = {f"JAX {other}": jax_runs[other]}
    for i in range(args.runs):
        res = train(
            cs.golden_model(golden, device), tb, vb, device=device,
            epochs=m["epochs"], patience=m["patience"], lr=m["lr"],
            weight_decay=m["weight_decay"], seed=m["seed"])
        runs[f"port {train.__name__} on {device}, run {i}"] = cs.run_of(res)
    print(f"against JAX {ref}, {m['epochs']} epochs at dropout 0:")
    for name, run in runs.items():
        e = cs.run_errors(run, jax_runs[ref])
        print(f"  {name}: epochs {e['epochs']}; losses, max rel error: first "
              f"{cs.TRAIN_FIRST_EPOCHS} epochs {e['first_rel']:.3e}, by "
              f"{cs.TRAIN_EPOCH_BLOCK} epochs "
              + " ".join(f"{x:.1e}" for x in e["block_rel"])
              + f" ({e['loss_share']:.2f} of the limits); val F1 max abs "
              f"{e['f1_abs']:.4e}; best epoch {e['best_epoch']}, key diff "
              f"{e['key_diff'][0]:.3e} / {e['key_diff'][1]:.3e}; selected "
              f"parameters rel L2 {e.get('params_rel', float('nan')):.3e}, "
              f"largest leaf {e.get('leaf_rel', float('nan')):.3e}")
    fp = cs.fixed_point_errors(golden, tb, device)
    print(f"port at the initial parameters on {device}: loss terms max abs "
          f"{fp['loss']:.3e}, gradients max rel L2 {fp['grad']:.3e}, "
          f"key-bias gradients {fp['zero_grad']:.3e} of the global norm, "
          f"one AdamW step max abs {fp['step']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
