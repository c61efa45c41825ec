"""The golden file of Perona training in the JAX package.

``src/repro_torch/assets/perona_train_golden.npz`` carries the JAX
package's training on the §IV-C batch (``paper_acquisition(seed=0)``,
chronological split: 1080 train and 360 validation nodes) across to the
PyTorch port, so that ``chip_smoke.py`` holds the port's training on
the card without JAX. It holds:

- ``config``: the paper's ``PeronaConfig`` fields as JSON (default
  dropouts); ``meta``: the training settings as JSON;
- ``init/<path>``: the initial parameters, ``perona_init`` at
  ``PRNGKey(0)``, every leaf under its slash-joined path;
- at dropout 0 and those parameters: ``loss/<term>`` (the five terms
  and ``total``), ``grad/<path>`` and ``step1/<path>``, the parameters
  after one AdamW step (the trainers' optimizer: lr 3e-3, b2 0.999,
  weight decay 1e-4, clip 5);
- ``ref/*`` and ``scan/*``: ``train_perona_reference`` and
  ``train_perona`` at dropout 0 from those parameters (seed 0): the
  per-epoch ``train_loss``, ``val_loss`` and ``val_f1``, ``best_epoch``,
  the selection key ``best_key`` (f1, -val loss) and the selected
  parameters under ``ref/params/<path>`` and ``scan/params/<path>``;
- ``eval/<metric>``: ``evaluate`` on the validation batch of the
  default-dropout recipe (``train_perona``, 80 epochs, seed 0: the
  ``trained_perona`` fixture of ``tests/conftest.py``).

Regenerate it (about a minute on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_golden.py --write
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "assets" / "perona_train_golden.npz")
LOSS_TERMS = ("total", "mse", "cbfl", "cel", "tml", "mrl")
EVAL_METRICS = ("mse", "type_accuracy", "f1_normal", "f1_outlier",
                "accuracy", "weighted_accuracy")
META = {"epochs": 80, "patience": 25, "lr": 3e-3, "weight_decay": 1e-4,
        "seed": 0, "b2": 0.999, "clip_norm": 5.0}


def dropout_free(cfg):
    return dataclasses.replace(cfg, feature_dropout=0.0, edge_dropout=0.0,
                               alpha_dropout=0.0)


def _leaves(prefix, params):
    import jax

    from repro.common.tree import tree_flatten_with_paths

    tree = jax.tree_util.tree_map(np.asarray, params)
    return {f"{prefix}/{p}": leaf for p, leaf in tree_flatten_with_paths(tree)}


def _history(prefix, res):
    h = res.history
    return {f"{prefix}/train_loss": np.asarray([e["train_loss"] for e in h]),
            f"{prefix}/val_loss": np.asarray([e["val_loss"] for e in h]),
            f"{prefix}/val_f1": np.asarray([e["val_f1_outlier"] for e in h]),
            f"{prefix}/best_epoch": np.asarray(res.best_epoch),
            f"{prefix}/best_key": np.asarray(
                [h[res.best_epoch]["val_f1_outlier"],
                 -h[res.best_epoch]["val_loss"]]),
            **_leaves(f"{prefix}/params", res.params)}


def paper_batches():
    """The §IV-C training and validation batches and the paper config."""
    from repro.core.graph_data import build_graphs, chronological_split
    from repro.core.model import PeronaConfig
    from repro.core.preprocess import Preprocessor
    from repro.fingerprint.runner import paper_acquisition

    train_r, val_r, _ = chronological_split(paper_acquisition(seed=0))
    pre = Preprocessor().fit(train_r)
    tb, vb = build_graphs(train_r, pre), build_graphs(val_r, pre)
    cfg = PeronaConfig(feature_dim=pre.feature_dim,
                       edge_dim=tb.edge.shape[-1])
    return cfg, tb, vb


def fixed_point(cfg, params, tb):
    """Loss terms, gradients and one AdamW step at dropout 0."""
    import jax

    from repro.core.model import PeronaModel
    from repro.core.trainer import batch_to_jnp
    from repro.optim.adamw import AdamW

    model = PeronaModel(dropout_free(cfg))
    (total, terms), grads = jax.value_and_grad(model.loss, has_aux=True)(
        params, batch_to_jnp(tb), jax.random.PRNGKey(0))
    opt = AdamW(lr=META["lr"], b2=META["b2"],
                weight_decay=META["weight_decay"],
                clip_norm=META["clip_norm"])
    step1, _, om = opt.update(grads, opt.init(params), params)
    losses = {"total": total, **terms}
    return ({f"loss/{k}": np.asarray(losses[k]) for k in LOSS_TERMS},
            grads, step1, float(om["grad_norm"]))


def write(path: Path = GOLDEN) -> None:
    import jax

    from repro.core.model import PeronaModel
    from repro.core.trainer import (evaluate, train_perona,
                                    train_perona_reference)

    cfg, tb, vb = paper_batches()
    model0 = PeronaModel(dropout_free(cfg))
    params = model0.init(jax.random.PRNGKey(META["seed"]))
    losses, grads, step1, gnorm = fixed_point(cfg, params, tb)
    kw = dict(epochs=META["epochs"], patience=META["patience"],
              lr=META["lr"], weight_decay=META["weight_decay"],
              seed=META["seed"])
    ref = train_perona_reference(model0, tb, vb, **kw)
    scan = train_perona(model0, tb, vb, **kw)
    trained = train_perona(PeronaModel(cfg), tb, vb, epochs=80, seed=0)
    ev = evaluate(PeronaModel(cfg), trained.params, vb)
    payload = {
        "config": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        "meta": np.asarray(json.dumps({**META, "grad_norm": gnorm})),
        **_leaves("init", params), **losses, **_leaves("grad", grads),
        **_leaves("step1", step1), **_history("ref", ref),
        **_history("scan", scan),
        **{f"eval/{k}": np.asarray(ev[k]) for k in EVAL_METRICS},
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes); grad norm "
          f"{gnorm:.6g}; reference {len(ref.history)} epochs, best "
          f"{ref.best_epoch}; scanned {len(scan.history)} epochs, best "
          f"{scan.best_epoch}; default-dropout f1_outlier "
          f"{ev['f1_outlier']:.4f} type_accuracy {ev['type_accuracy']:.4f}")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_train_golden_file_is_small():
    assert GOLDEN.stat().st_size < 1 << 20


def test_train_golden_is_fresh(golden, trained_perona, fitted):
    """The JAX package reproduces the stored initial parameters, the
    fixed-point losses, gradients and step, the first epochs of the
    reference trainer and the default-dropout recipe's metrics."""
    import jax

    from repro.core.model import PeronaModel
    from repro.core.trainer import evaluate, train_perona_reference

    cfg, tb, vb = paper_batches()
    assert json.loads(str(golden["config"])) == json.loads(
        json.dumps(dataclasses.asdict(cfg)))
    params = PeronaModel(cfg).init(jax.random.PRNGKey(META["seed"]))
    for k, v in _leaves("init", params).items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
    losses, grads, step1, gnorm = fixed_point(cfg, params, tb)
    for k, v in losses.items():
        np.testing.assert_allclose(v, golden[k], rtol=1e-6, err_msg=k)
    for name, tree in (("grad", grads), ("step1", step1)):
        for k, v in _leaves(name, tree).items():
            np.testing.assert_allclose(v, golden[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    res = train_perona_reference(PeronaModel(dropout_free(cfg)), tb, vb,
                                 epochs=5, seed=META["seed"],
                                 lr=META["lr"],
                                 weight_decay=META["weight_decay"])
    for key, name in (("train_loss", "train_loss"),
                      ("val_loss", "val_loss")):
        np.testing.assert_allclose([e[key] for e in res.history],
                                   golden[f"ref/{name}"][:5], rtol=1e-5,
                                   err_msg=key)
    model, trained = trained_perona
    ev = evaluate(model, trained, fitted["val"])
    for k in EVAL_METRICS:
        np.testing.assert_allclose(ev[k], golden[f"eval/{k}"], atol=1e-6,
                                   err_msg=k)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_train_golden.py --write")
    write()
