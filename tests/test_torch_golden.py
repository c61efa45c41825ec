"""The golden file of JAX-trained Perona parameters and JAX outputs.

``src/repro_torch/assets/perona_paper_golden.npz`` carries the
``trained_perona`` recipe of ``tests/conftest.py`` across to the PyTorch
port, so that the port's tests and ``chip_smoke.py`` score with trained
weights without training, and without JAX on the machine with the card.
It holds:

- ``config``: the ``PeronaConfig`` fields as JSON;
- ``params/<path>``: every parameter leaf under its slash-joined path
  (the checkpoint format of ``repro/checkpointing/manager.py``);
- ``preproc/<stat>``: the fitted ``Preprocessor`` statistics;
- ``score/<field>``: the JAX ``FingerprintEngine``'s ``ScoreResult`` on
  the full ``paper_acquisition_frame(seed=0)``.

Regenerate it (about a minute on a CPU; it trains the model) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "assets" / "perona_paper_golden.npz")

PREPROC_STATS = ("lo", "hi", "maximize", "fill_mean", "edge_lo",
                 "edge_hi", "benchmark_types", "feature_names",
                 "edge_names", "raw_feature_count")


def _preproc_stats(pre) -> dict:
    return {f"preproc/{k}": np.asarray(getattr(pre, k))
            for k in PREPROC_STATS}


def jax_params(golden):
    """The stored parameters as the JAX package's nested pytree."""
    import jax.numpy as jnp

    from repro_torch.core.params import unflatten

    return unflatten({k[len("params/"):]: jnp.asarray(v)
                      for k, v in golden.items()
                      if k.startswith("params/")})


def jax_config(golden):
    from repro.core.model import PeronaConfig

    fields = json.loads(str(golden["config"]))
    fields["loss_weights"] = tuple(fields["loss_weights"])
    return PeronaConfig(**fields)


def write(path: Path = GOLDEN) -> None:
    import dataclasses

    import jax

    from repro.common.tree import tree_flatten_with_paths
    from repro.core.graph_data import build_graphs, chronological_split
    from repro.core.model import PeronaConfig, PeronaModel
    from repro.core.preprocess import Preprocessor
    from repro.core.trainer import train_perona
    from repro.fingerprint.runner import (paper_acquisition,
                                          paper_acquisition_frame)
    from repro.serving.engine import FingerprintEngine

    # the trained_perona recipe of tests/conftest.py
    records = paper_acquisition(seed=0)
    train_r, val_r, _ = chronological_split(records)
    pre = Preprocessor().fit(train_r)
    tb, vb = build_graphs(train_r, pre), build_graphs(val_r, pre)
    cfg = PeronaConfig(feature_dim=pre.feature_dim,
                       edge_dim=tb.edge.shape[-1])
    model = PeronaModel(cfg)
    res = train_perona(model, tb, vb, epochs=80, seed=0)

    out = FingerprintEngine(model, res.params, pre).score(
        paper_acquisition_frame(seed=0))
    params = jax.tree_util.tree_map(np.asarray, res.params)
    payload = {
        "config": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        **{f"params/{p}": leaf
           for p, leaf in tree_flatten_with_paths(params)},
        **_preproc_stats(pre),
        "score/anomaly_prob": out.anomaly_prob,
        "score/type_logits": out.type_logits,
        "score/codes": out.codes,
        "score/n_padded": np.asarray(out.n_padded),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes, best epoch "
          f"{res.best_epoch})")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < 1 << 20


def test_golden_is_fresh(golden, fitted):
    """Re-scoring the acquisition with the JAX engine from the stored
    parameters reproduces the stored outputs."""
    from repro.core.model import PeronaModel
    from repro.fingerprint.runner import paper_acquisition_frame
    from repro.serving.engine import FingerprintEngine

    model = PeronaModel(jax_config(golden))
    for k, v in _preproc_stats(fitted["pre"]).items():
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
    out = FingerprintEngine(model, jax_params(golden), fitted["pre"]).score(
        paper_acquisition_frame(seed=0))
    assert out.n_padded == int(golden["score/n_padded"])
    for key in ("anomaly_prob", "type_logits", "codes"):
        np.testing.assert_allclose(getattr(out, key),
                                   golden[f"score/{key}"], atol=1e-6,
                                   err_msg=key)


def test_port_preprocessor_matches_golden(golden):
    """The port fits bit-identical statistics on the train split of the
    port's own acquisition."""
    from repro_torch.core.graph_data import chronological_split
    from repro_torch.core.params import load_golden
    from repro_torch.core.preprocess import Preprocessor
    from repro_torch.fingerprint.runner import paper_acquisition_frame

    train, _, _ = chronological_split(paper_acquisition_frame(seed=0))
    pre = Preprocessor().fit(train)
    for k, v in _preproc_stats(pre).items():
        assert v.dtype == golden[k].dtype, k
        np.testing.assert_array_equal(v, golden[k], err_msg=k)
    # the port's own reader hands back the same statistics
    stored = load_golden().preproc
    for k in PREPROC_STATS:
        np.testing.assert_array_equal(np.asarray(getattr(stored, k)),
                                      golden[f"preproc/{k}"], err_msg=k)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_golden.py --write")
    write()
