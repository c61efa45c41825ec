"""The golden file of the configuration search in the JAX package.

``src/repro_torch/assets/scout_search_golden.npz`` carries the JAX
package's scout draws and its batched search across to the PyTorch
port, so that ``chip_smoke.py`` (phase [18]) holds the port's draws and
replay on the card without JAX. It holds, for ``ScoutDataset(seed=0)``:

- ``keys/params``, ``keys/noise``: the two stream keys (uint32);
- ``params/words``, ``params/uniform``, ``params/grid``: for every
  (workload, parameter) cell, the 64 threefry bits of its key as (hi,
  lo) words, its float64 uniform in [0, 1) and the bounded parameter
  grid;
- ``noise/words``, ``noise/uniform``, ``noise/normal``, ``noise/grid``:
  the same for every (workload, configuration) cell of the contention
  noise, with JAX's normal and the lognormal factor;
- ``grid/<name>``: the dataset's ``base_runtime``, ``runtime``,
  ``cost``, ``lows`` and the config uids;
- ``search/picks``, ``search/counts``, ``search/costs``: JAX's batched
  replay of the §IV-D matrix (18 workloads x seeds 0-2 x 4 variants x
  the healthy fleet and ``drifted_condition`` of the three c4 types,
  432 lanes) at the stand-in machine scores of
  ``tests/test_optimizer.py``; ``search/drop``: that condition's score
  drops; ``meta``: the settings as JSON.

Regenerate it (about 10 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_search_golden.py --write

The tests below also run ``chip_smoke.py``'s phase [18] checks (a) and
(b) on the CPU.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _jax_x64  # noqa: E402
from test_torch_train import chip_smoke  # noqa: E402

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "assets" / "scout_search_golden.npz")
SEED = 0
SEEDS = (0, 1, 2)
DEGRADED_TYPES = ("c4.large", "c4.xlarge", "c4.2xlarge")
CONDITION = "c4-cpu-degraded"


def stand_in_scores():
    """The deterministic fingerprint-score stand-in of
    ``tests/test_optimizer.py``."""
    from repro_torch.tuning.scout import VM_TYPES

    rng = np.random.default_rng(3)
    return {vm: {a: float(rng.uniform(0.5, 2.0))
                 for a in ("cpu", "memory", "disk", "network")}
            for vm in VM_TYPES}


def _cell_draws(key, rows, cols, normal):
    """Per cell (r, c) of ``fold_in(fold_in(key, rows[r]), cols[c])``:
    its 64 bits as (hi, lo) words, its uniform, and its normal."""
    k = jnp.asarray(key)

    def cell(r, c):
        kc = jax.random.fold_in(jax.random.fold_in(k, r), c)
        bits = jax.random.bits(kc, (), jnp.uint64)
        out = [bits, jax.random.uniform(kc, (), jnp.float64)]
        if normal:
            out.append(jax.random.normal(kc, (), jnp.float64))
        return out

    with jax.enable_x64(True):
        got = jax.jit(jax.vmap(jax.vmap(cell, in_axes=(None, 0)),
                               in_axes=(0, None)))(
            jnp.asarray(rows), jnp.asarray(cols))
        got = [np.asarray(a) for a in got]
    words = np.stack([(got[0] >> np.uint64(32)).astype(np.uint32),
                      (got[0] & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=-1)
    return [words] + got[1:]


def jax_values():
    """Every array of the golden file, computed by the JAX package."""
    with _jax_x64.alias():
        from repro.common.rng import (STREAM_WORKLOAD_PARAMS,
                                      lognormal_noise_grid, stream_key)
        from repro.optimizer import (HEALTHY, ReplayConfig,
                                     build_scenarios, drifted_condition,
                                     lane_tables, replay,
                                     traces_from_result)
        from repro.tuning.scout import (CONTENTION_SCALE, PARAM_BOUNDS,
                                        WORKLOAD_NAMES, ScoutDataset)

        ds = ScoutDataset(seed=SEED)
        grid = ds.grid
        params_key = stream_key(SEED, STREAM_WORKLOAD_PARAMS)
        n_w = len(WORKLOAD_NAMES)
        p_words, p_uniform = _cell_draws(params_key, np.arange(n_w),
                                         np.arange(len(PARAM_BOUNDS)),
                                         normal=False)
        n_words, n_uniform, n_normal = _cell_draws(
            grid.noise_key, np.arange(n_w), grid.config_uid, normal=True)
        params = np.asarray([[ds.workloads[w][b[0]] for b in PARAM_BOUNDS]
                             for w in WORKLOAD_NAMES])
        scores = stand_in_scores()
        cond = drifted_condition(DEGRADED_TYPES, name=CONDITION)
        scens = build_scenarios(ds, seeds=SEEDS,
                                conditions=(HEALTHY, cond))
        cfg = ReplayConfig()
        tab = lane_tables(ds, scens, scores, cfg)
        result = replay(tab, cfg)
        traces = traces_from_result(tab, result, ds.configs)
        costs = np.full((len(scens), cfg.max_runs), np.nan)
        for lane, tr in enumerate(traces):
            costs[lane, :len(tr.costs)] = tr.costs
        noise = lognormal_noise_grid(grid.noise_key, n_w, grid.config_uid,
                                     CONTENTION_SCALE)
        meta = {"seed": SEED, "seeds": list(SEEDS),
                "degraded_types": list(DEGRADED_TYPES),
                "condition": CONDITION, "lanes": len(scens),
                "order": "workload, seed, variant, condition",
                "scores": scores}
        return {
            "keys/params": params_key,
            "keys/noise": grid.noise_key,
            "params/words": p_words,
            "params/uniform": p_uniform,
            "params/grid": params,
            "noise/words": n_words,
            "noise/uniform": n_uniform,
            "noise/normal": n_normal,
            "noise/grid": noise,
            "grid/uid": grid.config_uid,
            "grid/base_runtime": grid.base_runtime,
            "grid/runtime": grid.runtime,
            "grid/cost": grid.cost,
            "grid/lows": grid.lows,
            "search/picks": result.chosen,
            "search/counts": result.count,
            "search/costs": costs,
            "search/drop": np.asarray(json.dumps(
                {vm: {str(a): v for a, v in per.items()}
                 for vm, per in cond.score_drop.items()}, sort_keys=True)),
            "meta": np.asarray(json.dumps(meta, sort_keys=True)),
        }


def write(path: Path = GOLDEN) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **jax_values())
    print(f"wrote {path} ({path.stat().st_size} bytes)")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_search_golden_file_is_small():
    assert GOLDEN.stat().st_size < 256 * 1024


def test_search_golden_is_fresh(golden):
    """The file is what the JAX package computes now (rerun ``--write``
    when this fails)."""
    fresh = jax_values()
    assert sorted(fresh) == sorted(golden)
    for key, want in fresh.items():
        np.testing.assert_array_equal(golden[key], want, err_msg=key)


def test_noise_grid_is_the_lognormal_of_the_normals(golden):
    """The golden's noise grid is ``exp(0.06 * normal)`` of its normals
    (within XLA's ``exp``), and the runtime grid is base x noise."""
    np.testing.assert_allclose(golden["noise/grid"],
                               np.exp(0.06 * golden["noise/normal"]),
                               rtol=1e-15)
    np.testing.assert_array_equal(
        golden["grid/runtime"],
        golden["grid/base_runtime"] * golden["noise/grid"])


def test_chip_smoke_rng_check_on_the_cpu(golden):
    """Phase [18a] on the CPU: words and uniforms bit for bit, normals
    and grids within their bounds, the seeded expansion equal to the
    dataset's grid."""
    cs = chip_smoke()
    out = cs.check_search_rng(golden, "cpu")
    assert out["normal_max_ulp"] <= cs.NORMAL_ULP
    assert out["bounded_max_ulp"] <= cs.BOUNDED_ULP
    assert out["grid_max_rel"] <= cs.GRID_RTOL


def test_chip_smoke_jax_picks_check_on_the_cpu(golden):
    """Phase [18b] on the CPU: the port's 432-lane replay at the
    stand-in scores picks what JAX picked in every lane."""
    cs = chip_smoke()
    out = cs.check_search_jax(golden, "cpu")
    assert out["lanes"] == 432 and out["lanes_differing"] == 0
    assert out["cost_max_rel"] <= cs.GRID_RTOL


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_search_golden.py --write")
    write()
