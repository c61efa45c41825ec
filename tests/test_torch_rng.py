"""The port's counter-based RNG (``repro_torch.common.rng``, device
half) against ``jax.random``: threefry words, ``fold_in`` chains,
64-bit ``random_bits`` and float64 uniforms bit for bit; normals,
``erfinv`` and the scout grids within stated bounds; and the reference's
``tests/test_seeded_rng.py`` claims run inside the port.

Bounds (the limits of ``chip_smoke.py`` phase [18a]), with what
``tools/rng_ulps.py`` measured on a CPU:

- normals: 32 ulp of JAX's (10 of 200,000 draws differ, by up to 3
  ulp; Giles' polynomial fed ``torch.log1p`` with unfused Horner steps
  would differ on 11.0 % by up to 30 ulp, ``torch.special.erfinv`` on
  58.2 % by up to 811);
- ``erfinv`` against ``lax.erf_inv``: the same 32 ulp; ``log1p``
  against XLA's: 1 ulp;
- the bounded parameter grid: 1 ulp (0 of 90 cells differ);
- the noise, runtime and cost grids: 1e-13 relative (the noise 86 of
  1,242 cells by 1 ulp, from ``exp``; runtime, cost and lows up to
  4.4e-16 relative, 3 ulp).

The JAX package's draws import ``jax.experimental.enable_x64``, which
the installed JAX lacks: the module fixture aliases it
(``tests/_jax_x64.py``) and removes the alias at teardown.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

import _jax_x64  # noqa: E402
from repro_torch.common import rng  # noqa: E402
from repro_torch.tuning.scout import (PARAM_BOUNDS, VM_TYPES,  # noqa: E402
                                      WORKLOAD_NAMES, ScoutDataset,
                                      all_configs, config_uid)

NORMAL_ULP = 32
ERFINV_ULP = 32
BOUNDED_ULP = 1
GRID_RTOL = 1e-13
SEEDS = (0, 1, 7, 123, 2 ** 31 - 1, -1, -(2 ** 31))


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with _jax_x64.alias(), _jax_x64.one_torch_thread():
        yield


def ulps(a, b) -> int:
    a = np.ascontiguousarray(a, np.float64).view(np.int64)
    b = np.ascontiguousarray(b, np.float64).view(np.int64)
    return int(np.max(np.abs(a - b)))


def jax_cells(key, rows, cols, draw):
    """``draw(fold_in(fold_in(key, r), c))`` for every (r, c), x64."""
    k = jnp.asarray(key)
    with jax.enable_x64(True):
        fn = jax.vmap(jax.vmap(
            lambda r, c: draw(jax.random.fold_in(jax.random.fold_in(k, r),
                                                 c)),
            in_axes=(None, 0)), in_axes=(0, None))
        return np.asarray(jax.jit(fn)(jnp.asarray(rows), jnp.asarray(cols)))


def port_cells(key, rows, cols):
    k = rng.as_key(key)
    return rng.fold_in(rng.fold_in(k, torch.as_tensor(rows)).unsqueeze(1),
                       torch.as_tensor(cols))


# ------------------------------------------------------------ threefry
def test_jax_threefry_is_partitionable():
    """The bit layout the port copies; a JAX upgrade that flips it
    must fail here."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("n", [2, 10, 4096])
def test_threefry2x32_matches_jax(n):
    g = np.random.default_rng(n)
    key = g.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    count = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                          jnp.asarray(count)))
    half = n // 2
    y0, y1 = rng.threefry2x32(
        torch.tensor(int(key[0])), torch.tensor(int(key[1])),
        torch.as_tensor(count[:half].astype(np.int64)),
        torch.as_tensor(count[half:].astype(np.int64)))
    got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_root_and_stream_keys_match_jax(seed):
    np.testing.assert_array_equal(
        rng.root_key(seed).numpy().astype(np.uint32),
        np.asarray(jax.random.PRNGKey(seed)))
    for tag in (rng.STREAM_WORKLOAD_PARAMS, rng.STREAM_CONTENTION):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), tag))
        got = rng.stream_key(seed, tag)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_fold_in_chains_match_jax():
    data = [0, 1, 31, 255, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    for seed in (0, 5):
        jk = jax.random.PRNGKey(seed)
        tk = rng.root_key(seed)
        for d in data + data[::-1]:
            jk = jax.random.fold_in(jk, np.uint32(d))
            tk = rng.fold_in(tk, d)
            np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                          np.asarray(jk))
    # a tensor of data folds into a batch of keys
    key = rng.stream_key(0, 32)
    got = rng.fold_in(rng.as_key(key), torch.arange(1000)).numpy()
    want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(
        jnp.asarray(key), i))(jnp.arange(1000)))
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_random_bits_match_jax(shape):
    key = rng.stream_key(3, 32)
    ids = np.arange(64)
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(lambda i: jax.random.bits(
            jax.random.fold_in(jnp.asarray(key), i), shape, jnp.uint64))(
                jnp.asarray(ids)))
    hi, lo = rng.random_bits(rng.fold_in(rng.as_key(key),
                                         torch.as_tensor(ids)), shape)
    got = ((hi.numpy().astype(np.uint64) << np.uint64(32))
           | lo.numpy().astype(np.uint64))
    np.testing.assert_array_equal(got, want)


def test_uniforms_bit_for_bit():
    key = rng.stream_key(0, 32)
    rows, cols = np.arange(40), np.arange(2500)
    cells = port_cells(key, rows, cols)
    want = jax_cells(key, rows, cols,
                     lambda k: jax.random.uniform(k, (), jnp.float64))
    np.testing.assert_array_equal(rng.uniform(cells).numpy(), want)
    lo = float(np.nextafter(-1.0, 0.0))
    want = jax_cells(key, rows[:4], cols, lambda k: jax.random.uniform(
        k, (), jnp.float64, lo, 1.0))
    np.testing.assert_array_equal(
        rng.uniform(cells[:4], (), lo, 1.0).numpy(), want)
    # a shaped draw from one key
    with jax.enable_x64(True):
        want = np.asarray(jax.random.uniform(jnp.asarray(key), (7, 3),
                                             jnp.float64))
    np.testing.assert_array_equal(
        rng.uniform(rng.as_key(key), (7, 3)).numpy(), want)


# ------------------------------------------------------------- normals
def test_normals_within_bound():
    key = rng.stream_key(0, 32)
    rows, cols = np.arange(40), np.arange(2500)
    want = jax_cells(key, rows, cols,
                     lambda k: jax.random.normal(k, (), jnp.float64))
    got = rng.normal(port_cells(key, rows, cols)).numpy()
    assert ulps(got, want) <= NORMAL_ULP
    # most draws are equal: the last ulps come from log and exp only
    assert np.mean(got != want) < 1e-3


def test_erfinv_against_lax():
    """Every branch of Giles' polynomial (w < 6.25, < 16, >= 16) and
    both of the Cephes log1p, up to |x| = 1."""
    g = np.random.default_rng(0)
    x = np.concatenate([
        g.uniform(-1, 1, 20000),
        1 - 10.0 ** g.uniform(-16, -2, 4000),
        -(1 - 10.0 ** g.uniform(-16, -2, 4000)),
        [0.0, 0.5, -0.5, np.nextafter(1.0, 0.0), -1.0, 1.0]])
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
        want_log = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(-x * x)))
    got = rng.erfinv(torch.as_tensor(x)).numpy()
    finite = np.abs(x) < 1
    assert ulps(got[finite], want[finite]) <= ERFINV_ULP
    np.testing.assert_array_equal(got[~finite], x[~finite]
                                  * np.finfo(np.float64).max)
    assert ulps(rng.log1p(torch.as_tensor(-x * x)).numpy()[finite],
                want_log[finite]) <= 1


def test_fma_is_rounded_once():
    g = np.random.default_rng(1)
    a, b, c = g.normal(size=(3, 3000)) * 10.0 ** g.integers(-8, 8, (3, 3000))
    # exact cancellations and ties of the product against the addend
    a[:100], b[:100] = 1.0 + 2.0 ** -30, 1.0 - 2.0 ** -30
    c[:100] = -1.0
    c[100:200] = -a[100:200] * b[100:200]
    got = rng.fma(torch.as_tensor(a), torch.as_tensor(b),
                  torch.as_tensor(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- grids
def test_noise_grid_within_bound():
    from repro.common.rng import lognormal_noise_grid

    key = rng.stream_key(0, rng.STREAM_CONTENTION)
    uids = np.asarray([config_uid(c) for c in all_configs()], np.int32)
    want = lognormal_noise_grid(key, len(WORKLOAD_NAMES), uids, 0.06)
    got = rng.lognormal_noise_grid(key, len(WORKLOAD_NAMES), uids,
                                   0.06).numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.max(np.abs(got / want - 1.0)) <= GRID_RTOL


def test_bounded_uniform_grid_within_bound():
    from repro.common.rng import bounded_uniform_grid

    key = rng.stream_key(0, rng.STREAM_WORKLOAD_PARAMS)
    lo = np.asarray([b[1] for b in PARAM_BOUNDS])
    hi = np.asarray([b[2] for b in PARAM_BOUNDS])
    want = bounded_uniform_grid(key, 18, lo, hi)
    got = rng.bounded_uniform_grid(key, 18, lo, hi).numpy()
    assert ulps(got, want) <= BOUNDED_ULP


def test_scout_grids_within_bound():
    from repro.tuning.scout import ScoutDataset as JaxScout

    want, got = JaxScout(seed=0), ScoutDataset(seed=0, device="cpu")
    assert got.workloads.keys() == want.workloads.keys()
    for w in WORKLOAD_NAMES:
        for name, v in want.workloads[w].items():
            assert abs(got.workloads[w][name] / v - 1.0) <= GRID_RTOL
    for name in ("base_runtime", "runtime", "cost", "lows"):
        a, b = getattr(got.grid, name), getattr(want.grid, name)
        assert np.max(np.abs(a / b - 1.0)) <= GRID_RTOL, name
    np.testing.assert_array_equal(got.grid.noise_key, want.grid.noise_key)
    np.testing.assert_array_equal(got.grid.config_uid, want.grid.config_uid)


def test_cuda_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoutDataset(seed=0)


# -------------------- the reference's tests/test_seeded_rng.py claims
def test_scout_dataset_call_order_independent():
    a = ScoutDataset(seed=0, device="cpu")
    b = ScoutDataset(seed=0, device="cpu")
    configs = a.configs
    for wl in WORKLOAD_NAMES:
        a.workload_arrays(wl)
    for wl in reversed(WORKLOAD_NAMES):
        b.runtime_s(wl, configs[-1])
        b.low_level_metrics(wl, configs[0])
        b.workload_arrays(wl)
    for wl in WORKLOAD_NAMES:
        for x, y in zip(a.workload_arrays(wl), b.workload_arrays(wl)):
            np.testing.assert_array_equal(x, y)
        for c in (configs[0], configs[7], configs[-1]):
            assert a.runtime_s(wl, c) == b.runtime_s(wl, c)


def test_noise_draws_are_per_cell_keyed():
    """A row drawn alone, a row of the grid and a grid drawn for fewer
    configurations agree bit for bit: a cell's draw is a pure function
    of (seed, workload, config uid)."""
    key = rng.stream_key(0, rng.STREAM_CONTENTION)
    uids = np.asarray([config_uid(c) for c in all_configs()], np.int64)
    grid = rng.lognormal_noise_grid(key, len(WORKLOAD_NAMES), uids, 0.06)
    row = rng.lognormal_noise_row(key, 3, torch.as_tensor(uids), 0.06)
    rows = rng.lognormal_noise_row(key, torch.arange(18),
                                   torch.as_tensor(uids), 0.06)
    np.testing.assert_array_equal(row.numpy(), grid[3].numpy())
    np.testing.assert_array_equal(rows.numpy(), grid.numpy())
    part = rng.lognormal_noise_grid(key, 5, uids[10:20], 0.06)
    np.testing.assert_array_equal(part.numpy(), grid[:5, 10:20].numpy())


def test_bounded_uniform_grid_is_per_cell_keyed():
    key = rng.stream_key(7, 1)
    lo, hi = np.asarray([0.0, 10.0]), np.asarray([1.0, 20.0])
    g = rng.bounded_uniform_grid(key, 4, lo, hi).numpy()
    assert g.shape == (4, 2)
    assert np.all((g >= lo) & (g <= hi))
    np.testing.assert_array_equal(
        rng.bounded_uniform_grid(key, 3, lo, hi).numpy(), g[:3])


def test_scout_seeds_differ_and_grid_matches_scalar_path():
    ds0 = ScoutDataset(seed=0, device="cpu")
    ds1 = ScoutDataset(seed=1, device="cpu")
    wl = WORKLOAD_NAMES[0]
    assert not np.array_equal(ds0.workload_arrays(wl)[0],
                              ds1.workload_arrays(wl)[0])
    for c in (ds0.configs[0], ds0.configs[33]):
        col = [cc.key for cc in ds0.configs].index(c.key)
        assert ds0.runtime_s(wl, c) == ds0.workload_arrays(wl)[0][col]


def test_offgrid_config_uses_the_same_draw():
    """An off-grid configuration draws its noise from the same fold-in
    chain, equal to JAX's within the grid bound."""
    from repro.tuning.scout import CloudConfig as JaxConfig
    from repro.tuning.scout import ScoutDataset as JaxScout
    from repro_torch.tuning.scout import CloudConfig

    got = ScoutDataset(seed=0, device="cpu")
    want = JaxScout(seed=0)
    for vm, n in (("m4.large", 30), ("r4.2xlarge", 1)):
        a = got.runtime_s(WORKLOAD_NAMES[2], CloudConfig(vm, n))
        b = want.runtime_s(WORKLOAD_NAMES[2], JaxConfig(vm, n))
        assert abs(a / b - 1.0) <= GRID_RTOL


def test_config_uid_stable_under_grid_extension():
    configs = all_configs()
    uids = [config_uid(c) for c in configs]
    assert len(set(uids)) == len(uids)
    assert all(u == VM_TYPES.index(c.vm_type) * 256 + c.count
               for u, c in zip(uids, configs))


# ----------------------------------------------------------- the alias
def test_x64_alias_leaves_nothing_behind():
    """The alias exists while this module runs and is gone after its
    context, also when the body raises; a native ``enable_x64`` is left
    alone."""
    je = jax.experimental
    assert je.enable_x64 is jax.enable_x64
    saved = je.__dict__.pop("enable_x64")
    try:
        assert not hasattr(je, "enable_x64")
        with _jax_x64.alias():
            assert je.enable_x64 is jax.enable_x64
        assert not hasattr(je, "enable_x64")
        with pytest.raises(KeyError):
            with _jax_x64.alias():
                raise KeyError("body")
        assert not hasattr(je, "enable_x64")
        native = object()
        je.enable_x64 = native
        with _jax_x64.alias():
            assert je.enable_x64 is native
        assert je.enable_x64 is native
        del je.enable_x64
    finally:
        je.enable_x64 = saved
