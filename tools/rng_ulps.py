#!/usr/bin/env python3
"""Measure how far the port's float64 draws sit from ``jax.random``'s on
the CPU, to state the bounds of ``tests/test_torch_rng.py`` and of
``chip_smoke.py`` phase [18a].

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rng_ulps.py

Over ``--draws`` normals ``fold_in(stream_key(0, 32), i)`` it prints,
against JAX's, how many differ and by how many ulp at most: the port's
``common.rng.normal``, and for contrast the inverse error function as
``torch.special.erfinv`` and as Giles' polynomial fed ``torch.log1p``
with unfused Horner steps, and fed XLA's own ``log1p`` values with
fused (emulated) steps. Then the scout grids of ``ScoutDataset(seed=0)``
against the JAX package's: the parameter grid, the noise grid, the
runtime, cost and lows grids (ulp and relative). Imports JAX (it is a
measurement against it, like the tests), never on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def _ulps(a, b):
    import numpy as np

    d = np.abs(np.ascontiguousarray(a, np.float64).view(np.int64)
               - np.ascontiguousarray(b, np.float64).view(np.int64))
    return int(np.sum(d > 0)), int(d.max())


def _giles(x, w, fused):
    """Giles' polynomial in ``w``, Horner steps fused or not."""
    import torch

    from repro_torch.common import rng

    lt6, lt16 = w < 6.25, w < 16.0
    shift = torch.where(lt16, torch.full_like(w, 3.25),
                        torch.full_like(w, 5.0))
    t = torch.where(lt6, w - 3.125, torch.sqrt(w) - shift)

    def coefficient(i):
        c = torch.full_like(x, rng._ERFINV_W6[i])
        if i < 19:
            c = torch.where(lt6, c, torch.full_like(x, rng._ERFINV_W16[i]))
        if i < 17:
            c = torch.where(lt16, c, torch.full_like(x, rng._ERFINV_WBIG[i]))
        return c

    def step(p, c):
        return rng.fma(p, t, c) if fused else c + p * t

    p = coefficient(0)
    for i in range(1, 23):
        q = step(p, coefficient(i))
        p = q if i < 17 else torch.where(lt16 if i < 19 else lt6, q, p)
    return p * x


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=200_000)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import _jax_x64
    from repro_torch.common import rng

    key = rng.stream_key(0, rng.STREAM_CONTENTION)
    ids = np.arange(args.draws)
    cells = rng.fold_in(rng.as_key(key), torch.as_tensor(ids))
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax.vmap(lambda i: jax.random.normal(
            jax.random.fold_in(jnp.asarray(key), i), (), jnp.float64)))(
                jnp.asarray(ids)))
    u = rng.uniform(cells, (), float(np.nextafter(-1.0, 0.0)), 1.0)
    with jax.enable_x64(True):
        xla_log = torch.as_tensor(np.array(jax.jit(
            lambda v: jnp.log1p(-v * v))(jnp.asarray(u.numpy()))))
    sqrt2 = float(np.sqrt(2.0))
    rows = {
        "port normal": rng.normal(cells),
        "torch.special.erfinv": sqrt2 * torch.special.erfinv(u),
        "Giles, torch.log1p, unfused":
            sqrt2 * _giles(u, -torch.log1p(-u * u), fused=False),
        "Giles, XLA's log1p, fused":
            sqrt2 * _giles(u, -xla_log, fused=True),
    }
    print(f"normals against jax.random.normal, {args.draws} draws:")
    for name, got in rows.items():
        n, m = _ulps(got.numpy(), want)
        print(f"  {name:30s} {n:7d} differ ({n / args.draws:.3%}), "
              f"max {m} ulp")

    with _jax_x64.alias():
        from repro.common.rng import lognormal_noise_grid
        from repro.tuning.scout import ScoutDataset as JaxScout
        from repro_torch.tuning.scout import (CONTENTION_SCALE,
                                              PARAM_BOUNDS, ScoutDataset)

        jds, tds = JaxScout(seed=0), ScoutDataset(seed=0, device="cpu")
        g = jds.grid
        jax_noise = lognormal_noise_grid(g.noise_key, len(g.runtime),
                                         g.config_uid, CONTENTION_SCALE)
    names = [b[0] for b in PARAM_BOUNDS]
    grids = {"params": (
        np.asarray([[tds.workloads[w][n] for n in names]
                    for w in tds.workloads]),
        np.asarray([[jds.workloads[w][n] for n in names]
                    for w in jds.workloads])),
        "noise": (rng.lognormal_noise_grid(g.noise_key, len(g.runtime),
                                           g.config_uid,
                                           CONTENTION_SCALE).numpy(),
                  jax_noise)}
    for name in ("base_runtime", "runtime", "cost", "lows"):
        grids[name] = (getattr(tds.grid, name), getattr(jds.grid, name))
    print("ScoutDataset(seed=0) against the JAX package's:")
    for name, (got, ref) in grids.items():
        n, m = _ulps(got, ref)
        rel = float(np.max(np.abs(got / ref - 1.0)))
        print(f"  {name:12s} {n:5d} of {got.size} differ, max {m} ulp, "
              f"max relative {rel:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
