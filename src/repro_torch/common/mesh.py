"""Host half of ``repro/common/mesh.py``: padded batch-axis sizing and
the stacked request buffers (numpy bodies copied).

- :func:`shard_size` — the padded batch-axis length for a device list:
  the smallest power of two that is >= the row count, >= ``floor`` and
  divisible by the device count;
- :func:`pad_lanes` / :func:`stack_padded` — build the padded batch
  buffers.

The reference's mesh half (``build_mesh``, ``shard_map_1d``,
``axis_specs``) has no counterpart: the port splits a stacked batch by
hand (``fleet.shard.ShardedScorer``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.common.bucketing import next_pow2


def shard_size(n: int, n_devices: int = 1, floor: int = 1) -> int:
    """Padded batch-axis length: smallest power of two >= ``n`` that is
    also >= ``floor`` and divisible by the (pow2) device count."""
    return next_pow2(n, max(floor, n_devices, 1))


def pad_lanes(a: np.ndarray, size: int) -> np.ndarray:
    """Pad axis 0 to ``size`` rows by repeating row 0 — for batch axes
    whose padding must stay numerically well-formed. Padded rows are
    masked out / sliced off by the caller."""
    if len(a) == size:
        return a
    reps = np.repeat(a[:1], size - len(a), axis=0)
    return np.concatenate([a, reps], axis=0)


def stack_padded(inputs: Sequence[Dict[str, np.ndarray]],
                 size: int) -> Dict[str, np.ndarray]:
    """Stack per-request input dicts along a new leading axis of
    ``size`` rows (zero rows past ``len(inputs)``)."""
    first = inputs[0]
    out = {k: np.zeros((size,) + v.shape, v.dtype)
           for k, v in first.items()}
    for r, d in enumerate(inputs):
        for k, v in d.items():
            out[k][r] = v
    return out
