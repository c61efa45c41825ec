"""Host half of the counter-based RNG streams (numpy only).

The fingerprint simulators draw from :func:`folded_generator`, an
independent ``np.random.Generator`` derived from a hashable path (ints
and strings), so per-group draws are a pure function of ``(seed, round,
benchmark_type, machine_type)`` rather than a position in one shared
stream. The ``STREAM_*`` tags are the fixed fold-in tags of the JAX
package's scenario streams; the ``jax.random`` grids that use them come
with the port of the configuration search.
"""

from __future__ import annotations

import hashlib
from typing import Tuple, Union

import numpy as np

# fold_in stream tags: one per stochastic quantity, so streams never
# collide even for equal entity ids
# stream tags pick the realization; values are arbitrary but fixed —
# bumping one re-rolls every draw downstream of that stream
STREAM_WORKLOAD_PARAMS = 31  # scout workload latent demand vectors
STREAM_CONTENTION = 32  # scout per-(workload, config) contention noise
STREAM_ARRIVALS = 33  # fleet telemetry arrival-process jitter
STREAM_FAULTS = 34  # fleet fault-injection decisions (fleet.faults)
STREAM_RETRY = 35  # scorer retry-backoff jitter (fleet.service)


PathElem = Union[int, np.integer, str]


def _entropy(x: PathElem) -> int:
    """A path element as SeedSequence entropy: ints pass through,
    strings hash stably (blake2s, platform-independent)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & ((1 << 64) - 1)
    digest = hashlib.blake2s(str(x).encode()).digest()
    return int.from_bytes(digest[:8], "little")


def folded_generator(*path: PathElem) -> np.random.Generator:
    """An independent numpy Generator keyed by a fold-in style path of
    ints/strings — e.g. ``folded_generator(seed, round, btype, mtype)``.
    Equal paths give equal streams; the draw order of *other* paths'
    generators is irrelevant."""
    return np.random.default_rng(
        np.random.SeedSequence([_entropy(x) for x in path]))


def as_generator(rng) -> np.random.Generator:
    """Accept a ``np.random.Generator`` as-is, an int seed, or a
    fold-in path tuple (via :func:`folded_generator`) — lets the
    benchmark-tool simulators take order-independent key paths without
    changing their call signature."""
    if isinstance(rng, np.random.Generator):
        return rng
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    return folded_generator(*tuple(rng))


def path_tuple(*path: PathElem) -> Tuple[PathElem, ...]:
    """Convenience constructor so call sites read as key derivations."""
    return tuple(path)
