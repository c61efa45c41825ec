"""Shape-bucketing primitive of the pow2-padding sites.

``serving.FingerprintEngine`` pads each scoring batch to a power-of-two
row bucket, as the JAX package does, so that the outputs and the
per-bucket timings of both packages line up.
"""

from __future__ import annotations


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor). ``floor`` must itself be
    a power of two."""
    return max(floor, 1 << max(n - 1, 0).bit_length())
