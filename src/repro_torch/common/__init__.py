"""Shared primitives: pow2 bucketing, host RNG streams, device choice."""
