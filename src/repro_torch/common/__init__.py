"""Shared primitives: pow2 bucketing, counter-based RNG streams (host and
device), padded batch axes, device choice."""
