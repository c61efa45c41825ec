"""Counter-based RNG streams: order-independent, placement-independent
draws shared by the host simulators and the device replay program.

Every stochastic quantity of the scenario stack is a *pure function* of
a fold-in chain over the threefry2x32 counter-based generator of
``jax.random`` (its default PRNG), rebuilt here on tensors:

    value = f(fold_in(fold_in(root(seed), stream_tag), id0, id1, ...))

No hidden stream state means no call-order dependence: the draw a
(workload, configuration) cell gets is the same whether it is queried
first or last, by the sequential tuner or inside the seeded replay.

The device half works on int64 tensors that hold uint32 words (masked
to ``0xFFFFFFFF``; torch's ``uint32`` has no arithmetic). A key is a
``(..., 2)`` tensor of words. :func:`threefry2x32`, :func:`fold_in`,
:func:`random_bits` (JAX's partitionable layout,
``jax_threefry_partitionable=True``), :func:`split`, the 32-bit words of
:func:`random_bits32`, the int32 :func:`randint`, the float64
:func:`uniform`, the float32 :func:`uniform32` and :func:`bernoulli`
equal JAX's bit for bit. :func:`normal` is JAX's ``sqrt(2) *
erf_inv(u)``: :func:`erfinv` is Giles' double-precision polynomial
with every Horner step an exact fused multiply-add (:func:`fma`,
emulated with error-free transforms, so the CPU and the card round
alike) fed by XLA's ``log1p`` (:func:`log1p`: the Cephes rational
below sqrt(2) - 1, ``log(1 + x)`` above). What is left to the device is
``log`` above that threshold and ``exp``, each within an ulp, so
normals stay within a few ulp of JAX's (``tests/test_torch_rng.py``
states the bound). Each grid is drawn at one shape on one device, so a
consumer that draws the same grid on the same device gets the same
bits.

The host-side fingerprint simulators draw from :func:`folded_generator`,
an independent ``np.random.Generator`` derived from a hashable path
(ints and strings), so per-group draws are a pure function of ``(seed,
round, benchmark_type, machine_type)`` rather than a position in one
shared stream.
"""

from __future__ import annotations

import hashlib
from typing import Tuple, Union

import numpy as np
import torch

# fold_in stream tags: one per stochastic quantity, so streams never
# collide even for equal entity ids
# stream tags pick the realization; values are arbitrary but fixed —
# bumping one re-rolls every draw downstream of that stream
STREAM_WORKLOAD_PARAMS = 31  # scout workload latent demand vectors
STREAM_CONTENTION = 32  # scout per-(workload, config) contention noise
STREAM_ARRIVALS = 33  # fleet telemetry arrival-process jitter
STREAM_FAULTS = 34  # fleet fault-injection decisions (fleet.faults)
STREAM_RETRY = 35  # scorer retry-backoff jitter (fleet.service)


# --------------------------------------------------------------- device
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def root_key(seed: int, device="cpu") -> torch.Tensor:
    """The raw threefry root key of a dataset seed, ``(2,)`` words as
    ``jax.random.PRNGKey(seed)`` makes it with 64-bit mode off: the seed
    as an int32, so the high word is 0."""
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def stream_key(seed: int, stream_tag: int) -> np.ndarray:
    """``fold_in(root(seed), stream_tag)`` as a host uint32 array, the
    per-quantity key handed to the device draws."""
    return fold_in(root_key(seed), stream_tag).numpy().astype(np.uint32)


def as_key(key, device=None) -> torch.Tensor:
    """A key (uint32 array or word tensor) as an int64 word tensor; a
    tensor already on ``device`` is not copied."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device if device is not None else key.device,
                      dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the count words ``(x1, x2)`` under the
    key words ``(k1, k2)`` (JAX's ``_threefry2x32_lowering``): five
    groups of four rounds, a key injection after each. Word tensors
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count ``(0, data)`` (the
    uint32 ``data`` as threefry's seed pair) under ``key``. ``key``
    ``(..., 2)`` and ``data`` (an int or an integer tensor) broadcast."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & _MASK
    else:
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape=()):
    """64 random bits a draw as ``(hi, lo)`` word tensors of shape
    ``key.shape[:-1] + shape``, in JAX's partitionable layout: draw
    ``n`` (row-major) hashes the count ``(n >> 32, n & 0xFFFFFFFF)``,
    and the hash's two words are the high and the low half."""
    n = int(np.prod(shape, dtype=np.int64))
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    hi, lo = threefry2x32(k[..., 0], k[..., 1],
                          (count >> 32).reshape(shape),
                          (count & _MASK).reshape(shape))
    return torch.broadcast_tensors(hi, lo)


def uniform(key: torch.Tensor, shape=(), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """float64 uniforms in ``[minval, maxval)`` (JAX's ``_uniform``):
    the high 52 of the 64 bits as the mantissa of a float in [1, 2),
    minus 1, scaled and shifted, floored at ``minval``."""
    hi, lo = random_bits(key, shape)
    bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
    floats = bits.view(torch.float64) - 1.0
    lo_t = torch.full((), minval, dtype=torch.float64, device=key.device)
    hi_t = torch.full((), maxval, dtype=torch.float64, device=key.device)
    return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` of one ``(2,)`` key: ``(n, 2)`` keys,
    key i the hash of the count ``(i >> 32, i & 0xFFFFFFFF)``, both words
    (the partitionable layout's fold-like split)."""
    hi, lo = random_bits(key, (n,))
    return torch.stack([hi, lo], dim=-1)


def random_bits32(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits a draw (JAX's ``random_bits(key, 32, shape)`` in
    the partitionable layout): the xor of the two words of draw n's
    hash, as int64 words in ``[0, 2**32)``."""
    hi, lo = random_bits(key, shape)
    return hi ^ lo


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)`` (JAX's ``_randint`` for
    int32): two sets of 32-bit words from ``split(key)``, folded as
    ``(hi % span * (2**32 % span) + lo % span) % span`` in uint32
    arithmetic (wrapping), plus ``minval``; ``span`` is 1 when
    ``maxval <= minval``."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval <= maxval < 2 ** 31 and maxval > minval:
        raise ValueError(f"randint takes int32 bounds, got [{minval}, "
                         f"{maxval})")
    span = maxval - minval if maxval > minval else 1
    k1, k2 = split(key)
    higher, lower = random_bits32(k1, shape), random_bits32(k2, shape)
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    out = (offset + minval) & _MASK
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def uniform32(key: torch.Tensor, shape=()) -> torch.Tensor:
    """float32 uniforms in ``[0, 1)`` (JAX's ``_uniform`` for float32):
    the high 23 of 32 bits as the mantissa of a float in [1, 2), minus
    1."""
    bits = (random_bits32(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a python float ``p``
    (float32): a float32 uniform below ``float32(p)``."""
    return uniform32(key, shape) < torch.tensor(p, dtype=torch.float32,
                                                 device=key.device)


# error-free transforms: an FMA rounded once, on any device
_SPLITTER = 134217729.0  # 2^27 + 1


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _add_round_to_odd(a, b):
    """``a + b`` rounded to odd: toward zero, then the last mantissa
    bit set where the sum was inexact."""
    s, e = _two_sum(a, b)
    bits = s.view(torch.int64)
    inexact = e != 0
    over = inexact & ((e < 0) != (s < 0))  # |s| > |a + b|
    bits = torch.where(over, bits - 1, bits)
    return torch.where(inexact, bits | 1, bits).view(torch.float64)


def fma(a, b, c):
    """``a * b + c`` rounded once (float64), from error-free transforms
    (Boldo and Melquiond, "Emulation of FMA and correctly rounded sums:
    proved algorithms using rounding to odd", IEEE TC 2008). No torch
    op promises a fused multiply-add on every device; this does."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_round_to_odd(tl, ul)


def _horner(x, coefficients):
    p = torch.full_like(x, coefficients[0])
    for c in coefficients[1:]:
        p = fma(p, x, torch.full_like(x, c))
    return p


# Cephes log1p (unity.c): numerator and denominator, highest degree first
_LOG1P_NUM = (4.5270000862445199635E-5, 4.9854102823193375972E-1,
              6.5787325942061044846E0, 2.9911919328553073277E1,
              6.0949667980987787057E1, 5.7112963590585538103E1,
              2.0039553499201281259E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469E1,
              2.2176239823732856465E2, 3.0909872225312059774E2,
              2.1642788614495947685E2, 6.0118660497603843919E1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``log1p``: below sqrt(2) - 1 in magnitude the
    Cephes rational ``x - x^2/2 + x^3 P(x)/Q(x)`` with fused Horner
    steps, above it ``log(1 + x)``."""
    x2 = x * x
    ratio = (_horner(x, _LOG1P_NUM)
             / _horner(x, _LOG1P_DEN))
    small = x + (-0.5 * x2 + (x * x2) * ratio)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# double precision: w < 6.25, w < 16, else; highest degree first
_ERFINV_W6 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV_W16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV_WBIG = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float64 inverse error function in XLA's evaluation: Giles'
    three-branch polynomial in ``w = -log1p(-x*x)``, one coefficient
    table selected per element, every Horner step a fused
    multiply-add, ``p * x``; ``erfinv(+-1)`` is ``+-1.8e308``."""
    w = -log1p(-x * x)
    lt6 = w < 6.25
    lt16 = w < 16.0
    shift = torch.where(lt16, torch.full_like(w, 3.25),
                        torch.full_like(w, 5.0))
    t = torch.where(lt6, w - 3.125, torch.sqrt(w) - shift)

    def coefficient(i):
        c = torch.full_like(x, _ERFINV_W6[i])
        if i < 19:
            c = torch.where(lt6, c, torch.full_like(x, _ERFINV_W16[i]))
        if i < 17:
            c = torch.where(lt16, c, torch.full_like(x, _ERFINV_WBIG[i]))
        return c

    p = coefficient(0)
    for i in range(1, 17):
        p = fma(p, t, coefficient(i))
    for i in range(17, 19):
        p = torch.where(lt16, fma(p, t, coefficient(i)), p)
    for i in range(19, 23):
        p = torch.where(lt6, fma(p, t, coefficient(i)), p)
    return torch.where(x.abs() == 1.0, x * np.finfo(np.float64).max, p * x)


_NORMAL_LO = float(np.nextafter(-1.0, 0.0))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """float64 standard normals (JAX's ``_normal_real``): ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform in ``(-1, 1)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return float(np.sqrt(2.0)) * erfinv(u)


def lognormal_noise_row(key_stream, wid, uids, scale) -> torch.Tensor:
    """Contention-noise factors ``exp(scale * N(0,1))`` for one
    workload over a vector of config uids, each drawn from
    ``fold_in(fold_in(key_stream, wid), uid)``. ``key_stream`` is the
    stream key, ``wid`` a workload id (int or tensor), ``uids`` an
    integer tensor on the key's device."""
    key_w = fold_in(as_key(key_stream, uids.device), wid)
    keys = fold_in(key_w.unsqueeze(-2), uids)
    return torch.exp(scale * normal(keys))


def lognormal_noise_grid(key_stream, n_workloads: int, uids,
                         scale: float, device="cpu") -> torch.Tensor:
    """The full ``(n_workloads, len(uids))`` contention-noise grid on
    ``device``: row ``w`` is :func:`lognormal_noise_row` for ``wid=w``,
    drawn for every row at once. With the key and ``uids`` already
    tensors on ``device`` nothing is copied from the host."""
    if not isinstance(uids, torch.Tensor):
        uids = torch.as_tensor(np.asarray(uids, np.int64), device=device)
    wids = torch.arange(n_workloads, dtype=torch.int64, device=device)
    key = fold_in(as_key(key_stream, device), wids)  # (W, 2)
    keys = fold_in(key.unsqueeze(1), uids)  # (W, C, 2)
    return torch.exp(scale * normal(keys))


def bounded_uniform_grid(key_stream, n_rows: int, lo, hi,
                         device="cpu") -> torch.Tensor:
    """``(n_rows, len(lo))`` grid of bounded uniforms on ``device``:
    cell (r, p) is ``lo[p] + (hi[p] - lo[p]) * U(fold_in(fold_in(key,
    r), p))``, the product and sum fused as XLA fuses them; row ``r``
    depends only on ``r``, never on how many rows exist."""
    lo = torch.as_tensor(np.asarray(lo, np.float64), device=device)
    hi = torch.as_tensor(np.asarray(hi, np.float64), device=device)
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
    cols = torch.arange(len(lo), dtype=torch.int64, device=device)
    key = fold_in(as_key(key_stream, device), rows)
    u = uniform(fold_in(key.unsqueeze(1), cols))
    return fma(hi - lo, u, lo.expand_as(u))


# ----------------------------------------------------------------- host
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
