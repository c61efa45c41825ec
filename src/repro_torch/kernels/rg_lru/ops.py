"""Public wrapper of the RG-LRU linear scan, forward and backward.

For CUDA tensors it launches the hand-written kernels of
``csrc/rg_lru.cu`` on the current stream; for CPU tensors it takes the
plain versions (``ref``). Nothing else picks the path: a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts the forward's
launches and ``BWD_LAUNCHES`` the backward's, one a call each.

The kernel is a single-pass, chunk-parallel scan with a decoupled
look-back, bound by the bytes of a, b and y:

- a block owns a tile of ``TILE_STEPS`` steps (a chunk) by
  ``TILE_CHANNELS`` channels of one batch row, loads all its a and b
  into registers first, and takes its tile from a global ticket counter,
  chunk-major, so that every tile it waits on is already running;
- it publishes its chunk's aggregate (A = prod a, H = the chunk's scan
  from 0), looks back to the nearest published prefix, runs the
  recursion P_i = A_i P_{i-1} + H_i forwards from there (so every P_i
  is the same expression in the same order, and y is bit-identical from
  run to run), publishes its own prefix and rescans the tile from
  P_{k-1}. ``ref.linear_scan_chunked`` is the same order in plain
  PyTorch, for the tests.

The wrapper allocates the scratch with ``torch.empty``, sized by
:func:`scratch_bytes`: A, H and P per (b, chunk, channel), then the
tiles' flags and the ticket counter, which the launcher zeroes on the
stream before the kernel. Unlike
``repro/kernels/rg_lru/kernel.py`` (which asks ``S % 256 == 0`` past 256
steps) the kernel takes any S >= 1 and any C, and the wrapper pads
nothing.

On CUDA, :func:`linear_scan` is the ``autograd.Function`` ``_Scan``: its
forward launches the scan and saves a, y and h0 with
``ctx.save_for_backward`` (so non-reentrant ``torch.utils.checkpoint``
drops and recomputes them), and its backward launches the backward
kernel (:func:`linear_scan_bwd`): the same look-back walked from the
last chunk, over dh_t = a_{t+1} dh_{t+1} + g_t from dh_{S-1} = g_{S-1} +
g_last, giving db = dh, da_t = dh_t h_{t-1} and dh0 = a_0 dh_0. It is
the counterpart of the reference's VJP
(``repro/kernels/rg_lru/ops.py::_scan_bwd``, ``jax.vjp`` of its plain
scan). On the CPU autograd runs through the plain loop.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rg_lru import ref

#: Kernel launches so far, forward and backward (plain counts; callers
#: reset them to 0).
LAUNCHES = 0
BWD_LAUNCHES = 0

#: The kernel's tile (``kSteps``, ``kThreads`` of ``csrc/rg_lru.cu``;
#: :func:`tile` reads the built kernel's).
TILE_STEPS, TILE_CHANNELS = 32, 128

_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        lib = build.load("rg_lru")
        fn = lib.rg_lru_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.rg_lru_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.rg_lru_scratch_bytes.restype = ctypes.c_longlong
        lib.rg_lru_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.rg_lru_tile.restype = None
        bwd = lib.rg_lru_scan_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 9
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        for attrs in (lib.rg_lru_attributes, lib.rg_lru_bwd_attributes):
            attrs.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
            attrs.restype = ctypes.c_int
        lib.rg_lru_error_string.argtypes = [ctypes.c_int]
        lib.rg_lru_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _error(lib, rc):
    return f"{lib.rg_lru_error_string(rc).decode()} ({rc})"


def scratch_bytes(B: int, S: int, C: int) -> int:
    """Bytes of device scratch one call at these shapes allocates: A, H
    and P per (b, chunk, channel), then the tiles' flags and the ticket
    counter."""
    return _kernel().rg_lru_scratch_bytes(B, S, C)


def tile() -> tuple:
    """(steps, channels) of the built kernel's tile."""
    steps, channels = ctypes.c_int(), ctypes.c_int()
    _kernel().rg_lru_tile(ctypes.byref(steps), ctypes.byref(channels))
    return steps.value, channels.value


def attributes(backward: bool = False) -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block, of the forward kernel or of the backward
    (``cudaFuncGetAttributes``)."""
    lib = _kernel()
    out = [ctypes.c_int() for _ in range(4)]
    fn = lib.rg_lru_bwd_attributes if backward else lib.rg_lru_attributes
    rc = fn(*(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: {_error(lib, rc)}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), (x.value for x in out)))


def _check(a, b, h0, named=()):
    """a, b, h0 and any ``named`` (name, tensor) pairs (None for one that
    is absent): float32, contiguous, on a's device, (B, C) for h0 and
    g_last and (B, S, C) for the rest."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, C), got {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} != a {tuple(a.shape)}")
    B, S, C = a.shape
    if min(B, S, C) < 1:
        raise ValueError(f"the kernel takes B, S, C >= 1, got {(B, S, C)}")
    named = [("a", a), ("b", b), ("h0", h0), *named]
    for name, t in named:
        if t is None:
            continue
        want = (B, C) if name in ("h0", "g_last") else (B, S, C)
        if t.shape != want:
            raise ValueError(f"{name} {tuple(t.shape)} != {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(entry, a, *tensors):
    """Launches the C entry ``entry`` on the tensors' pointers (None for
    an absent one), a fresh scratch, a's shape and a's current stream;
    raises on a launch the runtime refused."""
    B, S, C = a.shape
    lib = _kernel()
    scratch = torch.empty(scratch_bytes(B, S, C), dtype=torch.uint8,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, entry)(*map(_ptr, tensors), scratch.data_ptr(),
                                 B, S, C, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: {_error(lib, rc)}")


def _launch(a, b, h0):
    global LAUNCHES
    _check(a, b, h0)
    y = torch.empty_like(a)
    h_last = a.new_empty((a.shape[0], a.shape[2]))
    _call("rg_lru_scan_fwd", a, a, b, h0, y, h_last)
    LAUNCHES += 1
    return y, h_last


def _launch_bwd(a, y, h0, g_y, g_last, with_dh0):
    global BWD_LAUNCHES
    _check(a, y, h0, [("g_y", g_y), ("g_last", g_last)])
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0) if with_dh0 else None
    _call("rg_lru_scan_bwd", a, a, y, h0, g_y, g_last, da, db, dh0)
    BWD_LAUNCHES += 1
    return da, db, dh0


class _Scan(torch.autograd.Function):
    """The scan on the card under autograd: the forward kernel, then the
    backward kernel from the saved a, y and h0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.set_materialize_grads(False)
        y, h_last = _launch(a, b, h0)
        ctx.save_for_backward(a, y, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, g_y, g_last):
        a, y, h0 = ctx.saved_tensors
        # the model casts y to its compute type, so g_y may come narrower
        g_y = (torch.zeros_like(a) if g_y is None
               else g_y.to(torch.float32).contiguous())
        if g_last is not None:
            g_last = g_last.to(torch.float32).contiguous()
        return _launch_bwd(a, y, h0, g_y, g_last, ctx.needs_input_grad[2])


def _route(a):
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_scan runs on cpu or cuda, not {a.device}")
    return a.device.type


def linear_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t. a, b: (B, S, C) float32; h0: optional
    (B, C) float32 (zeros when None). Returns (y (B, S, C), h_last
    (B, C)), both float32, differentiable in a, b and h0."""
    if _route(a) == "cpu":
        return ref.linear_scan(a, b, h0)
    return _Scan.apply(a, b, h0)


def linear_scan_bwd(a, y, h0, g_y, g_last=None):
    """The scan's gradient: (da, db (B, S, C), dh0 (B, C) or None when h0
    is None) from a, the forward's y, h0 and the cotangents g_y of y
    (B, S, C) and g_last of h_last (B, C) or None; float32."""
    if _route(a) == "cpu":
        return ref.linear_scan_bwd(a, y, h0, g_y, g_last)
    return _launch_bwd(a, y, h0, g_y, g_last, h0 is not None)
