"""Public wrapper of the RG-LRU linear scan (forward).

For CUDA tensors it launches the hand-written kernel of
``csrc/rg_lru.cu`` on the current stream; for CPU tensors it takes the
plain version (``ref``). Nothing else picks the path: a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts the launches, one a
call.

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
nothing. The forward is not differentiable on CUDA yet: a call that
would need a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rg_lru import ref

#: Kernel launches so far (a plain count; callers reset it to 0).
LAUNCHES = 0

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
        lib.rg_lru_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.rg_lru_attributes.restype = ctypes.c_int
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


def attributes() -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block, of the kernel (``cudaFuncGetAttributes``)."""
    lib = _kernel()
    out = [ctypes.c_int() for _ in range(4)]
    rc = lib.rg_lru_attributes(*(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: {_error(lib, rc)}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), (x.value for x in out)))


def _check(a, b, h0):
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, C), got {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} != a {tuple(a.shape)}")
    B, S, C = a.shape
    if min(B, S, C) < 1:
        raise ValueError(f"the kernel takes B, S, C >= 1, got {(B, S, C)}")
    if h0 is not None and h0.shape != (B, C):
        raise ValueError(f"h0 {tuple(h0.shape)} != (B, C) {(B, C)}")
    named = [("a", a), ("b", b)] + ([("h0", h0)] if h0 is not None else [])
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise RuntimeError("the CUDA RG-LRU kernel has no backward yet: "
                           "call it under torch.no_grad()")


def _launch(a, b, h0):
    global LAUNCHES
    _check(a, b, h0)
    B, S, C = a.shape
    y = torch.empty_like(a)
    h_last = torch.empty((B, C), dtype=torch.float32, device=a.device)
    lib = _kernel()
    scratch = torch.empty(scratch_bytes(B, S, C), dtype=torch.uint8,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rg_lru_scan_fwd(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), scratch.data_ptr(), B, S, C, stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru kernel launch failed: {_error(lib, rc)}")
    LAUNCHES += 1
    return y, h_last


def linear_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t. a, b: (B, S, C) float32; h0: optional
    (B, C) float32 (zeros when None). Returns (y (B, S, C), h_last
    (B, C)), both float32."""
    if a.device.type == "cpu":
        return ref.linear_scan(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cpu or cuda, not {a.device}")
    return _launch(a, b, h0)
