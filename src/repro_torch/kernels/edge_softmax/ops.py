"""Public wrapper of the edge-softmax aggregation (forward).

For CUDA tensors it launches the hand-written kernel of
``csrc/edge_softmax.cu`` on the current stream; for CPU tensors it
takes the plain version (``ref``). Nothing else picks the path: a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts the launches.

The kernel needs no padding (it masks the ragged edge of N itself),
and N=0 returns empty outputs without a launch, like
``repro/kernels/edge_softmax/ops.py``. The forward is not
differentiable on CUDA yet: a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.edge_softmax import ref

#: Kernel launches so far (a plain count; callers reset it to 0).
LAUNCHES = 0

MAX_CHANNELS = 128  # H * hd
MAX_PREDECESSORS = 8  # P
DTYPES = (torch.float32, torch.bfloat16)
MASK_DTYPES = (torch.bool, torch.uint8)

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("edge_softmax")
        fn = lib.edge_softmax_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.edge_softmax_error_string.argtypes = [ctypes.c_int]
        lib.edge_softmax_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.edge_softmax_error_string)
    return _FN


def _check(q, k, v, mask):
    if q.dim() != 3:
        raise ValueError(f"q must be (N, H, hd), got {tuple(q.shape)}")
    N, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != N or k.shape[2:] != (H, hd):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}: expected (N, P, H, hd)")
    P = k.shape[1]
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if mask.shape != (N, P):
        raise ValueError(f"mask {tuple(mask.shape)} != (N, P) {(N, P)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if mask.dtype not in MASK_DTYPES:
        raise TypeError(f"mask must be one of {MASK_DTYPES}, got "
                        f"{mask.dtype}")
    if hd & (hd - 1) or H * hd > MAX_CHANNELS:
        raise ValueError(f"the kernel takes hd a power of two and "
                         f"H*hd <= {MAX_CHANNELS}, got H={H}, hd={hd}")
    if not 1 <= P <= MAX_PREDECESSORS:
        raise ValueError(f"the kernel takes 1 <= P <= {MAX_PREDECESSORS}, "
                         f"got {P}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the CUDA edge-softmax kernel has no backward "
                           "yet: call it under torch.no_grad()")


def _launch(q, k, v, mask, scale):
    global LAUNCHES
    _check(q, k, v, mask)
    N, P, H, hd = k.shape
    out = torch.empty_like(q)
    att = torch.empty((N, H, P), dtype=torch.float32, device=q.device)
    if N == 0:  # empty graph: nothing to launch
        return out, att
    fn, error_string = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), att.data_ptr(), N, H, hd, P, float(scale),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"edge_softmax kernel launch failed: "
                           f"{error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out, att


def edge_softmax_aggregate(q, k, v, mask, scale=None):
    """Single-head: q (N, F); k/v (N, P, F) -> (out (N, F), att (N, P)).
    Multi-head: q (N, H, hd); k/v (N, P, H, hd) -> (out (N, H, hd),
    att (N, H, P)). mask: (N, P), shared across heads.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return ref.edge_softmax_aggregate(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"edge_softmax_aggregate runs on cpu or cuda, "
                         f"not {q.device}")
    single = q.dim() == 2
    if single:
        q, k, v = q[:, None, :], k[:, :, None, :], v[:, :, None, :]
    out, att = _launch(q, k, v, mask, scale)
    if single:
        return out[:, 0, :], att[:, 0, :]
    return out, att
