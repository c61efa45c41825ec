"""Public wrapper of the edge-softmax aggregation, forward and backward.

For CUDA tensors it launches the hand-written kernels of
``csrc/edge_softmax.cu`` on the current stream; for CPU tensors it
takes the plain versions (``ref``). Nothing else picks the path: a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts the forward
kernel's launches and ``BWD_LAUNCHES`` the backward's.

A call that needs a gradient goes through :class:`EdgeSoftmax`, the
counterpart of the reference's custom VJP
(``repro/kernels/edge_softmax/ops.py:34-74``): its forward saves
``(q, k, v, att)`` and its backward computes the gradients from the
saved ``att`` (the softmax is not recomputed, the forward not re-run).
A call without grad launches the forward kernel alone, as before.

The kernels need no padding (they mask the ragged edge of N
themselves), and N=0 returns empty outputs without a launch, like
``repro/kernels/edge_softmax/ops.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.edge_softmax import ref

#: Kernel launches so far (plain counts; callers reset them to 0).
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_CHANNELS = 128  # H * hd
MAX_PREDECESSORS = 8  # P
DTYPES = (torch.float32, torch.bfloat16)
MASK_DTYPES = (torch.bool, torch.uint8)

_FN = None


def _kernel():
    """(forward, backward, error_string) of the built library."""
    global _FN
    if _FN is None:
        lib = build.load("edge_softmax")
        dims = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.edge_softmax_fwd.argtypes = [ctypes.c_void_p] * 6 + dims
        lib.edge_softmax_bwd.argtypes = [ctypes.c_void_p] * 9 + dims
        for fn in (lib.edge_softmax_fwd, lib.edge_softmax_bwd):
            fn.restype = ctypes.c_int
        lib.edge_softmax_error_string.argtypes = [ctypes.c_int]
        lib.edge_softmax_error_string.restype = ctypes.c_char_p
        _FN = (lib.edge_softmax_fwd, lib.edge_softmax_bwd,
               lib.edge_softmax_error_string)
    return _FN


def _raise_on(rc, what, error_string):
    if rc != 0:
        raise RuntimeError(f"edge_softmax {what} kernel launch failed: "
                           f"{error_string(rc).decode()} ({rc})")


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


def _check_bwd(q, att, g_out, g_att):
    """The backward's own inputs; q, k, v passed ``_check`` forward."""
    N, H, _ = q.shape
    if g_out.shape != q.shape or g_out.dtype != q.dtype:
        raise ValueError(f"g_out {tuple(g_out.shape)} {g_out.dtype} does "
                         f"not match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("att", att), ("g_att", g_att)):
        if t is None:
            continue
        if t.dim() != 3 or t.shape[:2] != (N, H) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (N, H, P) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("att", att), ("g_out", g_out), ("g_att", g_att)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch(q, k, v, mask, scale):
    global LAUNCHES
    _check(q, k, v, mask)
    N, P, H, hd = k.shape
    out = torch.empty_like(q)
    att = torch.empty((N, H, P), dtype=torch.float32, device=q.device)
    if N == 0:  # empty graph: nothing to launch
        return out, att
    fwd, _, error_string = _kernel()
    with torch.cuda.device(q.device):
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), att.data_ptr(), N, H, hd, P, float(scale),
                 int(q.dtype == torch.bfloat16), _stream(q.device))
    _raise_on(rc, "forward", error_string)
    LAUNCHES += 1
    return out, att


def _launch_bwd(q, k, v, att, g_out, g_att, scale):
    """(dq, dk, dv) from the backward kernel; ``g_att`` may be None."""
    global BWD_LAUNCHES
    _check_bwd(q, att, g_out, g_att)
    N, P, H, hd = k.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if N == 0:  # empty graph: nothing to launch
        return dq, dk, dv
    _, bwd, error_string = _kernel()
    with torch.cuda.device(q.device):
        rc = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), att.data_ptr(),
                 g_out.data_ptr(),
                 None if g_att is None else g_att.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), N, H, hd, P,
                 float(scale), int(q.dtype == torch.bfloat16),
                 _stream(q.device))
    _raise_on(rc, "backward", error_string)
    BWD_LAUNCHES += 1
    return dq, dk, dv


def _forward(q, k, v, mask, scale):
    if q.device.type == "cpu":
        return ref.edge_softmax_aggregate(q, k, v, mask, scale)
    return _launch(q, k, v, mask, scale)


def _backward(q, k, v, att, g_out, g_att, scale):
    if q.device.type == "cpu":
        return ref.edge_softmax_backward(q, k, v, att, g_out, g_att, scale)
    return _launch_bwd(q, k, v, att, g_out.contiguous(),
                       None if g_att is None else g_att.contiguous(), scale)


class EdgeSoftmax(torch.autograd.Function):
    """The multi-head layout with a gradient: the kernels on the card,
    the plain versions on the CPU. ``mask`` gets no gradient; a
    cotangent autograd does not hand over (``att`` unused, as in the
    model) is a zero, passed to the kernel as a null pointer."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        out, att = _forward(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, att)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return out, att

    @staticmethod
    def backward(ctx, g_out, g_att):
        q, k, v, att = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(q)
        dq, dk, dv = _backward(q, k, v, att, g_out, g_att, ctx.scale)
        return dq, dk, dv, None, None


def edge_softmax_aggregate(q, k, v, mask, scale=None):
    """Single-head: q (N, F); k/v (N, P, F) -> (out (N, F), att (N, P)).
    Multi-head: q (N, H, hd); k/v (N, P, H, hd) -> (out (N, H, hd),
    att (N, H, P)). mask: (N, P), shared across heads.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"edge_softmax_aggregate runs on cpu or cuda, "
                         f"not {q.device}")
    single = q.dim() == 2
    if single:
        q, k, v = q[:, None, :], k[:, :, None, :], v[:, :, None, :]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, att = EdgeSoftmax.apply(q, k, v, mask, scale)
    else:
        out, att = _forward(q, k, v, mask, scale)
    if single:
        return out[:, 0, :], att[:, 0, :]
    return out, att
