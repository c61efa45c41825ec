"""Public wrapper of the chunkwise mLSTM (fresh state), forward and
backward.

:func:`mlstm_chunkwise` takes the model's layout, q/k/v ``(B, S, H,
hd)`` and gates ``(B, S, H)``, as the reference's ``ops`` does. For
CUDA tensors it launches the hand-written kernel of ``csrc/mlstm.cu``
on the current stream, which reads that layout in place; for CPU
tensors it takes the plain version (``ref``, in the kernel's layout
``(B*H, S, hd)``). Nothing else picks the path: a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts the forward's launches (one
call, four passes of either route) and ``BWD_LAUNCHES`` the
backward's.

:func:`route` names the kernel by the input type: bfloat16 (what
serving runs) goes to the tensor-core route (``wgmma`` with float32
accumulators, operands by TMA), float32 to the CUDA-core route, whose
checks are held at 2e-5, closer than tensor cores reach from float32
inputs. Neither stands in for the other.

Both take any S >= 1 in chunks of ``min(chunk, S)`` rows with a short
last chunk (the reference's Pallas kernel asks ``S % chunk == 0``); the
wrapper pads nothing. The kernel takes chunks of at most 256 rows and
head dims that are multiples of 32 up to 1024. Fresh state only: no
path of the port passes a carried state (the reference sends one to its
oracle), so ``state=`` raises.

On CUDA, :func:`mlstm_chunkwise` is the ``autograd.Function``
``_Mlstm``: its forward launches the kernel and saves the five inputs
(as the reference's custom VJP does, ``repro/kernels/mlstm/ops.py:33``;
non-reentrant ``torch.utils.checkpoint`` drops and recomputes them), and
its backward launches the backward kernel of ``csrc/mlstm.cu``
(:func:`mlstm_chunkwise_bwd`), the counterpart of the reference's
``_bwd`` (``jax.vjp`` of its plain chunkwise form) for the cotangent of
h. It recomputes the forward and carries the state's cotangent from the
last chunk, and returns dq/dk/dv in q's type and the gates' gradients in
float32, on one of two routes, chosen by the input type as the
forward's (:func:`bwd_route`): bfloat16 on the tensor cores (the
forward's tensor-core passes, then the products on ``wgmma`` with
operands by TMA from q, k, v and the cotangent in place, and
``<g_i, h_i>`` from products it forms anyway rather than from a
recomputed h: ``ref.gh_dots``), float32 on the CUDA cores (the
float32 forward recomputed, h among it). A cotangent of
the returned state (C, n, m) raises ``ValueError``: no path takes a
gradient through the carried state (training passes a fresh one and
drops it, as the reference's ``mlstm_block``), and C and n are scaled by
the stabilizer m, whose max has no gradient the kernel means to
reproduce. On the CPU autograd runs through the plain forward.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm import ref

#: Kernel launches so far, forward and backward (plain counts; callers
#: reset them to 0).
LAUNCHES = 0
BWD_LAUNCHES = 0

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 256
MAX_HEAD_DIM = 1024

_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        lib = build.load("mlstm")
        fn = lib.mlstm_chunkwise_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        bwd = lib.mlstm_chunkwise_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        for size in (lib.mlstm_scratch_bytes, lib.mlstm_bwd_scratch_bytes):
            size.argtypes = [ctypes.c_int] * 6
            size.restype = ctypes.c_longlong
        lib.mlstm_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        attrs = lib.mlstm_bf16_attributes
        attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        attrs.restype = ctypes.c_int
        attrs = lib.mlstm_bwd_attributes
        attrs.argtypes = ([ctypes.c_int] * 3
                          + [ctypes.POINTER(ctypes.c_int)] * 4)
        attrs.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _error(lib, rc):
    return f"{lib.mlstm_error_string(rc).decode()} ({rc})"


def _attributes(fn, *args) -> dict:
    out = [ctypes.c_int() for _ in range(4)]
    rc = fn(*args, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{_error(_kernel(), rc)}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), (x.value for x in out)))


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call with inputs of ``dtype`` launches:
    ``"tensor_core"`` for bfloat16, ``"cuda_core"`` for float32."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"the kernel takes {DTYPES}, got {dtype}")


#: The tensor-core route's kernels, in the order of
#: :func:`tensor_core_attributes`' argument.
TENSOR_CORE_KERNELS = ("scores", "states", "outputs")


def bwd_route(dtype: torch.dtype) -> str:
    """The backward kernels a CUDA call with inputs of ``dtype`` launches:
    ``"tensor_core"`` for bfloat16, ``"cuda_core"`` for float32."""
    return route(dtype)


def tensor_core_attributes(kernel: str) -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block, of one of the tensor-core route's kernels
    (``cudaFuncGetAttributes``)."""
    return _attributes(_kernel().mlstm_bf16_attributes,
                       TENSOR_CORE_KERNELS.index(kernel))


def scratch_bytes(B: int, H: int, S: int, hd: int, chunk: int,
                  dtype: torch.dtype) -> int:
    """Bytes of device scratch one call of the kernel at these shapes
    allocates."""
    return _kernel().mlstm_scratch_bytes(B, H, S, hd, chunk,
                                         int(dtype == torch.bfloat16))


#: The backward's own kernels by route, in the order of the kernel's
#: attribute index. The CUDA-core route: pass 4 of the float32 forward (h
#: in float32 and C entering every chunk), the dC walk, dW, the dq, dk and
#: dv products and the gates. The tensor-core route (after the forward's
#: gates, states and scores): y = C u, dW, the dC walk, the dq, dk and dv
#: products, the dn walk and the gates, the last two on the CUDA cores.
BACKWARD_KERNELS = {
    "cuda_core": ("values", "dstate", "dweights", "dq", "dk", "dv",
                  "dgates"),
    "tensor_core": ("cu", "dweights", "dstate", "dq", "dk", "dv", "dn",
                    "dgates"),
}


def backward_attributes(kernel: str, route: str = "cuda_core") -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block (at the largest head dim and chunk), of one of
    the backward's kernels of ``route`` (``cudaFuncGetAttributes``)."""
    first = 0 if route == "cuda_core" else len(BACKWARD_KERNELS["cuda_core"])
    return _attributes(_kernel().mlstm_bwd_attributes,
                       first + BACKWARD_KERNELS[route].index(kernel),
                       MAX_HEAD_DIM, MAX_CHUNK)


def bwd_scratch_bytes(B: int, H: int, S: int, hd: int, chunk: int,
                      dtype: torch.dtype) -> int:
    """Bytes of device scratch one call of the backward kernel at these
    shapes allocates (by route: ``dtype`` names it)."""
    return _kernel().mlstm_bwd_scratch_bytes(B, H, S, hd, chunk,
                                             int(dtype == torch.bfloat16))


def _check(q, k, v, log_i, log_f, chunk, g_h=None):
    """What the kernels take (and the backward's cotangent ``g_h`` of h,
    shaped and typed as q, when given)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    rows = [("k", k), ("v", v)] + ([] if g_h is None else [("g_h", g_h)])
    for name, t in rows:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    for name, t in (("log_i", log_i), ("log_f", log_f)):
        if t.shape != (B, S, H):
            raise ValueError(f"{name} {tuple(t.shape)} != (B, S, H) "
                             f"{(B, S, H)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if min(B, S, H) < 1:
        raise ValueError(f"the kernel takes B, S, H >= 1, got {(B, S, H)}")
    if hd % 32 or not 32 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims that are multiples "
                         f"of 32 up to {MAX_HEAD_DIM}, got {hd}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    named = (("q", q), *rows, ("log_i", log_i), ("log_f", log_f))
    for name, t in named:
        if name in ("k", "v", "g_h") and t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads rows in 16-byte vectors)")


def _launch(q, k, v, log_i, log_f, chunk):
    global LAUNCHES
    _check(q, k, v, log_i, log_f, chunk)
    B, S, H, hd = q.shape
    lib = _kernel()
    dev = q.device
    h = torch.empty_like(q)
    C = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes(B, H, S, hd, chunk, q.dtype),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mlstm_chunkwise_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr(), scratch.data_ptr(), B, H, S, hd, chunk,
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: {_error(lib, rc)}")
    LAUNCHES += 1
    return h, (C, n, m)


def _launch_bwd(q, k, v, log_i, log_f, g_h, chunk):
    global BWD_LAUNCHES
    _check(q, k, v, log_i, log_f, chunk, g_h)
    B, S, H, hd = q.shape
    lib = _kernel()
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dlog_i, dlog_f = torch.empty_like(log_i), torch.empty_like(log_f)
    scratch = torch.empty(bwd_scratch_bytes(B, H, S, hd, chunk, q.dtype),
                          dtype=torch.uint8, device=dev)
    # autograd runs the backward on a thread of its own: name the device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mlstm_chunkwise_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), g_h.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dlog_i.data_ptr(), dlog_f.data_ptr(),
            scratch.data_ptr(), B, H, S, hd, chunk,
            int(bwd_route(q.dtype) == "tensor_core"), stream)
    if rc != 0:
        raise RuntimeError(f"mlstm backward launch failed: {_error(lib, rc)}")
    BWD_LAUNCHES += 1
    return dq, dk, dv, dlog_i, dlog_f


class _Mlstm(torch.autograd.Function):
    """The kernel on the card under autograd: the forward kernel, then the
    backward kernel from the saved inputs and the cotangent of h."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, chunk):
        ctx.set_materialize_grads(False)
        h, (C, n, m) = _launch(q, k, v, log_i, log_f, chunk)
        ctx.save_for_backward(q, k, v, log_i, log_f)
        ctx.chunk = chunk
        return h, C, n, m

    @staticmethod
    def backward(ctx, g_h, g_C, g_n, g_m):
        if any(g is not None for g in (g_C, g_n, g_m)):
            raise ValueError(
                "mlstm_chunkwise takes no gradient through the returned "
                "state (C, n, m): only h is differentiable")
        if g_h is None:
            return (None,) * 6
        q, k, v, log_i, log_f = ctx.saved_tensors
        g_h = g_h.to(q.dtype).contiguous()
        return (*_launch_bwd(q, k, v, log_i, log_f, g_h, ctx.chunk), None)


def _heads(x, B, S, H):  # (B, S, H, ...) -> (B*H, S, ...)
    return x.movedim(2, 1).reshape(B * H, S, *x.shape[3:])


def _unheads(x, B, S, H):  # (B*H, S, ...) -> (B, S, H, ...)
    return x.reshape(B, H, S, *x.shape[2:]).movedim(1, 2)


def _plain(q, k, v, log_i, log_f, chunk):
    """The plain version in the model's layout."""
    B, S, H, hd = q.shape
    h, (C, n, m) = ref.mlstm_chunkwise(
        *(_heads(x, B, S, H) for x in (q, k, v, log_i, log_f)), chunk=chunk)
    return (_unheads(h, B, S, H),
            (C.reshape(B, H, hd, hd), n.reshape(B, H, hd), m.reshape(B, H)))


def _plain_bwd(q, k, v, log_i, log_f, g_h, chunk):
    """The plain backward in the model's layout."""
    B, S, H, _ = q.shape
    out = ref.mlstm_chunkwise_bwd(
        *(_heads(x, B, S, H) for x in (q, k, v, log_i, log_f, g_h)),
        chunk=chunk)
    return tuple(_unheads(x, B, S, H) for x in out)


def _route(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_chunkwise runs on cpu or cuda, not "
                         f"{q.device}")
    return q.device.type


def mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk: int = 64, state=None):
    """Model-layout entry: q/k/v (B, S, H, hd), gates (B, S, H) float32.

    Returns (h (B, S, H, hd) in q's type, state (C (B, H, hd, hd),
    n (B, H, hd), m (B, H)) float32).
    """
    if state is not None:
        raise NotImplementedError(
            "mlstm_chunkwise starts from a fresh state only; no path of the "
            "port carries a state into a prefill")
    if _route(q) == "cpu":
        return _plain(q, k, v, log_i, log_f, chunk)
    h, C, n, m = _Mlstm.apply(q, k, v, log_i, log_f, chunk)
    return h, (C, n, m)


def mlstm_chunkwise_bwd(q, k, v, log_i, log_f, g_h, *, chunk: int = 64):
    """The gradient of :func:`mlstm_chunkwise` (fresh state) for the
    cotangent ``g_h`` of h (model layout, q's type): (dq, dk, dv) in q's
    type and (dlog_i, dlog_f) float32. On CUDA one launch of the backward
    kernel on the route of q's type (:func:`bwd_route`); on the CPU the
    plain version (``ref.mlstm_chunkwise_bwd``)."""
    if _route(q) == "cuda":
        return _launch_bwd(q, k, v, log_i, log_f, g_h, chunk)
    return _plain_bwd(q, k, v, log_i, log_f, g_h, chunk)
