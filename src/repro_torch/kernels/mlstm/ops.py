"""Public wrapper of the chunkwise mLSTM (forward, fresh state).

:func:`mlstm_chunkwise` takes the model's layout, q/k/v ``(B, S, H,
hd)`` and gates ``(B, S, H)``, as the reference's ``ops`` does. For
CUDA tensors it launches the hand-written kernel of ``csrc/mlstm.cu``
on the current stream, which reads that layout in place; for CPU
tensors it takes the plain version (``ref``, in the kernel's layout
``(B*H, S, hd)``). Nothing else picks the path: a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts the wrapper's launches (one
call, four passes of either route).

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
oracle), so ``state=`` raises. The forward is not differentiable on
CUDA yet: a call that would need a gradient raises ``ValueError``
naming its ROADMAP.md item, so an LM whose layers reach this kernel
refuses a loss on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm import ref

#: Kernel launches so far (a plain count; callers reset it to 0).
LAUNCHES = 0

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 256
MAX_HEAD_DIM = 1024

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("mlstm")
        fn = lib.mlstm_chunkwise_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mlstm_scratch_bytes.argtypes = [ctypes.c_int] * 6
        lib.mlstm_scratch_bytes.restype = ctypes.c_longlong
        lib.mlstm_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        attrs = lib.mlstm_bf16_attributes
        attrs.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        attrs.restype = ctypes.c_int
        _FN = (fn, lib.mlstm_scratch_bytes, lib.mlstm_error_string, attrs)
    return _FN


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


def tensor_core_attributes(kernel: str) -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block, of one of the tensor-core route's kernels
    (``cudaFuncGetAttributes``)."""
    _, _, error_string, attrs = _kernel()
    out = [ctypes.c_int() for _ in range(4)]
    rc = attrs(TENSOR_CORE_KERNELS.index(kernel),
               *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{error_string(rc).decode()} ({rc})")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), (x.value for x in out)))


def scratch_bytes(B: int, H: int, S: int, hd: int, chunk: int,
                  dtype: torch.dtype) -> int:
    """Bytes of device scratch one call of the kernel at these shapes
    allocates."""
    _, size, _, _ = _kernel()
    return size(B, H, S, hd, chunk, int(dtype == torch.bfloat16))


def _check(q, k, v, log_i, log_f, chunk):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    for name, t in (("k", k), ("v", v)):
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
    named = (("q", q), ("k", k), ("v", v), ("log_i", log_i),
             ("log_f", log_f))
    for name, t in named:
        if name in ("k", "v") and t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads rows in 16-byte vectors)")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise ValueError(
            "the CUDA mLSTM kernel has no backward yet (ROADMAP.md "
            "queue 2 item 4, with xLSTM's training): call it under "
            "torch.no_grad()")


def _launch(q, k, v, log_i, log_f, chunk):
    global LAUNCHES
    _check(q, k, v, log_i, log_f, chunk)
    B, S, H, hd = q.shape
    fn, _, error_string, _ = _kernel()
    dev = q.device
    h = torch.empty_like(q)
    C = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_bytes(B, H, S, hd, chunk, q.dtype),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
                log_f.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
                m.data_ptr(), scratch.data_ptr(), B, H, S, hd, chunk,
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: "
                           f"{error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return h, (C, n, m)


def _plain(q, k, v, log_i, log_f, chunk):
    """The plain version in the model's layout."""
    B, S, H, hd = q.shape

    def heads(x):  # (B, S, H, ...) -> (B*H, S, ...)
        return x.movedim(2, 1).reshape(B * H, S, *x.shape[3:])

    h, (C, n, m) = ref.mlstm_chunkwise(heads(q), heads(k), heads(v),
                                       heads(log_i), heads(log_f),
                                       chunk=chunk)
    return (h.reshape(B, H, S, hd).movedim(1, 2),
            (C.reshape(B, H, hd, hd), n.reshape(B, H, hd), m.reshape(B, H)))


def mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk: int = 64, state=None):
    """Model-layout entry: q/k/v (B, S, H, hd), gates (B, S, H) float32.

    Returns (h (B, S, H, hd) in q's type, state (C (B, H, hd, hd),
    n (B, H, hd), m (B, H)) float32).
    """
    if state is not None:
        raise NotImplementedError(
            "mlstm_chunkwise starts from a fresh state only; no path of the "
            "port carries a state into a prefill")
    if q.device.type == "cpu":
        return _plain(q, k, v, log_i, log_f, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, log_i, log_f, chunk)
