"""Public wrapper of the flash-attention forward and backward.

:func:`flash_attention` takes the model's layout, q ``(B, S, H, D)``, k
``(B, T, KH, D)`` and v ``(B, T, KH, DV)``, as the reference's ``ops``
does; DV is D but in DeepSeek-V2's latent attention (D = 192, DV = 128),
and the output is ``(B, S, H, DV)``. For CUDA tensors
it launches a hand-written kernel of ``csrc/flash_attention.cu`` on the
current stream, which reads that layout in place; for CPU tensors it
takes the plain version (``ref``, in the TPU kernel's layout
``(B, H, S, D)``). Nothing else picks the path: a CUDA tensor launches
a kernel or raises. ``LAUNCHES`` counts the launches.

:func:`route` names the kernel by the input type: bfloat16 (what
serving runs) goes to the tensor-core kernel (``wgmma`` with float32
accumulators, K/V by TMA into a ring of two shared-memory stages),
float32 to the CUDA-core kernel, whose checks are held at 2e-5, closer
than tensor cores reach from float32 inputs. Both take any S and T (the
TPU kernel asks S % 512 == 0 past 512), ``causal=False`` (no mask:
whisper's encoder at S = T = 1500 and its cross-attention, S queries
over T = 1500 keys, S > T included), GQA/MQA with H % KH == 0 (any
group: smollm's 9 query heads over 3 kv heads, qwen2.5's 16 over 2,
Qwen2-VL's 28 over 4), the head-dim pairs (D, DV) of ``PAIRS`` (the
float32 route also the small DeepSeek's (24, 16), whose 48-byte rows the
tensor cores' swizzled tiles do not take: a bfloat16 call at that pair
raises ``ValueError``), and one batch row of q, k or v below 2**31
elements. Neither stands in for the other. A row with no live key (only
when T < S with a window) gives 0 from both kernels; the plain version, as
the reference's ``ref``, gives the mean of v over all keys there.

On CUDA the call is differentiable through a ``torch.autograd.Function``
whose forward launches the forward kernel, which also writes each row's
log-sum-exp L (float32 ``(B, H, S)``; a call without grad writes none)
and, on the bf16 route, the output before its rounding in float32, and
saves q, k, v, that output and L (delta from the bf16 output sat up to
2.06e-2 of 1 + |g| from the reference's oracle on the card, past the
bf16 limit); its backward launches the
hand-written backward of ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`: a pre-pass for ``delta = rowsum(dO * O)``,
then dK/dV and dQ from L). :func:`bwd_route` names its kernels by the
input type, as :func:`route` does the forward's: bfloat16 goes to the
tensor-core kernels (``wgmma`` + TMA), float32 to the CUDA-core kernels
(held at 2e-5). The backward takes the square head dims of
``HEAD_DIMS`` (``BWD_PAIRS``) with every mode of the forward: a call
that needs a gradient at another pair (MLA's (192, 128), the small
DeepSeek's (24, 16)) raises ``ValueError`` before any launch. Its
gradient at a row with no live key is 0, as the kernels' output there.
On the CPU the plain version runs under autograd.
:func:`flash_attention_with_lse` returns the output and L without
autograd (the plain pair on the CPU). ``BWD_LAUNCHES`` counts backward
calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: Kernel launches so far (a plain count; callers reset it to 0).
LAUNCHES = 0
#: Backward calls so far, three kernel launches each on either route
#: (delta, dK/dV, dQ) (a plain count).
BWD_LAUNCHES = 0

#: The square head dims (D = DV) both routes take.
HEAD_DIMS = (16, 64, 128, 256)
#: (D, DV) pairs a route takes: the square ones and DeepSeek-V2-Lite's
#: latent attention (192, 128); the float32 route also the small
#: DeepSeek's (24, 16).
PAIRS = {"tensor_core": tuple((d, d) for d in HEAD_DIMS) + ((192, 128),),
         "cuda_core": tuple((d, d) for d in HEAD_DIMS)
         + ((192, 128), (24, 16))}
DTYPES = (torch.float32, torch.bfloat16)
#: (D, DV) pairs the backward takes, on both input types.
BWD_PAIRS = tuple((d, d) for d in HEAD_DIMS)

_FN = None
_BWD = None


def _route_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"the kernel takes {DTYPES}, got {dtype}")


def route(dtype: torch.dtype, D: int, DV: int | None = None) -> str:
    """The kernel a CUDA call with inputs of ``dtype``, q/k head dim
    ``D`` and v head dim ``DV`` (default ``D``) launches:
    ``"tensor_core"`` for bfloat16, ``"cuda_core"`` for float32. Raises
    ``ValueError`` for a pair that kernel does not take."""
    DV = D if DV is None else DV
    name = _route_name(dtype)
    if (D, DV) not in PAIRS[name]:
        others = [p for p in PAIRS[name] if p[0] != p[1]]
        raise ValueError(f"the {name} kernel ({dtype}) takes D in "
                         f"{HEAD_DIMS} with DV = D, and (D, DV) in {others}; "
                         f"got ({D}, {DV})")
    return name


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        attrs = lib.flash_attention_bf16_attributes
        attrs.argtypes = ([ctypes.c_int] * 2
                          + [ctypes.POINTER(ctypes.c_int)] * 4)
        attrs.restype = ctypes.c_int
        _FN = (fn, lib.flash_attention_error_string, attrs)
    return _FN


def tensor_core_attributes(D: int, DV: int | None = None) -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block, of the tensor-core kernel at head dims ``D``
    and ``DV`` (default ``D``) (``cudaFuncGetAttributes``)."""
    _, error_string, attrs = _kernel()
    out = [ctypes.c_int() for _ in range(4)]
    rc = attrs(D, D if DV is None else DV, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{error_string(rc).decode()} ({rc})")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), (x.value for x in out)))


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), k (B, T, KH, D) and v "
                         f"(B, T, KH, DV), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, S, H, D = q.shape
    KH, DV = k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}: expected (B, T, KH, D)")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} does not match k "
                         f"{tuple(k.shape)}: expected (B, T, KH, DV)")
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} must be a multiple of KH={KH}")
    if k.shape[1] < 1:
        raise ValueError("the kernel takes T >= 1 keys")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    route(q.dtype, D, DV)  # a pair the route takes
    if max(S * H, k.shape[1] * KH) * max(D, DV) >= 2 ** 31:
        raise ValueError("the kernel indexes one batch row with 32-bit "
                         "offsets: S*H and T*KH times D and DV must stay "
                         "below 2**31")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        bwd_route(q.dtype, D, DV)


def _launch(q, k, v, causal, window, scale, keep_lse=False, out32=None):
    """(out, L): the forward kernel's output and, with ``keep_lse``, each
    row's log-sum-exp, float32 (B, H, S) (else None). ``out32``, on the
    bf16 route, takes the output before its rounding, float32."""
    global LAUNCHES
    _check(q, k, v, window)
    B, S, H, D = q.shape
    T, KH, DV = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty(B, S, H, DV)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if keep_lse else None)
    if S == 0 or B == 0:  # nothing to launch
        return out, lse
    fn, error_string, _ = _kernel()
    tensor_core = route(q.dtype, D, DV) == "tensor_core"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if out32 is None else out32.data_ptr(), B, H, KH, S, T,
                D, DV, int(causal), int(window), float(scale),
                int(tensor_core), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out, lse


def _bwd_kernel():
    global _BWD
    if _BWD is None:
        lib = build.load("flash_attention_bwd")
        fn = lib.flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        attrs = lib.flash_attention_bwd_attributes
        attrs.argtypes = ([ctypes.c_int] * 2
                          + [ctypes.POINTER(ctypes.c_int)] * 4)
        attrs.restype = ctypes.c_int
        _BWD = (fn, lib.flash_attention_bwd_error_string, attrs)
    return _BWD


def bwd_route(dtype: torch.dtype, D: int, DV: int | None = None) -> str:
    """The backward kernels a CUDA call with inputs of ``dtype`` and head
    dims ``D`` and ``DV`` (default ``D``) launches: ``"tensor_core"``
    for bfloat16 (``wgmma`` + TMA), ``"cuda_core"`` for float32. Raises
    ``ValueError`` for a pair outside ``BWD_PAIRS``."""
    DV = D if DV is None else DV
    name = _route_name(dtype)
    if (D, DV) not in BWD_PAIRS:
        raise ValueError(f"the flash-attention kernel has no backward at "
                         f"(D, DV) = {(D, DV)} (it takes {BWD_PAIRS}); a "
                         f"gradient at this pair comes with a later slice")
    return name


#: The backward's kernels, in launch order, as
#: ``flash_attention_bwd_attributes`` numbers them.
BWD_KERNELS = ("delta", "dkdv", "dq")


def backward_attributes(D: int) -> dict:
    """Registers and local (spilled) bytes a thread, static and dynamic
    shared memory a block, of each kernel of the tensor-core backward at
    head dim ``D`` (``cudaFuncGetAttributes``), by ``BWD_KERNELS``."""
    _, error_string, attrs = _bwd_kernel()
    found = {}
    for i, name in enumerate(BWD_KERNELS):
        out = [ctypes.c_int() for _ in range(4)]
        rc = attrs(D, i, *(ctypes.byref(x) for x in out))
        if rc != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: "
                               f"{error_string(rc).decode()} ({rc})")
        found[name] = dict(zip(("registers", "local_bytes",
                                "static_smem_bytes", "dynamic_smem_bytes"),
                               (x.value for x in out)))
    return found


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` for CUDA tensors in the
    model's layout, given its output ``out`` for these q, k, v, the
    log-sum-exp ``lse`` (B, H, S) that the forward kept with it (both
    from :func:`flash_attention_with_lse`) and the output's cotangent
    ``dout`` (B, S, H, D): three launches of ``csrc/flash_attention_bwd.cu``
    on the current stream and on :func:`bwd_route`'s kernels (delta =
    rowsum(dout * out) into a float32 (B, H, S) scratch, then dK/dV, then
    dQ), gradients in q's type. ``out`` is in q's type, or float32: the
    bf16 forward's output before its rounding, which ``_Flash`` keeps so
    that delta carries no rounding of O."""
    global BWD_LAUNCHES
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    _check(q, k, v, window)
    tensor_core = bwd_route(q.dtype, q.shape[-1],
                            v.shape[-1]) == "tensor_core"
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        types = (q.dtype, torch.float32) if name == "out" else (q.dtype,)
        if (t.shape != q.shape[:3] + v.shape[3:] or t.dtype not in types
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{tuple(q.shape)} tensor like q, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(B, H, S)} "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B == 0 or S == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    fn, error_string, _ = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KH, S, T,
                D, int(causal), int(window), float(scale), int(tensor_core),
                int(out.dtype != q.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"{error_string(rc).decode()} ({rc})")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The forward kernel, keeping L (and on the bf16 route the output
    before its rounding, for delta), differentiated by the backward
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out32 = (torch.empty(q.shape[:3] + v.shape[3:], dtype=torch.float32,
                             device=q.device)
                 if q.dtype == torch.bfloat16 else None)
        out, lse = _launch(q, k, v, causal, window, scale, keep_lse=True,
                           out32=out32)
        ctx.save_for_backward(q, k, v, out if out32 is None else out32, lse)
        ctx.mode = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mode
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, S, H, D); k: (B, T, KH, D); v: (B, T, KH, DV) with
    H % KH == 0. Returns (B, S, H, DV) in q's type; the default scale is
    1/sqrt(D)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        out = ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=window, scale=scale)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check(q, k, v, window)  # a pair the backward takes, before a launch
        return _Flash.apply(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int = 0, scale: float | None = None):
    """(out, L): :func:`flash_attention`'s output and each row's
    log-sum-exp, float32 (B, H, S), as :func:`flash_attention_bwd` takes
    them. CUDA tensors launch the forward kernel with L; CPU tensors take
    the plain pair (``ref.attention`` and ``ref.attention_lse``). No
    gradient flows through it."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    mode = dict(causal=causal, window=window, scale=scale)
    with torch.no_grad():
        if q.device.type == "cpu":
            out = flash_attention(q, k, v, **mode)
            return out, ref.attention_lse(q.transpose(1, 2),
                                          k.transpose(1, 2), **mode)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cpu or cuda, not "
                             f"{q.device}")
        return _launch(q, k, v, causal, window, scale, keep_lse=True)
