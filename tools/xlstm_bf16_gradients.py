#!/usr/bin/env python3
"""Where the full-width xLSTM's bf16 gradients part from float32, by mLSTM
route, at the weights ``chip_smoke.py``'s phase [24c] trains; and how
often the bf16 mLSTM forward rounds h otherwise than float64 does.

    python3 tools/xlstm_bf16_gradients.py [OTHER_MLSTM_CU]

Needs one card. Builds this checkout's ``csrc/mlstm.cu`` (through
``kernels/mlstm/ops``) and, when given, another ``mlstm.cu`` (say a
parent checkout's, unpacked under ``build/``) into
``build/other_mlstm.so`` with nvcc, this checkout's ``csrc`` on its
include path; the two must share the C interface of ``ops``. Then:

- at three shapes (H 4, hd 1024), the share of h's bf16 elements that
  each library's bf16 forward and the plain version round otherwise than
  the float64 evaluation;
- for each library L (this one, then the other): xlstm-1.3b trained as
  phase [24c] trains it (seed-0 bf16 weights, XL_STEPS steps of B XL_B x
  S XL_S through ``make_step`` with the in-place AdamW, then one step at
  S XL_PROFILE_S, all through L), and at those weights phase [24c]'s bf16
  gate on its batch: each gradient leaf's relative L2 distance e from the
  float32 plain route against max(FULL_BF16_REL_TOL, XLSTM_F32_MARGIN e_p),
  e_p the bf16 plain route's, for the mLSTM routes: each library's
  kernels, L's forward kernel with the plain backward, and the plain
  forward with L's backward kernel. Prints each route's leaf nearest its
  limit, its share of the limit, and the median e / e_p over the leaves.
"""

from __future__ import annotations

import ctypes
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OTHER = ROOT / "build" / "other_mlstm.so"
FLIP_SHAPES = ((8, 256, 256), (1, 4096, 256), (8, 64, 64))  # (B, S, chunk)
ENTRIES = ("mlstm_chunkwise_fwd", "mlstm_chunkwise_bwd", "mlstm_scratch_bytes",
           "mlstm_bwd_scratch_bytes", "mlstm_error_string")


def main(other_cu: str | None) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.common.tree import tree_cast
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm import ops
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    t0 = time.perf_counter()
    proc = None
    if other_cu:
        OTHER.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(
            [build.nvcc(), *(f for f in build.NVCC_FLAGS if f != "-v"
                             and f != "-Xptxas"),
             "-I", str(build.CSRC), "-o", str(OTHER), other_cu],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    libs = {"this": ops._kernel()}
    if proc is not None:
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on {other_cu}")
        lib = ctypes.CDLL(str(OTHER))
        for name in ENTRIES:
            fn, like = getattr(lib, name), getattr(libs["this"], name)
            fn.argtypes, fn.restype = like.argtypes, like.restype
        libs["other"] = lib

    def use(name):
        ops._LIB = libs[name]

    g = torch.Generator(device="cuda").manual_seed(3)
    for B, S, L in FLIP_SHAPES:
        q, k, v, li, lf = cs._mlstm_inputs(g, B, S, 4, 1024, torch.bfloat16)
        with torch.no_grad():
            exact = ops._plain(*(x.double() for x in (q, k, v, li, lf)),
                               L)[0].to(torch.bfloat16)
            share = {}
            for name in libs:
                use(name)
                h = ops.mlstm_chunkwise(q, k, v, li, lf, chunk=L)[0]
                share[name] = float((h != exact).float().mean())
            share["plain"] = float(
                (ops._plain(q, k, v, li, lf, L)[0] != exact).float().mean())
        print(f"B={B} S={S} H=4 hd=1024 chunk={L}: h rounded otherwise "
              f"than float64 in " + ", ".join(
                  f"{k} {v:.4%}" for k, v in share.items()), flush=True)
    use("this")

    class FwdKernelBwdPlain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, li, lf, chunk):
            h, (C, n, m) = ops._launch(q, k, v, li, lf, chunk)
            ctx.save_for_backward(q, k, v, li, lf)
            ctx.chunk = chunk
            return h, C, n, m

        @staticmethod
        def backward(ctx, g_h, *_):
            q, k, v, li, lf = ctx.saved_tensors
            return (*ops._plain_bwd(q, k, v, li, lf,
                                    g_h.to(q.dtype).contiguous(), ctx.chunk),
                    None)

    class FwdPlainBwdKernel(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, li, lf, chunk):
            h, (C, n, m) = ops._plain(q, k, v, li, lf, chunk)
            ctx.save_for_backward(q, k, v, li, lf)
            ctx.chunk = chunk
            return h, C, n, m

        @staticmethod
        def backward(ctx, g_h, *_):
            q, k, v, li, lf = ctx.saved_tensors
            return (*ops._launch_bwd(q, k, v, li, lf,
                                     g_h.to(q.dtype).contiguous(), ctx.chunk),
                    None)

    def mixed(fn):
        def call(q, k, v, log_i, log_f, *, chunk=64, state=None):
            h, C, n, m = fn.apply(q, k, v, log_i, log_f, chunk)
            return h, (C, n, m)
        return call

    cfg = get_config(cs.XL)
    model = build_model(cfg)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    batch = TokenPipeline(cfg.vocab_size, cs.XL_CHECK_S, cs.XL_CHECK_B,
                          seed=0).batch_at(0)

    def limit(e_p):
        return max(cs.FULL_BF16_REL_TOL, cs.XLSTM_F32_MARGIN * e_p)

    inner = ops.mlstm_chunkwise
    for trained in libs:
        use(trained)
        params = model.init(0, device="cuda")
        opt = AdamW(lr=cosine_schedule(*cs.XL_LR), inplace=True)
        state = {"params": params, "opt": opt.init(params)}
        del params
        step = train.make_step(model, opt)
        pipe = TokenPipeline(cfg.vocab_size, cs.XL_S, cs.XL_B, seed=0)
        batches = [pipe.batch_at(i) for i in range(cs.XL_STEPS)]
        batches.append(TokenPipeline(cfg.vocab_size, cs.XL_PROFILE_S,
                                     cs.XL_B, seed=0).batch_at(cs.XL_STEPS))
        losses = []
        for b in batches:
            state["params"], state["opt"], loss = step(state["params"],
                                                       state["opt"], b)
            losses.append(round(float(loss), 4))
        params = state.pop("params")
        del state
        torch.cuda.empty_cache()
        print(f"trained through {trained}: losses {losses} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        p32 = tree_cast(params, torch.float32)
        _, exact = cs._flat_grads(model32, p32, batch, plain=True)
        del p32
        zero = [k for k in exact if cs.lm_zero_grad_leaf(k)]
        routes = {f"kernels of {name}": (name, None) for name in libs}
        routes[f"{trained}'s forward kernel, plain backward"] = (
            trained, FwdKernelBwdPlain)
        routes[f"plain forward, {trained}'s backward kernel"] = (
            trained, FwdPlainBwdKernel)
        _, grads = cs._flat_grads(model, params, batch, plain=True)
        e_p = {k: cs._l2(grads[k], exact[k]) for k in exact if k not in zero}
        del grads
        for label, (name, fn) in routes.items():
            use(name)
            if fn is not None:
                ops.mlstm_chunkwise = mixed(fn)
            try:
                _, grads = cs._flat_grads(model, params, batch)
            finally:
                ops.mlstm_chunkwise = inner
            e = {k: cs._l2(grads[k], exact[k]) for k in e_p}
            del grads
            worst = max(e, key=lambda k: e[k] / limit(e_p[k]))
            print(f"  {label}: nearest its limit {worst}, e {e[worst]:.4f}, "
                  f"e_p {e_p[worst]:.4f}, {e[worst] / limit(e_p[worst]):.3f} "
                  f"of the limit; median e / e_p "
                  f"{statistics.median(e[k] / e_p[k] for k in e):.3f}; leaves "
                  f"past the limit {sum(e[k] > limit(e_p[k]) for k in e)}",
                  flush=True)
        use("this")
        del params, exact
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))
