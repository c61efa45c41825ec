#!/usr/bin/env python3
"""The float32 flash backward where a cross-attention's keys and values
nearly agree, for one or more checkouts of the port on one card.

whisper-small is trained as ``chip_smoke.py``'s phase [26c] trains it
(seed-0 bf16 weights, ``WT_STEPS`` steps of B 16 x S 448 with 1500 frames
a row through ``launch/train.py::make_step``, then the profiled step
after them); its first decoder layer's cross-attention inputs are then
captured in a float32 forward over [26c]'s check batch (B 2 x S 448,
seed 100). Reported for that attention: the keys' and values' spread
about their mean over the 1500 frames (relative L2), P's largest entry
against uniform, and dq, dk, dv through the checkout's kernels and
through the plain version's autograd in float32, each by relative L2
from the plain version in float64 (one seeded output cotangent); and for
the whole model on the check batch, the float32 gradient leaves through
the kernels against the plain route (as [26c]'s check) and each route
against the plain route in float64, for the leaves farthest apart.

    python3 tools/xattn_float32_precision.py [SRC ...]

Each SRC is a checkout's ``src`` directory (holding ``repro_torch``;
default: this checkout's), run in a process of its own, which builds
that checkout's kernels into the checkout's ``build/``. Prints one JSON
line a checkout, then the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LEAVES = 4  # the whole model's leaves reported, farthest apart first


def worker(src: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, src)  # ahead of the src that chip_smoke put first
    import torch

    from repro_torch.common.tree import tree_cast
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    check = Path(fa_ops.__file__).resolve()
    assert check.is_relative_to(Path(src).resolve()), check

    cfg = get_config(cs.WHISPER)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    opt = AdamW(lr=cosine_schedule(*cs.WT_LR), inplace=True)
    state = opt.init(params)
    step = train.make_step(model, opt)
    for i in range(cs.WT_STEPS + 1):
        params, state, _ = step(params, state, cs.lm_train_batch(
            cfg, cs.WT_B, cs.WT_S, seed=i))
    del state
    batch = cs.lm_train_batch(cfg, cs.WT_CHECK_B, cs.WT_CHECK_S, seed=100)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_cast(params, torch.float32)

    calls, inner = [], fa_ops.flash_attention

    def record(q, k, v, **kw):
        calls.append((q.detach(), k.detach(), v.detach(), kw))
        return inner(q, k, v, **kw)

    fa_ops.flash_attention = record
    try:
        with torch.no_grad():
            model32.loss(params32, batch)
    finally:
        fa_ops.flash_attention = inner
    q, k, v, kw = next(c for c in calls if c[0].shape[1] == cs.WT_CHECK_S
                       and c[1].shape[1] == cfg.n_audio_frames)

    def spread(x):
        return float(torch.linalg.vector_norm(x - x.mean(1, keepdim=True))
                     / torch.linalg.vector_norm(x))

    scores = torch.einsum("bshd,bthd->bhst", q.double(), k.double())
    p_max = float(torch.softmax(scores * kw["scale"], -1).amax(-1).mean())
    dout = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    grads = {}
    for name, fn, dtype in (("kernels", fa_ops.flash_attention,
                             torch.float32),
                            ("plain", cs._plain_flash, torch.float32),
                            ("float64", cs._plain_flash, torch.float64)):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        grads[name] = torch.autograd.grad(fn(*leaves, **kw), leaves,
                                          dout.to(dtype))
    attention = {route: {n: cs._l2(a, b) for n, a, b in zip(
        ("dq", "dk", "dv"), grads[route], grads["float64"])}
        for route in ("kernels", "plain")}
    del grads

    model64 = build_model(dataclasses.replace(cfg, dtype="float64"))
    _, g64 = cs._flat_grads(model64, tree_cast(params, torch.float64), batch,
                            plain=True)
    _, gk = cs._flat_grads(model32, params32, batch)
    _, gp = cs._flat_grads(model32, params32, batch, plain=True)
    apart = {key: cs._l2(gk[key], gp[key]) for key in g64}
    leaves = {key: {"kernels_vs_plain": apart[key],
                    "kernels_vs_float64": cs._l2(gk[key], g64[key]),
                    "plain_vs_float64": cs._l2(gp[key], g64[key])}
              for key in sorted(apart, key=apart.get, reverse=True)[:LEAVES]}
    print(json.dumps({
        "src": src, "keys_spread": spread(k.double()),
        "values_spread": spread(v.double()),
        "p_max_over_uniform": p_max * cfg.n_audio_frames,
        "attention": attention, "model": leaves}), flush=True)


def main(srcs) -> int:
    for src in srcs or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--worker", src],
                       check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
