#!/usr/bin/env python3
"""Hold the mLSTM kernels of two checkouts of the port against each other
on one card, and time their backwards in turns (first, second, second,
first).

    python3 tools/compare_mlstm.py FIRST_SRC SECOND_SRC

Each argument is a checkout's ``src`` directory (holding ``repro_torch``).
Each turn runs in a process of its own, which builds that checkout's
``csrc/mlstm.cu`` into the checkout's ``build/`` and, from one seed:
runs the forward (both input types) at ``FWD_SHAPES`` and the float32
backward at ``F32_BWD_SHAPES`` (the first two turns save the outputs
under ``build/``), and times the bf16 backward at ``chip_smoke.py``'s
``MLSTM_BWD_TIMED`` shapes. Prints whether the two checkouts' forwards
and float32 backwards are equal bit for bit (and where they are not, the
largest relative L2 distance between their outputs), one JSON line of
times a turn, then the card's name and power limit. Exits 1 when a float32
output differs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "compare_mlstm"

# (B, S, H, hd, chunk): the full-width prefill, and ragged tiles
FWD_SHAPES = ((1, 4096, 4, 1024, 256), (2, 257, 3, 96, 64),
              (1, 1000, 4, 160, 256))
F32_BWD_SHAPES = ((1, 4096, 4, 1024, 256), (2, 257, 3, 96, 64),
                  (1, 1000, 2, 32, 256))


def worker(src: str, tag: str) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (MLSTM_BWD_TIMED, _mlstm_bwd_inputs,
                            _mlstm_inputs, cuda_ms)

    sys.path.insert(0, src)  # ahead of the src that chip_smoke put first
    import torch

    from repro_torch.kernels.mlstm import ops

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    check = Path(ops.__file__).resolve()
    assert check.is_relative_to(Path(src).resolve()), check
    g = torch.Generator(device="cuda").manual_seed(5)
    outs = {}
    with torch.no_grad():
        for B, S, H, hd, L in FWD_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                x = _mlstm_inputs(g, B, S, H, hd, dtype)
                h, state = ops.mlstm_chunkwise(*x, chunk=L)
                outs[f"forward B={B} S={S} H={H} hd={hd} chunk={L} "
                     f"{dtype}"] = [t.cpu() for t in (h, *state)]
        for B, S, H, hd, L in F32_BWD_SHAPES:
            args = _mlstm_bwd_inputs(g, B, S, H, hd, torch.float32)
            got = ops.mlstm_chunkwise_bwd(*args, chunk=L)
            outs[f"backward B={B} S={S} H={H} hd={hd} chunk={L} "
                 f"float32"] = [t.cpu() for t in got]
        times = {}
        for B, S in MLSTM_BWD_TIMED:
            args = _mlstm_bwd_inputs(g, B, S, 4, 1024, torch.bfloat16)
            times[f"B={B} S={S} bf16"] = cuda_ms(
                lambda: ops.mlstm_chunkwise_bwd(*args, chunk=256), 5)
            del args
            torch.cuda.empty_cache()
    if tag:
        OUT.mkdir(parents=True, exist_ok=True)
        torch.save(outs, OUT / f"{tag}.pt")
    print(json.dumps({"src": src, "backward_ms": times}), flush=True)


def main(first: str, second: str) -> int:
    for src, tag in ((first, "first"), (second, "second"), (second, ""),
                     (first, "")):
        subprocess.run([sys.executable, __file__, "--worker", src, tag],
                       check=True)
    import torch

    a, b = (torch.load(OUT / f"{tag}.pt") for tag in ("first", "second"))
    f32_equal = True
    for key in a:
        if all(torch.equal(x, y) for x, y in zip(a[key], b[key])):
            print(f"{key}: equal bit for bit")
            continue
        f32_equal &= "float32" not in key
        dist = max(float(torch.linalg.vector_norm(x.double() - y.double())
                         / torch.linalg.vector_norm(x.double())
                         .clamp_min(1e-300))
                   for x, y in zip(a[key], b[key]))
        print(f"{key}: differs, largest relative L2 distance {dist:.3e}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0 if f32_equal else 1


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "")
    else:
        sys.exit(main(*sys.argv[1:3]))
