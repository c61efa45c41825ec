#!/usr/bin/env python3
"""Time the RG-LRU scan kernels of two checkouts of the port on one card,
in turns (first, second, second, first), at the shapes ``chip_smoke.py``
times (``LRU_TIMED``, C = 4096, float32, no h0).

    python3 tools/compare_rg_lru.py FIRST_SRC SECOND_SRC

Each argument is a checkout's ``src`` directory (holding ``repro_torch``).
Each turn runs in a process of its own, which builds that checkout's
kernel into the checkout's ``build/`` and holds its output at the main
shape against the plain version. Prints one JSON line a turn (the time
of back-to-back calls, ``ms``, and of calls captured in a CUDA graph,
``graph_ms``, without the wrapper's host time), then the card's name
and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import LRU_TIMED, TOL, _lru_inputs, cuda_ms, graph_ms

    sys.path.insert(0, src)  # ahead of the src that chip_smoke put first
    import torch

    from repro_torch.kernels.rg_lru import ops, ref

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    check = Path(ops.__file__).resolve()
    assert check.is_relative_to(Path(src).resolve()), check
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {"src": src, "ms": {}, "graph_ms": {}}
    with torch.no_grad():
        for B, S in LRU_TIMED:
            a, b, _ = _lru_inputs(g, B, S, 4096)
            if (B, S) == LRU_TIMED[0]:
                y, _ = ops.linear_scan(a, b)
                out["err"] = float((y - ref.linear_scan(a, b)[0]).abs().max())
                assert out["err"] <= TOL["float32"], out
            shape = f"B={B} S={S}"
            out["ms"][shape] = cuda_ms(lambda: ops.linear_scan(a, b), 50)
            out["graph_ms"][shape] = graph_ms(lambda: ops.linear_scan(a, b))
    print(json.dumps(out), flush=True)


def main(first: str, second: str) -> int:
    for src in (first, second, second, first):
        subprocess.run([sys.executable, __file__, "--worker", src],
                       check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(sys.argv[2])
    else:
        sys.exit(main(*sys.argv[1:3]))
