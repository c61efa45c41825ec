#!/usr/bin/env python3
"""Drive the PyTorch port of Perona (``src/repro_torch``) on one NVIDIA
GPU, hold it against its plain versions and the JAX package's stored
outputs, and time its kernel.

    python3 chip_smoke.py

Phases, each printing on lines of its own:

0. the card: name and power limit, torch and CUDA versions;
1. build: the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes, ragged N, single heads and fully masked rows;
3. the scoring engine on the §IV-C acquisition (1800 rows, bucket 2048)
   against the JAX engine's outputs stored in the golden file;
4. the watchdog at fleet size (512 nodes, 196,608 rows of history,
   3 rounds of 6,144 new rows) against a CPU run of the port;
5. timing: kernel, kernel in a CUDA graph, plain version, the library
   call and the byte bound; the scoring call per bucket and the
   profiler's top device kernels.

Then it prints the ``{"kernels": [...]}`` line, the card's name and
power limit, and as its last line the ``{"ok": true, ...}`` line. Any
failed check raises, and the script exits non-zero without that line.
It imports nothing of JAX and nothing of the JAX package; it exits
non-zero when no CUDA device is available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# kernel tolerances of the reference's kernel tests (tests/test_kernels.py:13)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# card vs JAX CPU outputs: float32 on both, summed in different orders
ENGINE_ATOL = 1e-4
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FLEET_NODES = 512
FLEET_HISTORY = 64  # runs per (node x benchmark type) chain
FLEET_ROUNDS = 3
DEGRADED = ("node-007", "node-100", "node-256", "node-511")

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Mean time of ``fn`` captured ``per_graph`` times in one CUDA
    graph, over ``replays`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, replays) / per_graph


# ------------------------------------------------------------------ phases
def phase_card():
    import torch

    print("[0] card")
    line = card_line()
    print(f"  {line}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import build

    print("[1] build")
    built = build.build("edge_softmax")
    for name, b in built.items():
        print(f"  {name}: {b.seconds:.2f} s nvcc -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")


def _inputs(g, N, H, hd, P, dtype):
    import torch

    q = torch.randn(N, H, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(N, P, H, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(N, P, H, hd, generator=g, device="cuda").to(dtype)
    mask = torch.rand(N, P, generator=g, device="cuda") < 0.8
    return q, k, v, mask


def phase_kernels():
    import torch

    from repro_torch.kernels.edge_softmax import ops, ref

    print("[2] edge_softmax_aggregate: kernel vs plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for N in (2048, 262144, 0, 1, 129, 513, 1800):
            cases.append((f"N={N} H=4 hd=8 P=3", N, 4, 8, 3, dtype, False))
        for hd in (8, 16, 32, 128):
            for P in (3, 5):
                cases.append((f"single head N=2048 hd={hd} P={P}", 2048, 1,
                              hd, P, dtype, True))
    main_err = 0.0
    with torch.no_grad():
        for label, N, H, hd, P, dtype, single in cases:
            q, k, v, mask = _inputs(g, N, H, hd, P, dtype)
            blank = slice(N // 3, N // 3 + min(N // 4, 64))
            mask[blank] = False  # a block of fully masked rows
            if single:
                q, k, v = (q[:, 0].contiguous(), k[:, :, 0].contiguous(),
                           v[:, :, 0].contiguous())
            out, att = ops.edge_softmax_aggregate(q, k, v, mask)
            oe, ae = ref.edge_softmax_aggregate(q, k, v, mask)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            tol = TOL[name]
            check(out.shape == oe.shape and att.shape == ae.shape,
                  f"{label} shapes")
            check(out.dtype == q.dtype and att.dtype == torch.float32,
                  f"{label} dtypes")
            eo = float((out.float() - oe.float()).abs().max()) if N else 0.0
            ea = float((att - ae).abs().max()) if N else 0.0
            blank_zero = (blank.stop == blank.start
                          or (float(out[blank].float().abs().max()) == 0.0
                              and float(att[blank].abs().max()) == 0.0))
            ok = eo <= tol and ea <= tol and blank_zero
            print(f"  {label:32s} {name:8s} out err {eo:.3e} att err "
                  f"{ea:.3e} tol {tol:g} masked rows 0: {blank_zero} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"kernel vs plain version, {label} {name}")
            if dtype == torch.float32 and N in (2048, 262144) and not single:
                main_err = max(main_err, eo, ea)
    return main_err


def phase_engine(golden, pre, frame):
    import numpy as np

    from repro_torch.core.model import PeronaModel
    from repro_torch.kernels.edge_softmax import ops
    from repro_torch.serving.engine import FingerprintEngine

    print("[3] FingerprintEngine on the §IV-C acquisition vs the JAX "
          "engine (golden file)")
    before = ops.LAUNCHES
    engine = FingerprintEngine(PeronaModel(golden.config), golden.params,
                               pre, device="cuda")
    t0 = time.perf_counter()
    res = engine.score(frame)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES - before
    errs = {k: float(np.abs(getattr(res, k) - golden.score[k]).max())
            for k in ("anomaly_prob", "type_logits", "codes")}
    print(f"  {len(frame)} rows (bucket {res.n_padded}), F'="
          f"{pre.feature_dim}, {wall:.3f} s first call, {launches} kernel "
          f"launches, max err vs JAX {errs} (atol {ENGINE_ATOL:g})")
    check(res.n_padded == int(golden.score["n_padded"]), "bucket")
    check(all(np.isfinite(getattr(res, k)).all()
              for k in ("anomaly_prob", "type_logits", "codes")),
          "finite engine outputs")
    check(max(errs.values()) <= ENGINE_ATOL, f"engine vs JAX: {errs}")
    check(launches > 0, "the engine launched the kernel")
    return engine


def phase_watchdog(golden, pre):
    import numpy as np

    from repro_torch.core.model import PeronaModel
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.kernels.edge_softmax import ops
    from repro_torch.runtime.watchdog import PeronaWatchdog

    print(f"[4] PeronaWatchdog at fleet size: {FLEET_NODES} e2-medium "
          f"nodes, {FLEET_HISTORY} runs per chain of history, "
          f"{len(DEGRADED)} degraded")
    machines = {f"node-{i:03d}": "e2-medium" for i in range(FLEET_NODES)}
    runner = SuiteRunner(seed=1)
    t0 = time.perf_counter()
    history = runner.run_frame(machines, runs_per_type=FLEET_HISTORY,
                               stress_fraction=0.2)
    rounds = [runner.run_frame(machines, runs_per_type=2,
                               degraded_machines=DEGRADED,
                               t_offset=86400.0 * (r + 1))
              for r in range(FLEET_ROUNDS)]
    print(f"  history {len(history)} rows, rounds of {len(rounds[0])} "
          f"rows, data made in {time.perf_counter() - t0:.1f} s")
    model = PeronaModel(golden.config)
    wd = {dev: PeronaWatchdog(model, golden.params, pre,
                              history_per_chain=FLEET_HISTORY, device=dev)
          for dev in ("cuda", "cpu")}
    for w in wd.values():
        w.history = history
    before = ops.LAUNCHES
    for r, new in enumerate(rounds):
        t0 = time.perf_counter()
        d_gpu = wd["cuda"].observe(new)
        wall = time.perf_counter() - t0
        d_cpu = wd["cpu"].observe(new)
        if r == 0:
            a_gpu, a_cpu = wd["cuda"].store.anomaly, wd["cpu"].store.anomaly
            check(np.array_equal(np.isnan(a_gpu), np.isnan(a_cpu)),
                  "scored rows agree")
            err = float(np.nanmax(np.abs(a_gpu - a_cpu)))
            print(f"  round 0 anomaly_prob, card vs CPU plain path: max "
                  f"err {err:.3e} (atol {ENGINE_ATOL:g})")
            check(err <= ENGINE_ATOL, "watchdog anomaly_prob card vs CPU")
        key = [(d.node, d.flagged, d.confirmed) for d in d_gpu]
        check(key == [(d.node, d.flagged, d.confirmed) for d in d_cpu],
              f"round {r} decisions card vs CPU")
        flagged = [d.node for d in d_gpu if d.flagged]
        confirmed = [d.node for d in d_gpu if d.confirmed]
        hits = sorted(set(confirmed) & set(DEGRADED))
        healthy = len(set(confirmed) - set(DEGRADED))
        print(f"  round {r}: {wall:.3f} s wall, {len(flagged)} flagged, "
              f"{len(confirmed)} confirmed; degraded confirmed {hits}; "
              f"healthy confirmed {healthy}; decisions equal the CPU run")
    launches = ops.LAUNCHES - before
    print(f"  {launches} kernel launches")
    check(launches > 0, "the watchdog launched the kernel")
    return wd["cuda"].store.frame


def time_kernel(N):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.edge_softmax import ops, ref

    H, hd, P = 4, 8, 3
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, mask = _inputs(g, N, H, hd, P, torch.float32)
    iters = 200 if N <= 4096 else 50
    with torch.no_grad():
        ms = cuda_ms(lambda: ops.edge_softmax_aggregate(q, k, v, mask),
                     iters)
        in_graph = graph_ms(
            lambda: ops.edge_softmax_aggregate(q, k, v, mask))
        plain = cuda_ms(lambda: ref.edge_softmax_aggregate(q, k, v, mask),
                        iters)
        # one library call of the same function: SDPA over N*H queries
        # of length 1 against P keys, with a boolean mask
        q4 = q.unsqueeze(2)
        k4 = k.permute(0, 2, 1, 3).contiguous()
        v4 = v.permute(0, 2, 1, 3).contiguous()
        m4 = mask[:, None, None, :]
        library = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=m4), iters)
        # the yardstick computes the same function (SDPA gives NaN where
        # every edge is masked; the kernel gives 0 there)
        lib_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                 attn_mask=m4)[:, :, 0]
        out, _ = ops.edge_softmax_aggregate(q, k, v, mask)
        live = mask.any(1)
        lib_err = float((lib_out[live] - out[live]).abs().max())
    check(lib_err <= TOL["float32"], f"SDPA vs kernel at N={N}")
    nbytes = (q.nbytes + k.nbytes + v.nbytes + mask.nbytes
              + q.nbytes + N * H * P * 4)  # in once, out and att once
    flops = N * H * P * (4 * hd + 4)  # scores, softmax, weighted sum
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    row = {"N": N, "ms": ms, "graph_ms": in_graph, "plain_ms": plain,
           "library_ms": library, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "library_vs_kernel": lib_err}
    print(f"  N={N:6d} H=4 hd=8 P=3 float32: kernel {ms:.4f} ms, in a CUDA "
          f"graph {in_graph:.4f} ms, plain {plain:.4f} ms, SDPA "
          f"{library:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e6:.1f} MFLOP); SDPA vs kernel {lib_err:.2e}")
    return row


def time_engine(engine, frame, reps):
    """The scoring call's host-clock time (ending in synchronize), its
    parts, and the profiler's device kernels for one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.graph_data import graph_structure
    from repro_torch.serving.engine import (ARG_NAMES, assemble_inputs,
                                            bucket_size, prepare_features)

    n, b = len(frame), bucket_size(len(frame), engine.min_bucket)
    engine.score(frame)  # warm
    calls, parts = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.score(frame)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        t = [time.perf_counter()]
        feats = prepare_features(engine.preproc, frame)
        t.append(time.perf_counter())
        gs = graph_structure(frame)
        t.append(time.perf_counter())
        inputs = assemble_inputs(feats, gs.nbr, gs.dt, gs.t_src, b)
        t.append(time.perf_counter())
        args = tuple(torch.from_numpy(inputs[k]).to(engine.device)
                     for k in ARG_NAMES)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        with torch.inference_mode():
            out = engine._score(engine.params, *args)
            _ = {k: v[:n].cpu() for k, v in out.items()}
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        parts.append([b - a for a, b in zip(t[:-1], t[1:])])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.score(frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []  # device-side activity only: kernels and copies
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA
                and not evt.key.startswith("Activity Buffer")):
            kernels.append((evt.self_device_time_total, evt.count, evt.key))
    kernels.sort(reverse=True)
    device_us = sum(us for us, _, _ in kernels)
    names = ("features", "topology", "assemble", "copy_in",
             "forward_and_fetch")
    med = {k: statistics.median(p[i] for p in parts)
           for i, k in enumerate(names)}
    row = {"rows": n, "bucket": b, "score_s": statistics.median(calls),
           "parts_s": med, "profiled_wall_s": wall,
           "profiled_device_s": device_us / 1e6,
           "device_idle_share": 1.0 - device_us / 1e6 / wall,
           "top_kernels": [{"name": k[:90], "us": us, "count": c}
                           for us, c, k in kernels[:8]]}
    print(f"  scoring call, {n} rows (bucket {b}): "
          f"{row['score_s'] * 1e3:.2f} ms, median of {reps}; parts (ms): "
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in med.items()))
    print(f"    profiled call: {wall * 1e3:.2f} ms wall, "
          f"{device_us / 1e3:.3f} ms of device activity in {len(kernels)} "
          f"kinds of kernel and copy, idle share "
          f"{row['device_idle_share']:.4f}")
    for k in row["top_kernels"]:
        print(f"    {k['us']:10.1f} us x{k['count']:3d}  {k['name']}")


def phase_timing(engine, paper_frame, fleet_frame):
    print("[5] timing (CUDA events after warm-up; host clock ending in "
          "synchronize for the scoring call)")
    kernel = {str(N): time_kernel(N) for N in (2048, 262144)}
    time_engine(engine, paper_frame, reps=10)
    time_engine(engine, fleet_frame, reps=3)
    return kernel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core.graph_data import chronological_split
    from repro_torch.core.params import load_golden
    from repro_torch.core.preprocess import Preprocessor
    from repro_torch.fingerprint.runner import paper_acquisition_frame
    from repro_torch.kernels.edge_softmax import ops

    t_start = time.perf_counter()
    phase_card()
    phase_build()
    max_err = phase_kernels()

    golden = load_golden()
    frame = paper_acquisition_frame(seed=0)
    pre = Preprocessor().fit(chronological_split(frame)[0])
    for key in ("lo", "hi", "maximize", "fill_mean", "edge_lo", "edge_hi",
                "feature_names", "benchmark_types", "edge_names"):
        check(np.array_equal(np.asarray(getattr(pre, key)),
                             np.asarray(getattr(golden.preproc, key))),
              f"preprocessor statistic {key} equals the golden file's")

    ops.LAUNCHES = 0  # the main path starts here
    engine = phase_engine(golden, pre, frame)
    fleet_frame = phase_watchdog(golden, pre)
    launches = ops.LAUNCHES  # ... and ends here
    check(launches > 0, "the main path launched the kernel")

    timing = phase_timing(engine, frame, fleet_frame)
    big = timing["262144"]
    kernels = [{
        "name": "edge_softmax_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/csrc/edge_softmax.cu",
        "replaces": "src/repro/kernels/edge_softmax/kernel.py:23",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "shape": "N=262144 H=4 hd=8 P=3 float32",
        "by_n": timing,
    }]
    print(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
