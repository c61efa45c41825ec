#!/usr/bin/env python3
"""Drive the PyTorch port of Perona (``src/repro_torch``) on one NVIDIA
GPU, hold it against its plain versions and the JAX package's stored
outputs, and time its kernels. Six paths are driven: Perona's scoring
path (edge-softmax kernel), RecurrentGemma-9B serving at full width
(flash-attention and RG-LRU scan kernels), xLSTM-1.3B serving at full
width (chunkwise mLSTM kernel), Perona's host-loop training and its
device-resident training with the HPO and the train-then-rank entry
points (the edge-softmax forward and backward kernels), and Perona's
fleet serving tier: stacked request scoring, the scoring service, the
ingestion daemon and the serve modes (the edge-softmax forward).

    python3 chip_smoke.py

Phases, each printing on lines of its own:

0. the card: name and power limit, torch and CUDA versions;
1. build: the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, one
   process per source, all started together;
2. the edge-softmax kernel against its plain PyTorch version on the
   card, at the main path's shapes ((H, hd) (4, 8), and the HPO's (2, 16)
   and (8, 4)), ragged N, single heads and fully masked rows;
3. the scoring engine on the §IV-C acquisition (1800 rows, bucket 2048)
   against the JAX engine's outputs stored in the golden file;
4. the watchdog at fleet size (512 nodes, 196,608 rows of history,
   3 rounds of 6,144 new rows) against a CPU run of the port;
5. the flash-attention and RG-LRU kernels against their plain versions
   on the card (f32 and bf16; B 1/2, KH 1/16, D 64/256, S up to 4096,
   window 0/2048; then the bf16 kernel's tile edges: S, T in 15..191
   around multiples of 64 and 128, window 0/1/64/65, KH 1/4/16, D
   16/64/256; the scan at C=4096, S 1/257/4096, with and without h0;
   then the scan's tile edges, S 1/31/32/33/65/4097 by C
   1/33/127/128/129/4096, B 1/3, with and without h0; 20 launches at
   B=4 S=4096 C=4096, equal bit for bit; and a long-memory case held
   against the plain version in float64, e_k <= 1.5 e_p);
6. a small RecurrentGemma (float32) against the JAX package's prefill
   and decode logits and served tokens (golden file);
7. recurrentgemma-9b at full width (bf16, seed-0 weights drawn on the
   card) serving 8 requests of 128..4096 prompt tokens through
   ``SlotServer``: completion, kernel launches per prefill, time to
   first token (from the request's arrival) and prefill latency,
   prefill and decode tokens/s, peak memory; prefill
   logits through the kernels vs the plain versions and decode after a
   3000-token prefill vs a no-cache forward (the ring check), in bf16
   and with the same weights in f32, where the reference's ring layout
   must fail the check (a control); the profiler's top device entries
   and the port's kernels among them by name;
8. timing: the edge-softmax kernel (kernel, in a CUDA graph, plain
   version, the library call and the byte bound) and the scoring call
   per bucket; the flash and RG-LRU kernels at the full-width prefill
   shapes with their plain versions, library call and bounds (flash:
   the bf16 tensor-core kernel with its TFLOP/s, registers and shared
   memory, and the float32 route's CUDA-core kernel at the same shape
   with its own bound at the float32 rate and SDPA on the float32
   problem; RG-LRU: also at B=1 S 128/1000 and B=4 S=4096, back to back and in a
   CUDA graph, beside one torch.add that moves the same bytes, with its
   registers and scratch);
9. the chunkwise mLSTM kernel against its plain version on the card
   (f32: the CUDA-core route, bf16: the tensor-core route; h, C, n, m):
   the reference's test shapes (BH, S, hd, chunk) = (2, 128, 64, 64),
   (4, 64, 32, 32), (1, 256, 128, 64), and hd 32 and 1024 at S 1, 100,
   256, 257, 1000, 3000, 4096 with chunk 256 (ragged last chunks); then
   the bf16 route's 384 tile edges (S 1..513 around multiples of 16, 64
   and 128, hd 32/96/160/288, chunk 256/100/64, two (B, H));
10. timing: the mLSTM kernel at B=1 H=4 S=4096 hd=1024 chunk 256 bf16
   (the tensor-core route: TFLOP/s, each pass's time from the profiler,
   registers, shared memory, scratch), its plain version, its bound (no
   single PyTorch call computes it) and the float32 route at the same
   shape with its own bound at the float32 rate;
11. a small xLSTM (float32) against the JAX package's prefill and decode
   logits and served tokens (golden file, a 512-token prompt among them);
12. xlstm-1.3b at full width (bf16, seed-0 weights drawn on the card,
   1,918,085,120 parameters) serving 8 requests of 128..4096 prompt
   tokens through ``SlotServer``: completion, mLSTM launches per
   prefill, TTFT from arrival and prefill latency, prefill and decode
   tokens/s, peak memory, the profiler's view of one 4096-token prefill
   and four decode steps; then, for a 3000-token prompt: (a) each of the
   42 mLSTM layers' inputs from the plain bf16 prefill through the kernel
   and the plain version, held layer by layer; (b) the bf16 logits
   through the kernels and through the plain versions, each measured
   against the float32 plain route's logits of the same weights (the
   kernels' distance at most max(0.1, 1.25 x) the plain versions'); the
   bf16 kernels vs plain logits and a control with the mLSTM in float64,
   measured; decode after the prefill vs a no-cache forward over 3001
   tokens (the state handed from the ragged-tail kernel to
   ``mlstm_step``), in bf16 and f32; f32 logits, kernels vs plain.

14. Perona training on the §IV-C batch (1080 train and 360 validation
   nodes, F'=95, P=3, A=12; the paper's width): (a) the edge-softmax
   backward kernel against its plain version, N 1/7/130/2048/262144, P
   1/3/8, (H, hd) (1, 32)/(2, 16)/(4, 8)/(8, 4)/(2, 64)/(1, 128), float32
   and bf16,
   with and without an att cotangent; fully masked rows give 0, N=0 no
   launch, 5 launches bit for bit; (b) at the training golden file's
   initial parameters and dropout 0: the five loss terms and the total,
   every gradient and one AdamW step against the JAX values; (c)
   ``train_perona_reference`` at dropout 0 over the golden's 80 epochs
   against the JAX reference trainer's history, within the limits
   measured on the CPU (losses per block of 10 epochs, F1, best key,
   selected parameters); (d) the default-dropout recipe, 80 epochs:
   losses finite and falling, validation F1 and type accuracy beside the
   JAX-trained golden's (measured, not gated), launches an epoch (3
   forward, 1 backward); (e) the backward kernel's time at N=262144 and
   N=1080, back to back and in a CUDA graph, its bound, plain version
   and SDPA's backward on the forward's library problem, and the
   profiler's view of 10 training epochs (epoch time, busy and idle
   share).
15. Perona's device-resident trainer (``train_perona``: the epoch
   captured once as a CUDA graph and replayed): (a) the forward and
   backward kernels against their plain versions at the HPO's (H, hd)
   (1, 32)/(2, 16)/(4, 8)/(8, 4), N 360/1080/262144, P=3, float32 and
   bf16; (b) at dropout 0 over the golden's 80 epochs against the JAX
   scanned trainer's history (losses per block and parameters at [14c]'s
   limits, F1 at its own measured limit), replays under
   ``set_sync_debug_mode("error")``, the second run on the cached graph
   bit for bit, and whether it equals the host loop bit for bit
   (printed); (c) the default-dropout recipe, 80 epochs: losses finite
   and falling, two runs of one seed identical and two seeds apart, F1
   and type accuracy beside the golden's, the epoch's time beside the
   host loop's, and the graph's nodes, replay time and profiled busy
   and idle share; (d) the HPO: the dropout-0 space at 8 trials x 60
   epochs against the host-loop search (trial F1 and validation loss,
   the best trial's history), one capture a bucket, then the default
   space at the reference's 100 trials x 60 epochs (wall time,
   buckets, captures, the best trial); (e) ``fingerprint_cluster`` on 4
   n2-standard-4 hosts and ``fingerprint_machine_scores`` on the 9
   scout machine types at 10 runs a type: times and rankings.
16. the fleet tier: (a) ``PeronaWatchdog(service=FleetScoringService(
   ..., context_per_chain=64))`` on phase [4]'s fleet and rounds, each
   round one stacked dispatch of R = 512 requests x bucket 512 (262,144
   rows): decisions equal to [4]'s engine path and to a CPU run of the
   service, the new rows' anomaly_prob within 1e-4 of both, exactly the
   degraded nodes confirmed, and each round's wall time split into
   intake, store append, request assembly, stacking, host-to-device
   copy, the scoring function (device time from CUDA events), the copy
   back and the store attach, with the idle share and the kernel
   launches a dispatch; (b) ``serve_fleet`` (``--fleet``) at 512 nodes x
   4 rounds, training first: every node served every round, req/s; (c)
   ``serve_daemon`` (``--daemon --faults``) at 512 nodes x 6 rounds: the
   ladder counters, quarantined rows equal to the injector's corrupted
   rows, then the same stream through a daemon scoring with the golden
   model, which must flag the degraded node; a no-fault daemon at
   ``service_time_scale=0`` equal to the closed loop bit for bit; (d)
   ``serve_fingerprints`` (``--fingerprint``), 8 rounds. Every dispatch
   launches the kernel; no dispatch is retried and no flush fails.

Each phase prints its seconds. Then it writes every number to
``build/chip_smoke_report.json`` and prints the ``{"kernels":
[...]}`` line, the card's name and power limit, and as its last line
the ``{"ok": true, ...}`` line. Any failed check raises, and the script
exits non-zero without that line.
It imports nothing of JAX and nothing of the JAX package; it exits
non-zero when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import re
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
LM_GOLDEN_ATOL = 1e-4
# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# RecurrentGemma-9B serving at full width
FULL_LENGTHS = (128, 512, 1024, 2048, 2049, 3000, 4000, 4096)
# xLSTM-1.3B serving at full width: a single short chunk, exact multiples
# of 256 and ragged lengths (which the reference's Pallas route refuses)
XLSTM_LENGTHS = (128, 256, 512, 1000, 2048, 3000, 4000, 4096)
XLSTM_CHECK_LENGTH = 3000  # prefill vs plain, and decode after prefill
XLSTM_PARAMS = 1_918_085_120
MLSTM_CHUNK = 256  # the reference model's chunk (repro/models/recurrent.py:216)
FULL_SLOTS, FULL_MAX_NEW, FULL_MAX_LEN = 4, 16, 4112
FULL_CHECK_LENGTHS = (4096, 3000)  # prefill, kernels vs plain versions
FULL_RING_LENGTH = 3000  # > W = 2048 and not a multiple of it
# Logits of two runs that round differently (kernels vs plain versions,
# decode vs no-cache forward), as ||a - b|| / ||b||. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W: in bf16 at full depth with random
# weights (logits up to about 900) single rounding steps grow to 3.3e-2
# to 3.6e-2, so bf16 is held at 1e-1; the same weights in float32 give
# 7.6e-6 to 9.1e-6 and are held at 1e-4, which the reference's ring
# layout (1.5e-3 at S = 3000) exceeds 15 times.
FULL_BF16_REL_TOL = 1e-1
FULL_F32_REL_TOL = 1e-4
# The full-width bf16 xLSTM logits at S = 3000 are chaotic at seed-0
# weights: one-step bf16 differences in a few mLSTM outputs grow through
# 48 layers to about 0.3 relative L2, and a float64 mLSTM is as far from
# the plain versions as any kernel. So the bf16 xLSTM is held (a) layer by
# layer on each mLSTM layer's own inputs, at the kernel phase's limits,
# and (b) end to end by its distance from the float32 plain route: the
# kernels' at most max(FULL_BF16_REL_TOL, XLSTM_F32_MARGIN x) the plain
# versions', the margin of the CPU tests' float32-vs-float64 comparison
# (tests/test_torch_xlstm.py).
XLSTM_F32_MARGIN = 1.25
XLSTM_MLSTM_LAYERS = 42
# mLSTM at hd 1024: relative L2 of h and of the state (C, n, m)
MLSTM_REL_TOL = 1e-4
REPORT = ROOT / "build" / "chip_smoke_report.json"

# Perona training (phase [14]). The backward kernel's sweep, at the
# kernel tolerances above, and its main shape (N, H, hd, P) for the
# launch-to-launch check.
BWD_N = (1, 7, 130, 2048, 262144)
BWD_P = (1, 3, 8)
BWD_HEADS = ((1, 32), (2, 16), (4, 8), (8, 4), (2, 64), (1, 128))
BWD_MAIN = (262144, 4, 8, 3)
BWD_REPEATS = 5
# At fixed parameters (the training golden file's, dropout 0), card vs
# JAX: loss terms absolute, gradients relative L2 per leaf, one AdamW
# step absolute. The key biases' exact gradient is 0 (a bias on every
# key of a node shifts all its scores alike, which the softmax ignores),
# so both packages return rounding noise there (about 1e-11): those
# leaves are held to a gradient norm under TRAIN_ZERO_GRAD_RTOL of the
# global norm instead, and left out of the other comparisons.
ZERO_GRAD_LEAVES = ("wk.b", "we_k.b")
TRAIN_LOSS_ATOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_ZERO_GRAD_RTOL = 1e-6
TRAIN_STEP_ATOL = 1e-5
# Whole runs of the reference trainer at dropout 0 against the JAX
# reference trainer's history (golden). Rounding differences grow about
# 2-3x every 10 epochs, so the losses are held per block of 10 epochs, at
# about three times the largest relative error measured in that block
# over sixteen CPU runs of the port and JAX's own scanned trainer (PERF.md
# §6: tools/train_tolerance.py), rounded up to 1, 2 or 5 and never
# below 1e-4 (the first epochs' bar); validation F1 and the selected
# parameters (relative L2 over all leaves but the key biases) the same
# way.
TRAIN_FIRST_EPOCHS = 5
TRAIN_EPOCH_BLOCK = 10
TRAIN_LOSS_RTOL = (1e-4, 1e-4, 1e-4, 5e-4, 2e-3, 5e-3, 2e-2, 5e-2)
TRAIN_F1_ATOL = 5e-2
TRAIN_PARAMS_RTOL = 1e-2
# The graphed train_perona against the JAX scanned trainer's history
# ([15b]) keeps the limits above for the losses and the parameters: over
# sixteen CPU runs of the port's train_perona (tools/train_tolerance.py
# --trainer scan) they reached 0.32 and 0.27 of them. Validation F1 moved
# by up to 2.49e-2 there (two flipped predictions of 360), half of
# TRAIN_F1_ATOL, so its limit is set anew at about three times that.
TRAIN_SCAN_F1_ATOL = 1e-1

# Perona's graphed trainer, the HPO and the ranking (phase [15]). The
# HPO's head counts (repro/tuning/hpo.py:38) at code width 32 give the
# edge-softmax kernels these (H, hd); they run at the training batch's N
# (1080 and 360) and at the fleet bucket's.
HPO_HEADS = ((1, 32), (2, 16), (4, 8), (8, 4))
HPO_N = (360, 1080, 262144)
HPO_CHECK_TRIALS, HPO_CHECK_EPOCHS = 8, 60  # the dropout-0 space
# [15c]: the graphed default-dropout run's first epochs against the host
# loop's on the same seed, at the limit of the CPU test of the same
# property (tests/test_torch_train_graph.py, positive dropouts)
DROPOUT_HOST_EPOCHS, DROPOUT_HOST_RTOL = 5, 1e-5
# the reference's defaults (repro/tuning/hpo.py:153-155)
HPO_TRIALS, HPO_EPOCHS = 100, 60
# repro/launch/train.py:91: the LM training entry point's cluster
CLUSTER = {f"host-{i}": "n2-standard-4" for i in range(4)}
# benchmarks/bench_tuning.py's machine types (repro/tuning/scout.py:37-42)
SCOUT_VM_TYPES = ("m4.large", "m4.xlarge", "m4.2xlarge", "c4.large",
                  "c4.xlarge", "c4.2xlarge", "r4.large", "r4.xlarge",
                  "r4.2xlarge")
MACHINE_RUNS, MACHINE_EPOCHS = 10, 60

FLEET_NODES = 512
FLEET_HISTORY = 64  # runs per (node x benchmark type) chain
FLEET_ROUNDS = 3
DEGRADED = ("node-007", "node-100", "node-256", "node-511")

def f32_bound_ms(flops, nbytes):
    """The least time of a float32 route: its operations at the float32
    rate outside the tensor cores, or its bytes, whichever is longer."""
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


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
    built = build.build("edge_softmax", "flash_attention", "rg_lru", "mlstm")
    for name, b in built.items():
        print(f"  {name}: {b.seconds:.2f} s nvcc -> {b.path.name}")
        for line in b.log.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                print(f"    {_kernel_name(entry.group(1))}")
            elif "registers" in line or "spill" in line:
                print(f"      {line.strip()}")


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier of a mangled entry name and its
    template arguments, still mangled (``flash_fwd_bf16_kernelILi256E``).
    Identifiers are prefixed with their length; a prefix may follow other
    digits (a hash), so every tail of a run of digits is tried."""
    for run in re.finditer(r"\d+", mangled):
        for start in range(run.start(), run.end()):
            n = int(mangled[start:run.end()])
            name = mangled[run.end():run.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                args = re.match(r"I\w*?Li\d+E", mangled[run.end() + n:])
                return name + (args.group() if args else "")
    return mangled


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
        for (H, hd), N in itertools.product(
                ((4, 8), (2, 16), (8, 4)),
                (2048, 262144, 0, 1, 129, 513, 1800)):
            cases.append((f"N={N} H={H} hd={hd} P=3", N, H, hd, 3, dtype,
                          False))
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
    engine_path = []  # per round: decisions and the new rows' scores
    for r, new in enumerate(rounds):
        first_id = wd["cuda"].store.next_id
        t0 = time.perf_counter()
        d_gpu = wd["cuda"].observe(new)
        wall = time.perf_counter() - t0
        d_cpu = wd["cpu"].observe(new)
        store = wd["cuda"].store
        scored = store.row_id >= first_id
        engine_path.append({"decisions": d_gpu,
                            "row_id": store.row_id[scored],
                            "anomaly": store.anomaly[scored]})
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
    return {"frame": wd["cuda"].store.frame, "history": history,
            "rounds": rounds, "engine_path": engine_path}


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
    return row


def phase_timing(engine, paper_frame, fleet_frame):
    print("[8] timing (CUDA events after warm-up; host clock ending in "
          "synchronize for the scoring call)")
    kernel = {str(N): time_kernel(N) for N in (2048, 262144)}
    engine_rows = [time_engine(engine, paper_frame, reps=10),
                   time_engine(engine, fleet_frame, reps=3)]
    return kernel, engine_rows, time_lm_kernels()


# ------------------------------------------------------------ the LM slice
def _plain_flash(q, k, v, *, causal=True, window=0, scale=None):
    """The plain version in the model's layout (B, S, H, D)."""
    from repro_torch.kernels.flash_attention import ref

    out = ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        scale=scale)
    return out.transpose(1, 2)


def _plain_mlstm(q, k, v, log_i, log_f, *, chunk=64):
    """The plain version in the model's layout (B, S, H, hd)."""
    from repro_torch.kernels.mlstm import ops

    return ops._plain(q, k, v, log_i, log_f, chunk)


def _float64_mlstm(q, k, v, log_i, log_f, *, chunk=64):
    """The plain mLSTM evaluated in float64, h rounded once to q's type
    and the state to float32: a rounding-order-free mLSTM, the control
    of the full-width xLSTM checks."""
    from repro_torch.kernels.mlstm import ops

    h, state = ops._plain(*(t.double() for t in (q, k, v, log_i, log_f)),
                          chunk)
    return h.to(q.dtype), tuple(t.float() for t in state)


@contextlib.contextmanager
def plain_versions(mlstm=None):
    """Run the model with the kernels' plain versions on the card: the
    model reaches its kernels through ``ops.flash_attention``,
    ``ops.linear_scan`` and ``ops.mlstm_chunkwise``, which this swaps
    for the duration (the mLSTM for ``mlstm`` when one is given)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    saved = (fa_ops.flash_attention, lru_ops.linear_scan,
             mlstm_ops.mlstm_chunkwise)
    fa_ops.flash_attention = _plain_flash
    lru_ops.linear_scan = lru_ref.linear_scan
    mlstm_ops.mlstm_chunkwise = mlstm or _plain_mlstm
    try:
        yield
    finally:
        (fa_ops.flash_attention, lru_ops.linear_scan,
         mlstm_ops.mlstm_chunkwise) = saved


@contextlib.contextmanager
def captured_mlstm():
    """Record every call of ``ops.mlstm_chunkwise`` (whatever it is on
    entry: the kernel's wrapper, or a plain version that
    ``plain_versions`` put there): one dict a call, in layer order, with
    the inputs, the chunk and the outputs it returned."""
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    calls = []
    inner = mlstm_ops.mlstm_chunkwise

    def record(q, k, v, log_i, log_f, *, chunk=64, **kw):
        h, state = inner(q, k, v, log_i, log_f, chunk=chunk, **kw)
        calls.append({"inputs": (q, k, v, log_i, log_f), "chunk": chunk,
                      "h": h, "state": state})
        return h, state

    mlstm_ops.mlstm_chunkwise = record
    try:
        yield calls
    finally:
        mlstm_ops.mlstm_chunkwise = inner


def _distances_to_f32(logits, reference):
    """(b) of the full-width xLSTM check: {route: relative L2 distance of
    that route's bf16 prefill logits from ``reference``, the float32
    plain route's logits of the same weights}."""
    return {route: _rel(x, reference)[2] for route, x in logits.items()}


def _flash_inputs(g, B, H, KH, S, D, dtype):
    """q (B, S, H, D), k/v (B, S, KH, D): the model's layout."""
    import torch

    return tuple(torch.randn(B, S, h, D, generator=g, device="cuda")
                 .to(dtype) for h in (H, KH, KH))


def _lru_inputs(g, B, S, C):
    """a in (0.5, 1), as the RG-LRU's exp(log a) sits near 1; b normal."""
    import torch

    a = torch.rand(B, S, C, generator=g, device="cuda") * 0.5 + 0.5
    b = torch.randn(B, S, C, generator=g, device="cuda")
    h0 = torch.randn(B, C, generator=g, device="cuda")
    return a, b, h0


def _lru_tile_edges(g):
    """The scan against the plain version at S and C around the kernel's
    tile (L steps by Ct channels) and past it, B 1/3, with and without
    h0, at the float32 tolerance; h_last is y's last step."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    L, Ct = lru_ops.tile()
    check((L, Ct) == (lru_ops.TILE_STEPS, lru_ops.TILE_CHANNELS),
          f"the built kernel's tile {(L, Ct)} is the wrapper's")
    lengths = (1, L - 1, L, L + 1, 2 * L + 1, 4097)
    widths = (1, 33, Ct - 1, Ct, Ct + 1, 4096)
    n, largest = 0, 0.0
    for S, C, B, with_h0 in itertools.product(lengths, widths, (1, 3),
                                              (True, False)):
        a, b, h0 = _lru_inputs(g, B, S, C)
        h0 = h0 if with_h0 else None
        y, h = lru_ops.linear_scan(a, b, h0)
        ye, he = lru_ref.linear_scan(a, b, h0)
        err = max(float((y - ye).abs().max()), float((h - he).abs().max()))
        label = f"B={B} S={S} C={C} h0={'yes' if with_h0 else 'no'}"
        check(err <= TOL["float32"], f"rg_lru kernel vs plain, {label}: "
                                     f"{err}")
        check(torch.equal(h, y[:, -1]), f"rg_lru h_last is y[:, -1], {label}")
        largest = max(largest, err)
        n += 1
    print(f"  rg_lru tile edges: {n} cases (S {'/'.join(map(str, lengths))}, "
          f"C {'/'.join(map(str, widths))}, B 1/3, h0 or not), largest "
          f"error {largest:.3e} (tol {TOL['float32']:g}) ok")
    return largest, n


LRU_REPEATS = 20


def _lru_repeats(g):
    """LRU_REPEATS launches at B=4 S=4096 C=4096 give the first launch's
    y and h_last bit for bit: the look-back's order fixes the bits."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops

    a, b, _ = _lru_inputs(g, 4, 4096, 4096)
    y0, h0 = lru_ops.linear_scan(a, b)
    for i in range(1, LRU_REPEATS):
        y, h = lru_ops.linear_scan(a, b)
        check(torch.equal(y, y0) and torch.equal(h, h0),
              f"rg_lru launch {i} equals launch 0 bit for bit")
    print(f"  rg_lru determinism: {LRU_REPEATS} launches at B=4 S=4096 "
          f"C=4096 equal bit for bit ok")
    return LRU_REPEATS


# The long-memory case: two float32 orders of the scan each sit some 5e-7
# (relative L2) from float64 and as far from each other, so the kernel is
# held against the plain version in float64: its relative L2 distance e_k
# at most LRU_F64_MARGIN times the float32 plain version's e_p (CPU tests'
# margin, tests/test_torch_rg_lru.py, which measured e_k / e_p up to 1.26
# in the kernel's order).
LRU_F64_MARGIN = 1.5


def _lru_long_memory(g):
    """B=1 S=4096 C=4096: a fixed per channel in (0.9, 0.9999) raised to
    sigmoid of a normal draw per step, b normal and not scaled."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    B, S, C = 1, 4096, 4096
    base = torch.rand(1, 1, C, generator=g, device="cuda") * 0.0999 + 0.9
    z = torch.randn(B, S, C, generator=g, device="cuda")
    a = base ** torch.sigmoid(z)
    b = torch.randn(B, S, C, generator=g, device="cuda")
    y, _ = lru_ops.linear_scan(a, b)
    yp, _ = lru_ref.linear_scan(a, b)
    y64, _ = lru_ref.linear_scan(a, b, dtype=torch.float64)
    yc, _ = lru_ref.linear_scan_chunked(a, b, chunk=lru_ops.TILE_STEPS)
    norm = float(y64.norm())
    out = {"e_k": float((y.double() - y64).norm()) / norm,
           "e_p": float((yp.double() - y64).norm()) / norm,
           "max_k": float((y.double() - y64).abs().max()),
           "max_p": float((yp.double() - y64).abs().max()),
           "max_y": float(y64.abs().max()),
           "kernel_vs_plain": float((y - yp).abs().max()),
           "kernel_vs_chunked_order": float((y - yc).abs().max())}
    limit = LRU_F64_MARGIN * out["e_p"]
    print(f"  rg_lru long memory (B=1 S=4096 C=4096, |y| up to "
          f"{out['max_y']:.1f}): vs float64 e_k {out['e_k']:.3e} (max "
          f"{out['max_k']:.3e}), e_p {out['e_p']:.3e} (max "
          f"{out['max_p']:.3e}), e_k / e_p {out['e_k'] / out['e_p']:.3f}, "
          f"limit {limit:.3e}; kernel vs plain {out['kernel_vs_plain']:.3e} "
          f"and vs its order in plain PyTorch "
          f"{out['kernel_vs_chunked_order']:.3e} (measured)")
    check(out["e_k"] <= limit, f"rg_lru long memory: e_k {out['e_k']} <= "
                               f"{LRU_F64_MARGIN} e_p {out['e_p']}")
    return out


# the bf16 kernel's tile edges: 128 query rows a block, 64 keys a tile,
# 64 rows a warpgroup; T != S included
EDGE_LENGTHS = (15, 63, 64, 65, 127, 128, 129, 191)
EDGE_WINDOWS = (0, 1, 64, 65)


def _flash_tile_edges(g):
    """The bf16 kernel against the plain version at every S, T in
    EDGE_LENGTHS, window in EDGE_WINDOWS, KH 1/4/16, D 16/64/256 (B 1,
    H 16), at the bf16 tolerance on the rows with a live key. A row with
    no live key (i >= T + window - 1, only when T < S) is 0 from the
    kernel; the plain version, as the reference's oracle, averages v
    over all keys there, so those rows are checked to be 0."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    tol = TOL["bfloat16"]
    n, largest, dead_rows = 0, 0.0, 0
    for S, T, W, KH, D in itertools.product(
            EDGE_LENGTHS, EDGE_LENGTHS, EDGE_WINDOWS, (1, 4, 16),
            fa_ops.HEAD_DIMS):
        q = torch.randn(1, S, 16, D, generator=g, device="cuda")
        k, v = (torch.randn(1, T, KH, D, generator=g, device="cuda")
                for _ in range(2))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = fa_ops.flash_attention(q, k, v, window=W)
        expect = _plain_flash(q, k, v, window=W)
        rows = torch.arange(S, device="cuda")
        rows = rows < T + W - 1 if W > 0 else rows >= 0
        label = f"S={S} T={T} window={W} KH={KH} D={D} bfloat16"
        err = float((out.float() - expect.float())[:, rows].abs().max())
        check(err <= tol, f"flash kernel vs plain, {label}: {err}")
        check(not out[:, ~rows].any(), f"flash rows with no live key are "
                                       f"0, {label}")
        largest = max(largest, err)
        dead_rows += int((~rows).sum())
        n += 1
    print(f"  flash bfloat16 tile edges: {n} cases (S, T "
          f"{'/'.join(map(str, EDGE_LENGTHS))}, window 0/1/64/65, KH "
          f"1/4/16, D 16/64/256), largest error {largest:.3e} (tol "
          f"{tol:g}) ok; {dead_rows} rows with no live key are 0")
    return largest, n


def phase_lm_kernels():
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    print("[5] flash_attention_fwd and rg_lru_scan: kernels vs plain "
          "versions on the card")
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {"flash": 0.0, "flash_main": 0.0, "rg_lru": 0.0,
             "rg_lru_main": 0.0}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol = TOL[name]
            n, largest = 0, 0.0
            for B, KH, D, S, W in itertools.product(
                    (1, 2), (1, 16), (64, 256), (1, 100, 2048, 3000, 4096),
                    (0, 2048)):
                q, k, v = _flash_inputs(g, B, 16, KH, S, D, dtype)
                out = fa_ops.flash_attention(q, k, v, window=W)
                expect = _plain_flash(q, k, v, window=W)
                torch.cuda.synchronize()
                check(out.shape == expect.shape and out.dtype == q.dtype,
                      "flash shapes and type")
                err = float((out.float() - expect.float()).abs().max())
                label = (f"B={B} H=16 KH={KH} D={D} S={S} window={W} "
                         f"{name}")
                check(err <= tol, f"flash kernel vs plain, {label}: {err}")
                largest = max(largest, err)
                if (B, KH, D, S, W) == (1, 1, 256, 4096, 2048) and \
                        dtype == torch.bfloat16:
                    worst["flash_main"] = err
                n += 1
                del q, k, v, out, expect
            worst["flash"] = max(worst["flash"], largest)
            print(f"  flash {name}: {n} cases (B 1/2, H 16, KH 1/16, D "
                  f"64/256, S 1/100/2048/3000/4096, window 0/2048), largest "
                  f"error {largest:.3e} (tol {tol:g}) ok")
        worst["flash_edges"], worst["flash_edge_cases"] = \
            _flash_tile_edges(g)
        torch.cuda.empty_cache()
        for B, S, with_h0 in itertools.product((1, 4), (1, 257, 4096),
                                               (True, False)):
            a, b, h0 = _lru_inputs(g, B, S, 4096)
            h0 = h0 if with_h0 else None
            y, h = lru_ops.linear_scan(a, b, h0)
            ye, he = lru_ref.linear_scan(a, b, h0)
            torch.cuda.synchronize()
            err = max(float((y - ye).abs().max()),
                      float((h - he).abs().max()))
            label = f"B={B} S={S} C=4096 h0={'yes' if with_h0 else 'no'}"
            print(f"  rg_lru {label:30s} err {err:.3e} tol "
                  f"{TOL['float32']:g} ok" if err <= TOL["float32"] else
                  f"  rg_lru {label} err {err:.3e} FAIL")
            check(err <= TOL["float32"], f"rg_lru kernel vs plain, {label}")
            worst["rg_lru"] = max(worst["rg_lru"], err)
            if (B, S, with_h0) == (1, 4096, False):
                worst["rg_lru_main"] = err
        torch.cuda.empty_cache()
        worst["rg_lru_edges"], worst["rg_lru_edge_cases"] = \
            _lru_tile_edges(g)
        worst["rg_lru_repeats"] = _lru_repeats(g)
        worst["rg_lru_long_memory"] = _lru_long_memory(g)
    torch.cuda.empty_cache()
    return worst


def phase_lm_golden(path=None, label="[6] small RecurrentGemma"):
    """The small model of an LM golden file, on the card, in float32:
    prefill and decode logits against the JAX package's, and the served
    tokens."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import (LM_GOLDEN_PATH, cast_params,
                                           load_lm_golden)

    print(f"{label} on the card vs the JAX package's outputs (golden "
          f"file)")
    golden = load_lm_golden(path or LM_GOLDEN_PATH)
    cfg = golden.config
    model = build_model(cfg)
    params = cast_params(golden.params, cfg, "cuda")
    B = golden.prefill_tokens.shape[0]
    S = golden.prefill_tokens.shape[1]
    with torch.inference_mode():
        cache = model.init_cache(B, golden.cache_len,
                                 dtype=getattr(torch, golden.cache_dtype),
                                 device="cuda")
        lp, cache = model.prefill(
            params, cache,
            tokens=torch.as_tensor(golden.prefill_tokens, device="cuda"))
        errs = [float(np.abs(lp.cpu().numpy() - golden.prefill_logits)
                      .max())]
        for i, tok in enumerate(golden.decode_tokens):
            ld, cache = model.decode_step(
                params, torch.as_tensor(tok, device="cuda")[:, None],
                torch.full((B,), S + i, device="cuda"), cache)
            errs.append(float(np.abs(ld.cpu().numpy()
                                     - golden.decode_logits[i]).max()))
        check(bool(torch.isfinite(lp).all()), "finite golden logits")
    server = SlotServer(model, params, n_slots=golden.slots,
                        max_len=golden.max_len)
    reqs = [Request(rid=i, prompt=p, max_new=golden.max_new)
            for i, p in enumerate(golden.prompts)]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    served = [done[i] for i in range(len(reqs))]
    same = served == golden.served
    print(f"  {cfg.name} scaled down ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, float32, {golden.cache_dtype} caches): prefill "
          f"logits err {errs[0]:.3e}, decode steps err {max(errs[1:]):.3e} "
          f"(atol {LM_GOLDEN_ATOL:g}); {len(reqs)} served requests (prompts "
          f"{[len(p) for p in golden.prompts]}), tokens equal JAX's: {same}")
    check(max(errs) <= LM_GOLDEN_ATOL, f"golden logits: {errs}")
    check(same, "served tokens equal the JAX SlotServer's")
    return {"prefill_err": errs[0], "decode_err": max(errs[1:]),
            "served_equal": same}


def _rel(a, b):
    """max |a - b|, max |b| and ||a - b|| / ||b||, in float32."""
    import torch

    a, b = a.float(), b.float()
    return (float((a - b).abs().max()), float(b.abs().max()),
            float(torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b)))


def _prefill_logits(model, params, prompt, route="kernels", calls=None):
    """Prefill logits of one prompt on the device that holds ``params``,
    through the kernels (``"kernels"``), their plain versions
    (``"plain"``), or the plain versions with the mLSTM evaluated in
    float64 and rounded once to the model's type (``"plain_f64_mlstm"``).
    On the CPU the wrappers take their plain versions anyway. A list
    ``calls`` receives the mLSTM layers' calls (``captured_mlstm``)."""
    import torch

    from repro_torch.models.transformer import tree_map

    leaves = []
    tree_map(leaves.append, params)
    dev = leaves[0].device
    routes = {"kernels": contextlib.nullcontext, "plain": plain_versions,
              "plain_f64_mlstm": lambda: plain_versions(_float64_mlstm)}
    toks = torch.as_tensor(prompt, device=dev).long()[None]
    cache = model.init_cache(1, FULL_MAX_LEN, device=dev)
    capture = (captured_mlstm() if calls is not None
               else contextlib.nullcontext([]))
    with routes[route](), capture as got:
        logits, _ = model.prefill(params, cache, tokens=toks)
    if calls is not None:
        calls.extend(got)
    return logits


def _kernels_vs_plain(model, params, prompts, tol, label):
    """Prefill logits of each prompt through the kernels and through
    the plain versions, on the card; returns {S: (max err, max |logit|,
    relative L2)}."""
    errs = {}
    for prompt in prompts:
        t0 = time.perf_counter()
        out = {mode: _prefill_logits(model, params, prompt, mode)
               for mode in ("kernels", "plain")}
        err = errs[len(prompt)] = _rel(out["kernels"], out["plain"])
        print(f"  {label} prefill logits S={len(prompt)}, kernels vs plain "
              f"versions: max err {err[0]:.3e} of max |logit| {err[1]:.1f},"
              f" relative L2 {err[2]:.2e} (tol {tol:g}); "
              f"{time.perf_counter() - t0:.1f} s")
        check(err[2] <= tol, f"{label} prefill S={len(prompt)}, kernels vs "
                             f"plain versions")
    return errs


def _reference_ring_layout(cfg, cache, length):
    """Rearrange the local-attention caches after a prefill of
    ``length`` > W tokens into the reference's layout (the last W keys
    at ring indices 0..W-1, ``repro/models/attention.py:310-312``) from
    the port's (position p at index p mod W)."""
    import torch

    for i, kind in enumerate(cfg.body_pattern):
        if kind != "local_attn":
            continue
        for leaf in cache["body"][i].values():  # (n_periods, B, W, ...)
            W = leaf.shape[2]
            leaf.copy_(torch.roll(leaf, -((length - W) % W), dims=2))


def _ring_check(model, params, req, cache_dtype, tol, label,
                reference_layout=False):
    """Decode after a prefill of ``req.prompt`` vs a no-cache forward
    over the prompt and the first token, on the card."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    S = len(req.prompt)
    t0 = time.perf_counter()
    toks = torch.as_tensor(req.prompt, device="cuda").long()[None]
    first = torch.tensor([[req.tokens[0]]], device="cuda")
    cache = model.init_cache(1, FULL_MAX_LEN, dtype=cache_dtype,
                             device="cuda")
    model.prefill(params, cache, tokens=toks)
    if reference_layout:
        _reference_ring_layout(cfg, cache, S)
    ld, _ = model.decode_step(params, first,
                              torch.tensor([S], device="cuda"), cache)
    del cache
    hidden, _ = tfm.forward(params, cfg, tokens=torch.cat([toks, first], 1),
                            skip_unembed=True)
    lf = tfm.unembed(params, cfg, hidden[:, -1:])[:, 0]
    del hidden
    check(bool(torch.isfinite(ld).all()), "finite decode logits")
    err = _rel(ld, lf)
    print(f"  {label}: decode at position {S} after prefill vs no-cache "
          f"forward over {S + 1} tokens: max err {err[0]:.3e} of max "
          f"|logit| {err[1]:.1f}, relative L2 {err[2]:.2e} (tol {tol:g}); "
          f"{time.perf_counter() - t0:.1f} s")
    return err


def phase_lm_full():
    """recurrentgemma-9b at full width, bf16, weights from seed 0 on the
    card, serving eight requests through SlotServer; then the same
    weights in float32 for the sharp checks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.launch.serve import SlotServer, make_requests
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("recurrentgemma-9b")
    print(f"[7] {cfg.name} at full width on the card: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {FULL_SLOTS} slots, prompts {FULL_LENGTHS}, "
          f"max_new {FULL_MAX_NEW}, max_len {FULL_MAX_LEN}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  weights: {n_params / 1e9:.3f} B parameters, "
          f"{n_bytes / 1e9:.2f} GB on the card, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    per_prefill = {"flash": cfg.layer_kinds.count("local_attn"),
                   "rg_lru": cfg.layer_kinds.count("rg_lru")}
    requests = make_requests(len(FULL_LENGTHS), cfg.vocab_size,
                             FULL_MAX_NEW, seed=0, lengths=FULL_LENGTHS)
    server = SlotServer(model, params, n_slots=FULL_SLOTS,
                        max_len=FULL_MAX_LEN)
    # warm-up, not measured: one short request through a second server
    # (first cuBLAS plans, first kernel calls)
    warm = make_requests(1, cfg.vocab_size, 2, seed=1, lengths=(64,))
    SlotServer(model, params, n_slots=FULL_SLOTS,
               max_len=FULL_MAX_LEN).serve(warm)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = 0  # the LM main path starts here
    lru_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    out = server.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash": fa_ops.LAUNCHES,
                "rg_lru": lru_ops.LAUNCHES}  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    done = sorted(out["completed"], key=lambda r: r.rid)
    check(len(done) == len(FULL_LENGTHS), "every request completed")
    check(all(len(r.tokens) == FULL_MAX_NEW for r in done),
          f"every request got {FULL_MAX_NEW} tokens")
    for name, n in per_prefill.items():
        check(launches[name] == n * len(FULL_LENGTHS),
              f"{name}: {launches[name]} launches, expected {n} per "
              f"prefill x {len(FULL_LENGTHS)}")
    prompt_tokens = sum(FULL_LENGTHS)
    prefill_s = sum(r.prefill_s for r in done)
    row = {
        "requests": len(done), "prompt_tokens": prompt_tokens,
        "decode_steps": out["decode_steps"], "wall_s": wall,
        "ttft_s": {len(r.prompt): r.ttft_s for r in done},
        "prefill_latency_s": {len(r.prompt): r.prefill_s for r in done},
        "prefill_tokens_per_s": prompt_tokens / prefill_s,
        "decode_tokens": server.decode_tokens,
        "decode_s": server.decode_s,
        "decode_tokens_per_s": server.decode_tokens / server.decode_s,
        "peak_memory_bytes": peak, "weight_bytes": n_bytes,
        "launches": launches, "launches_per_prefill": per_prefill,
    }
    print(f"  served {len(done)} requests x {FULL_MAX_NEW} tokens in "
          f"{wall:.2f} s, {out['decode_steps']} decode steps; launches "
          f"{launches} ({per_prefill} per prefill)")
    print("  time to first token (arrival at the server -> first token, "
          "host clock): " + ", ".join(
              f"S={s} {t * 1e3:.1f} ms" for s, t in row["ttft_s"].items()))
    print("  prefill latency (prefill start -> first token): " + ", ".join(
        f"S={s} {t * 1e3:.1f} ms"
        for s, t in row["prefill_latency_s"].items()))
    print(f"  prefill {row['prefill_tokens_per_s']:.0f} tokens/s; decode "
          f"{row['decode_tokens_per_s']:.1f} tokens/s ({server.decode_tokens}"
          f" tokens in {server.decode_s:.2f} s, {FULL_SLOTS} slots); peak "
          f"memory {peak / 1e9:.2f} GB")

    by_len = {len(r.prompt): r for r in done}
    ring_req = by_len[FULL_RING_LENGTH]
    checks = {}
    with torch.inference_mode():
        # the served model, bf16
        for length in FULL_CHECK_LENGTHS:
            toks = torch.as_tensor(by_len[length].prompt, device="cuda")
            logits, _ = model.prefill(
                params, model.init_cache(1, FULL_MAX_LEN, device="cuda"),
                tokens=toks.long()[None])
            check(int(logits.argmax()) == by_len[length].tokens[0],
                  "a prefill of the served prompt gives the served token")
        checks["bf16_kernels_vs_plain"] = _kernels_vs_plain(
            model, params, [by_len[n].prompt for n in FULL_CHECK_LENGTHS],
            FULL_BF16_REL_TOL, "bf16")
        checks["bf16_ring"] = _ring_check(
            model, params, ring_req, torch.bfloat16, FULL_BF16_REL_TOL,
            "bf16 ring check")
        check(checks["bf16_ring"][2] <= FULL_BF16_REL_TOL,
              "bf16 ring check at full width")
        row["profile"] = profile_lm(model, params, server, by_len[4096])
        del server
        # the same weights in float32 (bf16 -> f32 is exact): the
        # sharp versions of both checks, and the reference's layout as
        # the control that the ring check sees a misplaced key
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = build_model(cfg32)
        params32 = tfm.tree_map(lambda t: t.float(), params)
        checks["f32_kernels_vs_plain"] = _kernels_vs_plain(
            model32, params32, [by_len[FULL_CHECK_LENGTHS[0]].prompt],
            FULL_F32_REL_TOL, "f32")
        ring = _ring_check(model32, params32, ring_req, torch.float32,
                           FULL_F32_REL_TOL, "f32 ring check")
        check(ring[2] <= FULL_F32_REL_TOL, "f32 ring check at full width")
        control = _ring_check(model32, params32, ring_req, torch.float32,
                              FULL_F32_REL_TOL,
                              "f32, reference's ring layout (control)",
                              reference_layout=True)
        check(control[2] > FULL_F32_REL_TOL,
              "the f32 ring check sees the reference's ring layout")
        checks["f32_ring"], checks["f32_ring_reference_layout"] = (ring,
                                                                   control)
        del params32
    torch.cuda.empty_cache()
    row["checks"] = {k: ({str(s): e for s, e in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in checks.items()}
    return row, launches


def _leaves(tree):
    from repro_torch.models.transformer import tree_map

    out = []
    tree_map(out.append, tree)
    return out


def _top_device(prof, n=10):
    from torch.autograd import DeviceType

    kernels = [(evt.self_device_time_total, evt.count, evt.key)
               for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and not evt.key.startswith("Activity Buffer")]
    kernels.sort(reverse=True)
    return sum(us for us, _, _ in kernels), kernels[:n]  # n=None: all


# the port's kernels, as the profiler names them (csrc/*.cu)
PORT_KERNELS = ("rg_lru_scan_kernel", "flash_fwd", "mlstm_",
                "edge_softmax_fwd", "edge_softmax_bwd")


def _port_device(prof):
    """Device time (us) and launches of each of PORT_KERNELS' entries,
    whatever their rank."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for name in PORT_KERNELS:
            if name in evt.key:
                us, count = out.get(name, (0.0, 0))
                out[name] = (us + evt.self_device_time_total,
                             count + evt.count)
    return out


def profile_lm(model, params, server, req, host_ops=True):
    """The profiler's top device entries for one 4096-token prefill and
    for four decode steps of all slots. ``host_ops=False`` records the
    device activity only (for a prefill of some hundred thousand small
    launches, where recording every host op would dominate the wall
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tfm

    toks = torch.as_tensor(req.prompt, device="cuda").long()[None]
    pos = torch.full((server.n_slots,), FULL_MAX_LEN // 2, device="cuda")
    last = torch.zeros(server.n_slots, 1, dtype=torch.long, device="cuda")
    rows = tfm.cache_rows(server.cache, slice(0, 1))
    out = {}
    with torch.inference_mode():
        for name, fn in (
                ("prefill_4096",
                 lambda: model.prefill(params, rows, tokens=toks)),
                ("decode_4_steps", lambda: [
                    model.decode_step(params, last, pos + i, server.cache)
                    for i in range(4)])):
            fn()  # warm
            torch.cuda.synchronize()
            activities = ([ProfilerActivity.CPU] if host_ops else []) + [
                ProfilerActivity.CUDA]
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            device_us, top = _top_device(prof)
            port = _port_device(prof)
            out[name] = {"wall_s": wall, "device_s": device_us / 1e6,
                         "device_idle_share": 1.0 - device_us / 1e6 / wall,
                         "top": [{"name": k[:90], "us": us, "count": c}
                                 for us, c, k in top],
                         "port_kernels": {k: {"us": us, "count": c}
                                          for k, (us, c) in port.items()}}
            print(f"  profiled {name}: {wall * 1e3:.1f} ms wall, "
                  f"{device_us / 1e3:.1f} ms of device activity, idle share "
                  f"{out[name]['device_idle_share']:.4f}; the port's kernels: "
                  + (", ".join(f"{k} {us / 1e3:.3f} ms x{c} "
                               f"({us / device_us:.2%})"
                               for k, (us, c) in port.items()) or "none")
                  + "; top device entries:")
            for us, c, k in top:
                print(f"    {us:10.1f} us x{c:4d}  {k[:90]}")
    return out


def time_lm_kernels():
    """Each LM kernel at the full-width prefill shapes, with its plain
    version, the library call and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(3)
    B, H, KH, S, D, W = 1, 16, 1, 4096, 256, 2048
    q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.bfloat16)
    with torch.no_grad():
        ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, window=W), 20)
        plain = cuda_ms(lambda: _plain_flash(q, k, v, window=W), 3)
        # the float32 route (the CUDA-core kernel) at the same shape
        qf, kf, vf = (t.float() for t in (q, k, v))
        f32_ms = cuda_ms(lambda: fa_ops.flash_attention(qf, kf, vf,
                                                        window=W), 5)
        # one library call of the same function: SDPA with a boolean
        # causal + window mask, in its own layout (B, H, S, D), with k/v
        # expanded to the 16 query heads; the copies are not timed
        pos = torch.arange(S, device="cuda")
        rel = pos[:, None] - pos[None, :]
        mask = (rel >= 0) & (rel < W)

        def sdpa_args(q, k, v):
            return (q.transpose(1, 2).contiguous(),
                    *(t.transpose(1, 2).contiguous().expand(B, H, S, D)
                      for t in (k, v)))

        # the same on the float32 route's problem
        f32_args = sdpa_args(qf, kf, vf)
        f32_library = cuda_ms(lambda: F.scaled_dot_product_attention(
            *f32_args, attn_mask=mask), 5)
        del qf, kf, vf, f32_args
        qt, ke, ve = sdpa_args(q, k, v)
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask), 5)
        lib_err = float((F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask).transpose(1, 2).float()
            - fa_ops.flash_attention(q, k, v, window=W).float())
            .abs().max())
    check(lib_err <= TOL["bfloat16"], f"SDPA vs flash kernel: {lib_err}")
    pairs = sum(min(i + 1, W) for i in range(S))  # live (q, k) per head
    flops = 4 * D * pairs * H * B
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    f32_bound = f32_bound_ms(flops, 2 * nbytes)
    attrs = fa_ops.tensor_core_attributes(D)
    flash = {"shape": f"B={B} H={H} KH={KH} S={S} D={D} window={W} "
                      f"bfloat16", "ms": ms, "plain_ms": plain,
             "library_ms": library, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "flops": flops, "bytes": nbytes, "pairs_per_head": pairs,
             "tflop_per_s": flops / ms / 1e9, "f32_ms": f32_ms,
             "f32_tflop_per_s": flops / f32_ms / 1e9,
             "f32_bound_ms": f32_bound, "f32_library_ms": f32_library,
             "design": fa_ops.route(q.dtype, D), "attributes": attrs,
             "library_vs_kernel": lib_err}
    print(f"  flash {flash['shape']}: kernel ({flash['design']}) {ms:.4f} "
          f"ms, plain {plain:.4f} ms, SDPA {library:.4f} ms, bound "
          f"{flash['bound_ms']:.4f} ms ({flash['bound_by']}: "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"{flash['tflop_per_s']:.1f} TFLOP/s; SDPA vs kernel "
          f"{lib_err:.2e}")
    print(f"  flash float32 route (cuda_core) at the same shape: "
          f"{f32_ms:.4f} ms, {flash['f32_tflop_per_s']:.1f} TFLOP/s; its "
          f"own bound {f32_bound:.4f} ms (operations at the float32 rate, "
          f"{F32_FLOP_PER_S / 1e12:g} TFLOP/s); SDPA on the float32 problem "
          f"{f32_library:.4f} ms")
    print(f"  flash bfloat16 kernel at D={D}: {attrs['registers']} registers "
          f"a thread, {attrs['local_bytes']} local bytes, "
          f"{attrs['static_smem_bytes'] + attrs['dynamic_smem_bytes']} "
          f"bytes of shared memory a block")
    del q, k, v, qt, ke, ve
    torch.cuda.empty_cache()
    return {"flash": flash, "rg_lru": time_lru(g)}


# the RG-LRU scan's timed shapes (B, S) at C = 4096: the main shape (a
# 4096-token prefill) first, then a short and a ragged prompt and 4 rows
LRU_TIMED = ((1, 4096), (1, 128), (1, 1000), (4, 4096))


def time_lru(g):
    """The scan at each of LRU_TIMED with its plain version, bound, TB/s
    and scratch; the kernel's registers and local bytes."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    C = 4096
    L, Ct = lru_ops.tile()
    attrs = lru_ops.attributes()
    rows = []
    for B, S in LRU_TIMED:
        a, b, _ = _lru_inputs(g, B, S, C)
        with torch.no_grad():
            ms = cuda_ms(lambda: lru_ops.linear_scan(a, b), 50)
            # without the wrapper's host time between launches
            in_graph = graph_ms(lambda: lru_ops.linear_scan(a, b))
            # a yardstick, not the same function: one PyTorch elementwise
            # call that moves the same bytes (a, b in, y out)
            y = torch.empty_like(a)
            stream = graph_ms(lambda: torch.add(b, a, alpha=0.5, out=y))
            plain = cuda_ms(lambda: lru_ref.linear_scan(a, b), 2)
        nbytes = 3 * a.nbytes + B * C * 4  # a, b in; y, h_last out
        flops = 2 * B * S * C
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        row = {"shape": f"B={B} S={S} C={C} float32, no h0", "ms": ms,
               "graph_ms": in_graph, "stream_ms": stream, "plain_ms": plain,
               "library_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "flops": flops, "bytes": nbytes,
               "tb_per_s": nbytes / ms / 1e9,
               "scratch_bytes": lru_ops.scratch_bytes(B, S, C)}
        print(f"  rg_lru {row['shape']}: kernel {ms:.4f} ms ({in_graph:.4f} "
              f"in a CUDA graph; the same bytes through torch.add "
              f"{stream:.4f}), plain {plain:.4f} ms, no library call, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB); {row['tb_per_s']:.2f} TB/s, "
              f"{row['bound_ms'] / ms:.0%} of the bound; scratch "
              f"{row['scratch_bytes'] / 1e6:.2f} MB")
        rows.append(row)
        del a, b, y
    print(f"  rg_lru kernel: tile {L} steps x {Ct} channels, "
          f"{attrs['registers']} registers a thread, {attrs['local_bytes']} "
          f"local bytes, {attrs['static_smem_bytes']} bytes of shared "
          f"memory a block")
    check(attrs["local_bytes"] == 0, f"the RG-LRU kernel does not spill: "
                                     f"{attrs}")
    return dict(rows[0], design=f"single-pass chunked scan, decoupled "
                f"look-back, tiles of {L} steps x {Ct} channels",
                attributes=attrs, by_shape=rows)


# ---------------------------------------------------------- the xLSTM slice
def _mlstm_inputs(g, B, S, H, hd, dtype):
    """The distributions of the reference's kernel test
    (tests/test_kernels.py:107-112) in the model's layout: q, v normal,
    k normal / sqrt(hd), log_i 0.5 normal, log_f log_sigmoid(normal + 2)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (torch.randn(B, S, H, hd, generator=g, device="cuda")
               for _ in range(3))
    k = k / hd ** 0.5
    li = torch.randn(B, S, H, generator=g, device="cuda") * 0.5
    lf = F.logsigmoid(torch.randn(B, S, H, generator=g, device="cuda") + 2)
    return q.to(dtype), k.to(dtype), v.to(dtype), li, lf


def _mlstm_vs_plain(q, k, v, li, lf, chunk):
    """The mLSTM kernel and its plain version on the same inputs, held at
    the kernel phase's limits; returns (ok, errors of h, C, n, m, the
    rule, bf16 h err / max(1, |h|) or None)."""
    import torch

    from repro_torch.kernels.mlstm import ops

    h, state = ops.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
    he, state_e = ops._plain(q, k, v, li, lf, chunk)
    torch.cuda.synchronize()
    check(h.shape == he.shape and h.dtype == q.dtype,
          "mlstm h shape and type")
    errs = {label: _rel(a, e) for label, a, e in
            zip("hCnm", (h,) + state, (he,) + state_e)}
    scaled = None
    if q.dtype == torch.bfloat16:
        # h is rounded to bf16 on both sides: one rounding step apart is
        # 2^-8 |h|, over 2e-2 where |h| > 5, so the bound is 2e-2 at unit
        # scale and relative above it
        scaled = float(((h.float() - he.float()).abs()
                        / he.float().abs().clamp_min(1)).max())
        ok = (scaled <= TOL["bfloat16"]
              and all(errs[x][2] <= MLSTM_REL_TOL for x in "Cnm"))
        rule = (f"h err / max(1, |h|) {scaled:.2e} <= {TOL['bfloat16']:g}, "
                f"state rel L2 {MLSTM_REL_TOL:g}")
    elif q.shape[-1] == 1024:
        ok = all(e[2] <= MLSTM_REL_TOL for e in errs.values())
        rule = f"rel L2 {MLSTM_REL_TOL:g}"
    else:
        ok = all(e[0] <= TOL["float32"] for e in errs.values())
        rule = f"abs {TOL['float32']:g}"
    return ok, errs, rule, scaled


# the bf16 route's tile edges: 128 rows a score or output tile, 64 keys a
# W v step, 16 rows a states step, chunks of 256, 100 and 64 rows with a
# short last one, 64 head-dim columns a TMA box, 128 (d, e) a states tile,
# 256 value columns an output tile
MLSTM_EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 256,
                      257, 383, 511, 513)
MLSTM_EDGE_HEAD_DIMS = (32, 96, 160, 288)
MLSTM_EDGE_CHUNKS = (256, 100, 64)
MLSTM_EDGE_BATCH_HEADS = ((1, 1), (2, 3))


def _mlstm_tile_edges(g):
    """The bf16 route against the plain version at every S, hd, chunk and
    (B, H) of the edge lists, at the bf16 limits."""
    import torch

    worst = {"h_scaled": 0.0, "h_rel_l2": 0.0, "state_rel_l2": 0.0}
    n = 0
    for S, hd, chunk, (B, H) in itertools.product(
            MLSTM_EDGE_LENGTHS, MLSTM_EDGE_HEAD_DIMS, MLSTM_EDGE_CHUNKS,
            MLSTM_EDGE_BATCH_HEADS):
        q, k, v, li, lf = _mlstm_inputs(g, B, S, H, hd, torch.bfloat16)
        ok, errs, rule, scaled = _mlstm_vs_plain(q, k, v, li, lf, chunk)
        label = f"B={B} S={S} H={H} hd={hd} chunk={chunk} bfloat16"
        check(ok, f"mlstm tensor-core route vs plain, {label}: {rule}; "
                  f"{errs}")
        worst["h_scaled"] = max(worst["h_scaled"], scaled)
        worst["h_rel_l2"] = max(worst["h_rel_l2"], errs["h"][2])
        worst["state_rel_l2"] = max(worst["state_rel_l2"],
                                    *(errs[x][2] for x in "Cnm"))
        n += 1
    print(f"  mlstm bfloat16 tile edges: {n} cases (S "
          f"{'/'.join(map(str, MLSTM_EDGE_LENGTHS))}, hd "
          f"{'/'.join(map(str, MLSTM_EDGE_HEAD_DIMS))}, chunk "
          f"{'/'.join(map(str, MLSTM_EDGE_CHUNKS))}, (B, H) "
          f"{'/'.join(map(str, MLSTM_EDGE_BATCH_HEADS))}): largest h err / "
          f"max(1, |h|) {worst['h_scaled']:.3e} ({TOL['bfloat16']:g}), h rel "
          f"L2 {worst['h_rel_l2']:.3e}, state rel L2 "
          f"{worst['state_rel_l2']:.3e} ({MLSTM_REL_TOL:g}) ok")
    return dict(worst, cases=n)


def phase_mlstm_kernel():
    """(a) the mLSTM kernel against its plain version on the card, both
    routes, then the bf16 route's tile edges."""
    import torch

    from repro_torch.kernels.mlstm import ops

    print("[9] mlstm_chunkwise: kernel vs plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(4)
    # (B, S, H, hd, chunk): the reference's test shapes (B*H = BH), then
    # hd 32 and 1024 at ragged and whole lengths with chunk 256
    cases = [(2, 128, 1, 64, 64), (4, 64, 1, 32, 32), (1, 256, 1, 128, 64)]
    cases += [(1, S, 4, hd, MLSTM_CHUNK) for hd in (32, 1024)
              for S in (1, 100, 256, 257, 1000, 3000, 4096)]
    worst = {"float32": 0.0, "bfloat16": 0.0, "main": 0.0,
             "design": {str(d).split(".")[-1]: ops.route(d)
                        for d in (torch.float32, torch.bfloat16)}}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for B, S, H, hd, chunk in cases:
                q, k, v, li, lf = _mlstm_inputs(g, B, S, H, hd, dtype)
                ok, errs, rule, _ = _mlstm_vs_plain(q, k, v, li, lf, chunk)
                label = f"B={B} S={S} H={H} hd={hd} chunk={chunk} {name}"
                print(f"  {label:40s} max err h {errs['h'][0]:.2e} C "
                      f"{errs['C'][0]:.2e} n {errs['n'][0]:.2e} m "
                      f"{errs['m'][0]:.2e}; rel L2 h {errs['h'][2]:.2e} C "
                      f"{errs['C'][2]:.2e} ({rule}) {'ok' if ok else 'FAIL'}")
                check(ok, f"mlstm kernel vs plain, {label}: {errs}")
                worst[name] = max(worst[name], errs["h"][0])
                if (S, hd) == (4096, 1024) and name == "bfloat16":
                    worst["main"] = errs["h"][0]
                del q, k, v
        print(f"  {len(cases)} cases per type, routes "
              f"{worst['design']}")
        worst["edges"] = _mlstm_tile_edges(g)
    torch.cuda.empty_cache()
    return worst


def phase_xlstm_full():
    """(c) xlstm-1.3b at full width, bf16, weights from seed 0 on the
    card, serving eight requests through SlotServer; (d) the prefill
    logits through the kernel vs the plain version and decode after a
    3000-token prefill vs a no-cache forward, in bf16 and with the same
    weights in float32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.launch.serve import SlotServer, make_requests
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("xlstm-1.3b")
    print(f"[12] {cfg.name} at full width on the card: {cfg.n_layers} "
          f"layers ({cfg.layer_kinds.count('mlstm')} mLSTM, "
          f"{cfg.layer_kinds.count('slstm')} sLSTM), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{FULL_SLOTS} slots, prompts {XLSTM_LENGTHS}, max_new "
          f"{FULL_MAX_NEW}, max_len {FULL_MAX_LEN}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  weights: {n_params:,} parameters, {n_bytes / 1e9:.2f} GB on "
          f"the card, drawn in {time.perf_counter() - t0:.1f} s")
    check(n_params == XLSTM_PARAMS, f"{n_params} parameters, expected "
                                    f"{XLSTM_PARAMS}")
    per_prefill = cfg.layer_kinds.count("mlstm")
    requests = make_requests(len(XLSTM_LENGTHS), cfg.vocab_size,
                             FULL_MAX_NEW, seed=0, lengths=XLSTM_LENGTHS)
    server = SlotServer(model, params, n_slots=FULL_SLOTS,
                        max_len=FULL_MAX_LEN)
    # warm-up, not measured: one short request through a second server
    warm = make_requests(1, cfg.vocab_size, 2, seed=1, lengths=(64,))
    SlotServer(model, params, n_slots=FULL_SLOTS,
               max_len=FULL_MAX_LEN).serve(warm)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mlstm_ops.LAUNCHES = 0  # the xLSTM main path starts here
    t0 = time.perf_counter()
    out = server.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mlstm_ops.LAUNCHES  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    done = sorted(out["completed"], key=lambda r: r.rid)
    check(len(done) == len(XLSTM_LENGTHS), "every request completed")
    check(all(len(r.tokens) == FULL_MAX_NEW for r in done),
          f"every request got {FULL_MAX_NEW} tokens")
    check(launches == per_prefill * len(XLSTM_LENGTHS),
          f"mlstm: {launches} launches, expected {per_prefill} per prefill "
          f"x {len(XLSTM_LENGTHS)}")
    prompt_tokens = sum(XLSTM_LENGTHS)
    prefill_s = sum(r.prefill_s for r in done)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(server.cache))
    row = {
        "parameters": n_params, "requests": len(done),
        "prompt_tokens": prompt_tokens, "decode_steps": out["decode_steps"],
        "wall_s": wall,
        "ttft_s": {len(r.prompt): r.ttft_s for r in done},
        "prefill_latency_s": {len(r.prompt): r.prefill_s for r in done},
        "prefill_tokens_per_s": prompt_tokens / prefill_s,
        "decode_tokens": server.decode_tokens,
        "decode_s": server.decode_s,
        "decode_tokens_per_s": server.decode_tokens / server.decode_s,
        "peak_memory_bytes": peak, "weight_bytes": n_bytes,
        "cache_bytes": cache_bytes,
        "launches": launches, "launches_per_prefill": per_prefill,
    }
    print(f"  served {len(done)} requests x {FULL_MAX_NEW} tokens in "
          f"{wall:.2f} s, {out['decode_steps']} decode steps; mlstm launches "
          f"{launches} ({per_prefill} per prefill)")
    print("  time to first token (arrival at the server -> first token, "
          "host clock): " + ", ".join(
              f"S={s} {t * 1e3:.1f} ms" for s, t in row["ttft_s"].items()))
    print("  prefill latency (prefill start -> first token): " + ", ".join(
        f"S={s} {t * 1e3:.1f} ms"
        for s, t in row["prefill_latency_s"].items()))
    print(f"  prefill {row['prefill_tokens_per_s']:.0f} tokens/s; decode "
          f"{row['decode_tokens_per_s']:.1f} tokens/s ({server.decode_tokens}"
          f" tokens in {server.decode_s:.2f} s, {FULL_SLOTS} slots); peak "
          f"memory {peak / 1e9:.2f} GB ({n_bytes / 1e9:.2f} GB weights, "
          f"{cache_bytes / 1e9:.2f} GB of slot caches)")

    by_len = {len(r.prompt): r for r in done}
    req = by_len[XLSTM_CHECK_LENGTH]
    S = len(req.prompt)
    checks = {}
    with torch.inference_mode():
        row["profile"] = profile_lm(model, params, server, by_len[4096],
                                    host_ops=False)
        del server
        torch.cuda.empty_cache()
        # bf16 prefill logits through the kernels, the plain versions (each
        # mLSTM layer's call recorded) and the plain versions with the
        # mLSTM in float64
        t0 = time.perf_counter()
        calls = []
        bf16 = {"kernels": _prefill_logits(model, params, req.prompt),
                "plain": _prefill_logits(model, params, req.prompt, "plain",
                                         calls=calls),
                "plain_f64_mlstm": _prefill_logits(model, params, req.prompt,
                                                   "plain_f64_mlstm")}
        err = checks["bf16_kernel_vs_plain"] = _rel(bf16["kernels"],
                                                    bf16["plain"])
        control = checks["bf16_f64_mlstm_vs_plain"] = _rel(
            bf16["plain_f64_mlstm"], bf16["plain"])
        print(f"  bf16 prefill logits S={S}, kernels vs plain versions: max "
              f"err {err[0]:.3e} of max |logit| {err[1]:.1f}, relative L2 "
              f"{err[2]:.2e} (measured, not gated: see (b)); control, plain "
              f"versions with the mLSTM in float64 (rounded once to bf16) vs "
              f"plain versions: max err {control[0]:.3e}, relative L2 "
              f"{control[2]:.2e}; {time.perf_counter() - t0:.1f} s")
        checks["mlstm_layers"] = _mlstm_layers_vs_plain(calls, S)
        del calls
        torch.cuda.empty_cache()
        checks["bf16_decode"] = _ring_check(
            model, params, req, torch.bfloat16, FULL_BF16_REL_TOL,
            "bf16 state check")
        check(checks["bf16_decode"][2] <= FULL_BF16_REL_TOL,
              "bf16 decode after prefill at full width")
        # the same weights in float32 (bf16 -> f32 is exact)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = build_model(cfg32)
        params32 = tfm.tree_map(lambda t: t.float(), params)
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        f32 = {mode: _prefill_logits(model32, params32, req.prompt, mode)
               for mode in ("kernels", "plain")}
        err = checks["f32_kernel_vs_plain"] = _rel(f32["kernels"],
                                                   f32["plain"])
        print(f"  f32 prefill logits S={S}, kernels vs plain versions: max "
              f"err {err[0]:.3e} of max |logit| {err[1]:.1f}, relative L2 "
              f"{err[2]:.2e} (tol {FULL_F32_REL_TOL:g}); "
              f"{time.perf_counter() - t0:.1f} s")
        check(err[2] <= FULL_F32_REL_TOL, f"f32 prefill S={S}, kernels vs "
                                          f"plain versions")
        checks["bf16_vs_f32"] = _f32_gate(_distances_to_f32(bf16,
                                                            f32["plain"]), S)
        checks["f32_decode"] = _ring_check(
            model32, params32, req, torch.float32, FULL_F32_REL_TOL,
            "f32 state check")
        check(checks["f32_decode"][2] <= FULL_F32_REL_TOL,
              "f32 decode after prefill at full width")
        del params32
    torch.cuda.empty_cache()
    row["checks"] = checks
    return row, launches


def _mlstm_layers_vs_plain(calls, S, expected=XLSTM_MLSTM_LAYERS):
    """(a) of the full-width xLSTM check, teacher-forced: each mLSTM
    layer's inputs, as the plain bf16 prefill handed them to it, through
    the kernel and through the plain version, held on every layer at the
    kernel phase's limits at hd 1024."""
    import torch

    from repro_torch.kernels.mlstm import ops

    check(len(calls) == expected,
          f"{len(calls)} mLSTM calls recorded, expected {expected}")
    t0 = time.perf_counter()
    layers = []
    for i, call in enumerate(calls):
        q, k, v, li, lf = call["inputs"]
        h, state = ops.mlstm_chunkwise(q, k, v, li, lf, chunk=call["chunk"])
        he, state_e = _plain_mlstm(q, k, v, li, lf, chunk=call["chunk"])
        if h.is_cuda:
            torch.cuda.synchronize()
        row = {"h_scaled": float(((h.float() - he.float()).abs()
                                  / he.float().abs().clamp_min(1)).max()),
               "h_rel_l2": _rel(h, he)[2],
               "state_rel_l2": max(_rel(a, e)[2]
                                   for a, e in zip(state, state_e)),
               "h_unequal": int((h != he).sum())}
        layers.append(row)
        check(row["h_scaled"] <= TOL["bfloat16"]
              and row["h_rel_l2"] <= MLSTM_REL_TOL
              and row["state_rel_l2"] <= MLSTM_REL_TOL,
              f"mLSTM layer {i} at S={S}, kernel vs plain version: {row}")
        del h, state, he, state_e
    worst = {key: max(r[key] for r in layers) for key in layers[0]}
    unequal = sorted(r["h_unequal"] for r in layers)
    print(f"  (a) bf16 mLSTM kernel vs plain version on each of the "
          f"{len(layers)} layers' own inputs (S={S}, teacher-forced): worst "
          f"h err / max(1, |h|) {worst['h_scaled']:.2e} "
          f"({TOL['bfloat16']:g}), h rel L2 {worst['h_rel_l2']:.2e} "
          f"({MLSTM_REL_TOL:g}), state rel L2 {worst['state_rel_l2']:.2e} "
          f"({MLSTM_REL_TOL:g}) ok; {time.perf_counter() - t0:.1f} s")
    print(f"  bf16 h elements unequal to the plain version's (of "
          f"{calls[0]['h'].numel():,} a layer): {unequal.count(0)} of "
          f"{len(layers)} layers equal bit for bit, median "
          f"{statistics.median(unequal):g}, largest {unequal[-1]}, in all "
          f"{sum(unequal)}")
    return {"worst": worst, "h_unequal": [r["h_unequal"] for r in layers]}


def _f32_gate(dist, S):
    """(b) of the full-width xLSTM check: the bf16 kernels route's
    distance from the float32 plain route's logits, e_k, is at most
    max(FULL_BF16_REL_TOL, XLSTM_F32_MARGIN e_p), with e_p the bf16
    plain route's."""
    e_k, e_p = dist["kernels"], dist["plain"]
    limit = max(FULL_BF16_REL_TOL, XLSTM_F32_MARGIN * e_p)
    print(f"  (b) bf16 prefill logits S={S} vs the float32 plain route's "
          f"(same weights): kernels e_k {e_k:.3e}, plain versions e_p "
          f"{e_p:.3e}, e_k / e_p {e_k / e_p:.3f}; plain versions with the "
          f"mLSTM in float64 {dist['plain_f64_mlstm']:.3e}; gate e_k <= "
          f"max({FULL_BF16_REL_TOL:g}, {XLSTM_F32_MARGIN:g} e_p) = "
          f"{limit:.3e} {'ok' if e_k <= limit else 'FAIL'}")
    check(e_k <= limit, f"bf16 kernels route vs float32 at S={S}: e_k "
                        f"{e_k:.3e} > {limit:.3e}")
    return dict(dist, limit=limit)


def _pass_ms(fn, calls=3):
    """Device time per launch of each kernel that ``fn`` launches, by the
    profiler, keyed by the name between ``mlstm_`` and ``_kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, top = _top_device(prof, n=None)
    out = {}
    for us, count, key in top:
        found = re.search(r"mlstm_(\w+?)_kernel", key)
        if found:
            out[found.group(1)] = us / count / 1e3
    if not out:
        print(f"  the profiler recorded {len(top)} device entries, none of "
              f"them an mLSTM pass: {[k[:60] for _, _, k in top[:4]]}")
    return out


def time_mlstm():
    """(e) the mLSTM kernel at the full-width prefill shape: the bf16
    route with its passes, resources and scratch, its plain version and
    its bound, and the float32 route at the same shape."""
    import torch

    from repro_torch.kernels.mlstm import ops

    print("[10] timing the mLSTM kernel (CUDA events after warm-up; passes "
          "by the profiler)")
    B, S, H, hd, L = 1, 4096, 4, 1024, MLSTM_CHUNK
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, li, lf = _mlstm_inputs(g, B, S, H, hd, torch.bfloat16)
    qf, kf, vf = (t.float() for t in (q, k, v))
    with torch.no_grad():
        ms = cuda_ms(lambda: ops.mlstm_chunkwise(q, k, v, li, lf, chunk=L),
                     20)
        plain = cuda_ms(lambda: ops._plain(q, k, v, li, lf, L), 3)
        f32_ms = cuda_ms(lambda: ops.mlstm_chunkwise(qf, kf, vf, li, lf,
                                                     chunk=L), 5)
        passes = _pass_ms(lambda: ops.mlstm_chunkwise(q, k, v, li, lf,
                                                      chunk=L))
        f32_passes = _pass_ms(lambda: ops.mlstm_chunkwise(qf, kf, vf, li, lf,
                                                          chunk=L))
    # what this call's data needs: the causal (q, k) pairs of every chunk,
    # a short last one included, for q k^T and W v; q C and the update of
    # C at 2 hd^2 flops a row each; every input read once, every output
    # written once
    chunks = [min(L, S - s0) for s0 in range(0, S, L)]
    pairs = sum(n * (n + 1) // 2 for n in chunks)
    flops = B * H * (4 * pairs * hd + 4 * S * hd * hd)
    nbytes = (4 * q.nbytes + li.nbytes + lf.nbytes  # q, k, v in; h out
              + B * H * (hd * hd + hd + 1) * 4)  # C, n, m out
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # the float32 route: q, k, v and h at four bytes a value
    f32_bound = f32_bound_ms(flops, nbytes + 4 * q.nbytes)
    attrs = {kind: ops.tensor_core_attributes(kind)
             for kind in ops.TENSOR_CORE_KERNELS}
    scratch = {name: ops.scratch_bytes(B, H, S, hd, L, dt) for name, dt in
               (("bfloat16", torch.bfloat16), ("float32", torch.float32))}
    row = {"shape": f"B={B} H={H} S={S} hd={hd} chunk={L} bfloat16",
           "ms": ms, "plain_ms": plain, "library_ms": None,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes, "pairs_per_head": pairs,
           "tflop_per_s": flops / ms / 1e9, "design": ops.route(q.dtype),
           "passes_ms": passes, "attributes": attrs,
           "scratch_bytes": scratch, "f32_ms": f32_ms,
           "f32_tflop_per_s": flops / f32_ms / 1e9,
           "f32_bound_ms": f32_bound, "f32_passes_ms": f32_passes}
    print(f"  mlstm {row['shape']}: kernel ({row['design']}) {ms:.4f} ms, "
          f"plain {plain:.4f} ms, no library call, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s; {nbytes / 1e6:.1f} MB = "
          f"{t_bytes:.4f} ms); {row['tflop_per_s']:.1f} TFLOP/s")
    print("  mlstm bf16 passes (profiler, per launch): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in passes.items()))
    for kind, a in attrs.items():
        print(f"  mlstm bf16 {kind} kernel: {a['registers']} registers a "
              f"thread, {a['local_bytes']} local bytes, "
              f"{a['static_smem_bytes'] + a['dynamic_smem_bytes']} bytes of "
              f"shared memory a block")
    print(f"  mlstm scratch a call: bf16 route {scratch['bfloat16'] / 1e6:.1f}"
          f" MB, float32 route {scratch['float32'] / 1e6:.1f} MB")
    print(f"  mlstm float32 route ({ops.route(qf.dtype)}) at the same shape: "
          f"{f32_ms:.4f} ms, {row['f32_tflop_per_s']:.1f} TFLOP/s, its own "
          f"bound {f32_bound:.4f} ms (operations at the float32 rate, "
          f"{F32_FLOP_PER_S / 1e12:g} TFLOP/s); passes "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in f32_passes.items()))
    check(all(a["local_bytes"] == 0 for a in attrs.values()),
          f"the tensor-core mLSTM kernels do not spill: {attrs}")
    return row


# ------------------------------------------------------- Perona training
def dropout_free(cfg):
    import dataclasses

    return dataclasses.replace(cfg, feature_dropout=0.0, edge_dropout=0.0,
                               alpha_dropout=0.0)


def train_batches():
    """The §IV-C training and validation batches (``PeronaBatch``): the
    acquisition's chronological split, 1080 and 360 nodes."""
    from repro_torch.core.graph_data import build_graphs, chronological_split
    from repro_torch.core.preprocess import Preprocessor
    from repro_torch.fingerprint.runner import paper_acquisition_frame

    tr, va, _ = chronological_split(paper_acquisition_frame(seed=0))
    pre = Preprocessor().fit(tr)
    return build_graphs(tr, pre), build_graphs(va, pre)


def golden_model(golden, device, dropout=False):
    """The paper's model holding the golden file's initial parameters,
    at dropout 0 unless ``dropout``."""
    from repro_torch.core.model import PeronaModel

    model = PeronaModel(golden.config if dropout
                        else dropout_free(golden.config))
    model.load_state_dict(golden.init)
    return model.to(device)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def fixed_point_errors(golden, tb, device):
    """The port's loss terms, gradients and one AdamW step at the
    golden's initial parameters and dropout 0, against the JAX values:
    the largest absolute loss error, the largest relative L2 gradient
    error and the largest absolute step error over the leaves other than
    ZERO_GRAD_LEAVES, and for those the largest gradient norm over the
    global norm."""
    import torch

    from repro_torch.core.trainer import batch_to_torch
    from repro_torch.optim.adamw import AdamW

    model = golden_model(golden, device)
    params = dict(model.named_parameters())
    total, terms = model.loss(batch_to_torch(tb, device))
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    m = golden.meta
    opt = AdamW(lr=m["lr"], b2=m["b2"], weight_decay=m["weight_decay"],
                clip_norm=m["clip_norm"])
    with torch.no_grad():
        step1, _, om = opt.update(grads, opt.init(params),
                                  {k: p.detach() for k, p in params.items()})
    losses = {k: float(v.detach()) for k, v in {"total": total,
                                                **terms}.items()}
    live = [k for k in params if k not in ZERO_GRAD_LEAVES]
    gnorm = float(om["grad_norm"])
    return {
        "loss": max(abs(losses[k] - golden.loss[k]) for k in losses),
        "grad": max(_rel_l2(grads[k].cpu(), golden.grad[k]) for k in live),
        "zero_grad": max(float(grads[k].norm()) for k in ZERO_GRAD_LEAVES)
        / gnorm,
        "step": max(float((step1[k].cpu() - golden.step1[k]).abs().max())
                    for k in live),
        "grad_norm": (gnorm, golden.meta["grad_norm"]),
        "losses": losses,
    }


def check_fixed_point(errs, label):
    check(errs["loss"] <= TRAIN_LOSS_ATOL, f"{label} loss terms")
    check(errs["grad"] <= TRAIN_GRAD_RTOL, f"{label} gradients")
    check(errs["zero_grad"] <= TRAIN_ZERO_GRAD_RTOL,
          f"{label} key-bias gradients are rounding noise")
    check(errs["step"] <= TRAIN_STEP_ATOL, f"{label} one AdamW step")


def run_of(res):
    """A ``TrainResult`` in the golden file's run layout."""
    h = res.history
    best = h[res.best_epoch]
    return {"train_loss": [e["train_loss"] for e in h],
            "val_loss": [e["val_loss"] for e in h],
            "val_f1": [e["val_f1_outlier"] for e in h],
            "best_epoch": res.best_epoch,
            "best_key": (best["val_f1_outlier"], -best["val_loss"]),
            "params": {k: v.cpu() for k, v in res.params.items()}}


def loss_rtol(epoch):
    """The relative limit on epoch ``epoch``'s losses."""
    return TRAIN_LOSS_RTOL[min(epoch // TRAIN_EPOCH_BLOCK,
                               len(TRAIN_LOSS_RTOL) - 1)]


def run_errors(run, ref):
    """One run against the reference run (both in the golden layout):
    the losses' largest relative error over the first epochs, in each
    block of epochs, and over the whole run as a share of its limit; the
    largest F1 difference; the best epochs and their (f1, -val loss) keys
    (F1 absolute, loss relative); and, when the best epochs agree, the
    selected parameters' relative L2 error over all leaves but
    ZERO_GRAD_LEAVES (``params_rel``) and the largest of any one such
    leaf (``leaf_rel``)."""
    import numpy as np

    n = len(ref["train_loss"])
    out = {"epochs": (len(run["train_loss"]), n)}
    if out["epochs"][0] != n:
        return out
    rel = np.maximum(*(np.abs(np.asarray(run[k]) - np.asarray(ref[k]))
                       / np.abs(np.asarray(ref[k]))
                       for k in ("train_loss", "val_loss")))
    out["first_rel"] = float(rel[:TRAIN_FIRST_EPOCHS].max())
    out["block_rel"] = [float(rel[i:i + TRAIN_EPOCH_BLOCK].max())
                        for i in range(0, n, TRAIN_EPOCH_BLOCK)]
    out["loss_share"] = float(max(r / loss_rtol(e)
                                  for e, r in enumerate(rel)))
    out["f1_abs"] = float(np.abs(np.asarray(run["val_f1"])
                                 - np.asarray(ref["val_f1"])).max())
    out["best_epoch"] = (run["best_epoch"], ref["best_epoch"])
    (f1, nl), (f1_ref, nl_ref) = run["best_key"], ref["best_key"]
    out["key_diff"] = (abs(f1 - f1_ref), abs(nl - nl_ref) / abs(nl_ref))
    if run["best_epoch"] == ref["best_epoch"]:
        live = [k for k in ref["params"] if k not in ZERO_GRAD_LEAVES]
        diff = [(run["params"][k].float() - ref["params"][k].float())
                for k in live]
        num = sum(float(d.square().sum()) for d in diff)
        den = sum(float(ref["params"][k].float().square().sum())
                  for k in live)
        out["params_rel"] = (num / den) ** 0.5
        out["leaf_rel"] = max(_rel_l2(run["params"][k], ref["params"][k])
                              for k in live)
    return out


def check_run(errs, label, f1_atol=TRAIN_F1_ATOL):
    check(errs["epochs"][0] == errs["epochs"][1], f"{label} epochs run")
    check(errs["loss_share"] <= 1.0, f"{label} losses")
    check(errs["f1_abs"] <= f1_atol, f"{label} validation F1")
    # a best epoch may move through a near tie: then the two candidates'
    # (f1, -val loss) keys are compared, not the epochs
    check(errs["key_diff"][0] <= f1_atol, f"{label} best key's F1")
    check(errs["key_diff"][1] <= loss_rtol(errs["best_epoch"][1]),
          f"{label} best key's loss")
    if "params_rel" in errs:
        check(errs["params_rel"] <= TRAIN_PARAMS_RTOL,
              f"{label} selected parameters")


def _bwd_inputs(g, N, H, hd, P, dtype, with_g_att):
    """Forward inputs with a block of fully masked rows, the forward
    kernel's att, and cotangents: (q, k, v, att, g_out, g_att), the
    masked rows and the mask."""
    import torch

    from repro_torch.kernels.edge_softmax import ops

    q, k, v, mask = _inputs(g, N, H, hd, P, dtype)
    blank = slice(N // 3, N // 3 + min(N // 4, 64))
    mask[blank] = False
    with torch.no_grad():
        _, att = ops.edge_softmax_aggregate(q, k, v, mask)
    g_out = torch.randn(N, H, hd, generator=g, device="cuda").to(dtype)
    g_att = (torch.randn(N, H, P, generator=g, device="cuda")
             if with_g_att else None)
    return (q, k, v, att, g_out, g_att), blank, mask


def phase_train_kernel():
    """[14a] the backward kernel against its plain version."""
    import torch

    from repro_torch.kernels.edge_softmax import ops, ref

    print("[14] Perona training")
    print("  a. edge_softmax backward: kernel vs plain version on the card "
          "(error: max |k - p| / (1 + |p|))")
    g = torch.Generator(device="cuda").manual_seed(14)
    worst, main_err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        for N, P, (H, hd), with_g_att in itertools.product(
                BWD_N, BWD_P, BWD_HEADS, (False, True)):
            args, blank, _ = _bwd_inputs(g, N, H, hd, P, dtype,
                                         with_g_att)
            scale = 1.0 / hd ** 0.5
            got = ops._launch_bwd(*args, scale)
            want = ref.edge_softmax_backward(*args, scale)
            torch.cuda.synchronize()
            err = max(float(((a.float() - b.float()).abs()
                             / (1 + b.float().abs())).max())
                      for a, b in zip(got, want))
            abs_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
            zero = blank.stop == blank.start or all(
                float(t[blank].abs().max()) == 0.0 for t in got)
            label = (f"N={N} P={P} H={H} hd={hd} g_att="
                     f"{'yes' if with_g_att else 'no'} {name}")
            check(all(a.dtype == b.dtype and a.shape == b.shape
                      for a, b in zip(got, want)), f"{label} outputs")
            check(err <= tol, f"backward kernel vs plain, {label}: {err}")
            check(zero, f"backward of fully masked rows is 0, {label}")
            worst[name] = max(worst.get(name, 0.0), err)
            if (N, H, hd, P) == BWD_MAIN and dtype == torch.float32:
                main_err = max(main_err, abs_err)
        print(f"  {name}: {len(BWD_N) * len(BWD_P) * len(BWD_HEADS) * 2} "
              f"cases (N {BWD_N}, P {BWD_P}, (H, hd) {BWD_HEADS}, g_att "
              f"absent and present), worst {worst[name]:.3e} (tol {tol:g}); "
              f"fully masked rows 0")
    before = ops.BWD_LAUNCHES
    empty = (torch.empty(0, 4, 8, device="cuda"),
             torch.empty(0, 3, 4, 8, device="cuda"),
             torch.empty(0, 3, 4, 8, device="cuda"),
             torch.empty(0, 4, 3, device="cuda"),
             torch.empty(0, 4, 8, device="cuda"), None)
    dq, dk, dv = ops._launch_bwd(*empty, 0.25)
    check(ops.BWD_LAUNCHES == before and dk.shape == (0, 3, 4, 8),
          "N = 0 makes no launch")
    N, H, hd, P = BWD_MAIN
    args, _, _ = _bwd_inputs(g, N, H, hd, P, torch.float32, False)
    first = ops._launch_bwd(*args, 1.0 / hd ** 0.5)
    same = all(all(torch.equal(a, b) for a, b in zip(
        first, ops._launch_bwd(*args, 1.0 / hd ** 0.5)))
        for _ in range(BWD_REPEATS - 1))
    print(f"  N=0: no launch; {BWD_REPEATS} launches at N={N} H={H} hd={hd} "
          f"P={P} float32 equal bit for bit: {same}")
    check(same, "backward kernel is bit-identical from launch to launch")
    return {"worst": worst, "main": main_err}


def phase_train_fixed_point(golden, tb):
    """[14b] loss terms, gradients and one AdamW step at the golden's
    initial parameters, dropout 0."""
    from repro_torch.kernels.edge_softmax import ops

    before = ops.BWD_LAUNCHES
    errs = fixed_point_errors(golden, tb, "cuda")
    print(f"  b. §IV-C batch ({len(tb)} nodes, F'={tb.x.shape[1]}, "
          f"A={tb.edge.shape[-1]}), golden initial parameters, dropout 0: "
          f"loss terms max err {errs['loss']:.3e} (atol "
          f"{TRAIN_LOSS_ATOL:g}); gradients max rel L2 {errs['grad']:.3e} "
          f"(tol {TRAIN_GRAD_RTOL:g}); key-bias gradients "
          f"{errs['zero_grad']:.2e} of the global norm (tol "
          f"{TRAIN_ZERO_GRAD_RTOL:g}); one AdamW step max err "
          f"{errs['step']:.3e} (atol {TRAIN_STEP_ATOL:g}); grad norm "
          f"{errs['grad_norm'][0]:.6f} vs {errs['grad_norm'][1]:.6f}; "
          f"{ops.BWD_LAUNCHES - before} backward launch")
    check(ops.BWD_LAUNCHES - before == 1, "the gradient launched the kernel")
    check_fixed_point(errs, "card vs JAX at fixed parameters")
    return errs


def phase_train_runs(golden, tb, vb):
    """[14c] the reference trainer at dropout 0 against the golden
    history; [14d] the default-dropout recipe. Returns the rows and the
    seconds of each run."""
    import numpy as np
    import torch

    from repro_torch.core.trainer import evaluate, train_perona_reference
    from repro_torch.kernels.edge_softmax import ops

    m = golden.meta
    kw = dict(epochs=m["epochs"], patience=m["patience"], lr=m["lr"],
              weight_decay=m["weight_decay"], seed=m["seed"])
    out = {}
    def launches():
        return ops.LAUNCHES, ops.BWD_LAUNCHES

    def per_epoch(before, epochs):
        fwd, bwd = (b - a for a, b in zip(before, launches()))
        # a step's forward, the validation loss's and the validation
        # scores'; the step's backward
        check((fwd, bwd) == (3 * epochs, epochs),
              f"launches per epoch: {fwd} and {bwd} in {epochs} epochs")
        return {"forward": fwd / epochs, "backward": bwd / epochs}

    model = golden_model(golden, "cuda")
    torch.cuda.synchronize()
    before = launches()
    t0 = time.perf_counter()
    res = train_perona_reference(model, tb, vb, device="cuda", **kw)
    torch.cuda.synchronize()
    out["dropout0_s"] = time.perf_counter() - t0
    out["launches_per_epoch"] = per_epoch(before, len(res.history))
    errs = run_errors(run_of(res), golden.ref)
    scan = run_errors(golden.scan, golden.ref)
    out["dropout0"] = {"port_vs_ref": errs, "jax_scan_vs_ref": scan}
    out["dropout0_run"] = run_of(res)  # for [15b]; not in the report
    print(f"  c. train_perona_reference at dropout 0, {m['epochs']} epochs "
          f"on the card in {out['dropout0_s']:.2f} s, vs the JAX reference "
          f"trainer (golden): epochs {errs['epochs']}; losses' max rel "
          f"error, first {TRAIN_FIRST_EPOCHS} epochs {errs['first_rel']:.2e}"
          f", by {TRAIN_EPOCH_BLOCK} epochs "
          + " ".join(f"{x:.1e}" for x in errs["block_rel"])
          + f" (limits {' '.join(f'{x:g}' for x in TRAIN_LOSS_RTOL)}); val "
          f"F1 {errs['f1_abs']:.3e} (atol {TRAIN_F1_ATOL:g}); best epoch "
          f"{errs['best_epoch']}"
          + ("" if errs["best_epoch"][0] == errs["best_epoch"][1] else
             " (they differ: a near tie, so the two candidates' keys are "
             "compared and the parameters are not)")
          + f", its key's F1 and loss "
          f"{errs['key_diff'][0]:.2e} / {errs['key_diff'][1]:.2e}; selected "
          f"parameters rel L2 {errs.get('params_rel', float('nan')):.2e} "
          f"(tol {TRAIN_PARAMS_RTOL:g}; largest leaf "
          f"{errs.get('leaf_rel', float('nan')):.2e}). JAX's own scanned "
          f"trainer vs its reference: losses by {TRAIN_EPOCH_BLOCK} epochs "
          + " ".join(f"{x:.1e}" for x in scan["block_rel"])
          + f", F1 {scan['f1_abs']:.3e}, parameters "
          f"{scan.get('params_rel', float('nan')):.2e}")
    check_run(errs, "card vs JAX reference trainer")

    model = golden_model(golden, "cuda", dropout=True)
    torch.cuda.synchronize()
    before = launches()
    t0 = time.perf_counter()
    res = train_perona_reference(model, tb, vb, device="cuda", epochs=80,
                                 seed=0)
    torch.cuda.synchronize()
    out["dropout_s"] = time.perf_counter() - t0
    per_epoch(before, len(res.history))
    tl = np.asarray([e["train_loss"] for e in res.history])
    ev = evaluate(model, res.params, vb)
    row = {"epochs": len(tl), "best_epoch": res.best_epoch,
           "train_loss_first": float(tl[0]), "train_loss_last": float(tl[-1]),
           **{k: ev[k] for k in ("f1_outlier", "type_accuracy", "mse")},
           "golden": golden.eval}
    out["dropout"] = row
    out["dropout_run"] = run_of(res)  # for [15c]; not in the report
    print(f"  d. default dropouts, {len(tl)} epochs in "
          f"{out['dropout_s']:.2f} s ({out['dropout_s'] / len(tl) * 1e3:.2f}"
          f" ms an epoch): train loss {tl[0]:.4f} -> "
          f"{tl[-1]:.4f}, best epoch {res.best_epoch}; validation F1 "
          f"(outlier) {ev['f1_outlier']:.4f}, type accuracy "
          f"{ev['type_accuracy']:.4f} (JAX-trained golden: "
          f"{golden.eval['f1_outlier']:.4f}, "
          f"{golden.eval['type_accuracy']:.4f}; measured, not gated: the "
          f"masks differ); launches an epoch: "
          f"{out['launches_per_epoch']['forward']:g} forward, "
          f"{out['launches_per_epoch']['backward']:g} backward")
    check(np.isfinite(tl).all(), "finite training losses")
    check(tl[-10:].mean() < tl[:10].mean(), "training losses fall")
    return out


def time_backward(N):
    """The backward kernel at the model's head shape (H=4 hd=8 P=3,
    float32, no g_att), with its bound, plain version and the backward
    of the forward's library problem (SDPA)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.edge_softmax import ops, ref

    H, hd, P = 4, 8, 3
    g = torch.Generator(device="cuda").manual_seed(3)
    args, _, mask = _bwd_inputs(g, N, H, hd, P, torch.float32, False)
    q, k, v, att, g_out, _ = args
    scale = 1.0 / hd ** 0.5
    iters = 200 if N <= 4096 else 50
    ms = cuda_ms(lambda: ops._launch_bwd(*args, scale), iters)
    in_graph = graph_ms(lambda: ops._launch_bwd(*args, scale))
    plain = cuda_ms(lambda: ref.edge_softmax_backward(*args, scale), iters)
    # SDPA over N*H queries of length 1 against P keys, as the forward's
    # yardstick, and its backward alone (the graph kept for repeats)
    q4, k4, v4 = (t.detach().clone().requires_grad_() for t in (
        q.unsqueeze(2), k.permute(0, 2, 1, 3).contiguous(),
        v.permute(0, 2, 1, 3).contiguous()))
    out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                          attn_mask=mask[:, None, None, :])
    g4 = g_out.unsqueeze(2)
    library = cuda_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), g4, retain_graph=True), iters)
    nbytes = sum(t.nbytes for t in (q, k, v, att, g_out)) \
        + q.nbytes + k.nbytes + v.nbytes  # reads once, dq/dk/dv once
    flops = N * H * P * (7 * hd + 5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    row = {"N": N, "ms": ms, "graph_ms": in_graph, "plain_ms": plain,
           "library_ms": library, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
    print(f"  N={N:6d} H=4 hd=8 P=3 float32: backward kernel {ms:.4f} ms, "
          f"in a CUDA graph {in_graph:.4f} ms, plain {plain:.4f} ms, SDPA "
          f"backward {library:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e6:.1f} MFLOP)")
    return row


def profile_training(golden, tb, vb, epochs=10):
    """One epoch's wall time and the device's busy and idle share over
    ``epochs`` epochs of the reference trainer at default dropouts, the
    profiler recording device activity only (recording every host op
    doubles an epoch's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.trainer import train_perona_reference

    model = golden_model(golden, "cuda", dropout=True)
    train_perona_reference(model, tb, vb, device="cuda", epochs=2)  # warm
    model = golden_model(golden, "cuda", dropout=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_perona_reference(model, tb, vb, device="cuda", epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, top = _top_device(prof, n=None)
    port = _port_device(prof)
    kernels = sum(c for _, c, _ in top)
    top = top[:10]
    row = {"epochs": epochs, "wall_s": wall, "epoch_s": wall / epochs,
           "device_entries_per_epoch": kernels / epochs,
           "device_s": device_us / 1e6,
           "device_idle_share": 1.0 - device_us / 1e6 / wall,
           "top": [{"name": k[:90], "us": us, "count": c}
                   for us, c, k in top],
           "port_kernels": {k: {"us": us, "count": c}
                            for k, (us, c) in port.items()}}
    print(f"  profiled {epochs} epochs (default dropouts): {wall * 1e3:.1f} "
          f"ms wall, {wall / epochs * 1e3:.2f} ms an epoch, "
          f"{device_us / 1e3:.2f} ms of device activity in "
          f"{kernels / epochs:.0f} kernels and copies an epoch, busy share "
          f"{1 - row['device_idle_share']:.4f}, idle share "
          f"{row['device_idle_share']:.4f}; edge_softmax kernels "
          + ", ".join(f"{k} {us / 1e3:.3f} ms x{c}"
                      for k, (us, c) in port.items())
          + "; top device entries:")
    for us, c, k in top:
        print(f"    {us:10.1f} us x{c:4d}  {k[:90]}")
    return row


def phase_train_timing(golden, tb, vb):
    """[14e] the backward kernel's times and the training epoch's."""
    print("  e. timing (CUDA events after warm-up; the epoch on the host "
          "clock ending in synchronize)")
    bwd = {str(N): time_backward(N) for N in (262144, 1080)}
    return bwd, profile_training(golden, tb, vb)


# ------------------------------------- Perona's device-resident trainer
def phase_graph_kernels():
    """[15a] the forward and backward kernels against their plain
    versions at the HPO's head shapes."""
    import torch

    from repro_torch.kernels.edge_softmax import ops, ref

    print("[15] Perona's device-resident trainer (a CUDA graph of the "
          "epoch), the HPO and train-then-rank")
    print("  a. edge_softmax forward and backward at the HPO's (H, hd), "
          "P=3, kernel vs plain version (forward: max abs error; backward: "
          "max |k - p| / (1 + |p|))")
    g = torch.Generator(device="cuda").manual_seed(15)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        for (H, hd), N in itertools.product(HPO_HEADS, HPO_N):
            args, blank, mask = _bwd_inputs(g, N, H, hd, 3, dtype, False)
            q, k, v = args[:3]
            scale = 1.0 / hd ** 0.5
            with torch.no_grad():
                out, att = ops._launch(q, k, v, mask, scale)
                oe, ae = ref.edge_softmax_aggregate(q, k, v, mask, scale)
            got = ops._launch_bwd(*args, scale)
            want = ref.edge_softmax_backward(*args, scale)
            torch.cuda.synchronize()
            fwd = max(float((out.float() - oe.float()).abs().max()),
                      float((att - ae).abs().max()))
            bwd = max(float(((a.float() - b.float()).abs()
                             / (1 + b.float().abs())).max())
                      for a, b in zip(got, want))
            zero = all(float(t[blank].float().abs().max()) == 0.0
                       for t in (out, att, *got))
            label = f"N={N} H={H} hd={hd} P=3 {name}"
            check(fwd <= tol, f"forward kernel vs plain, {label}: {fwd}")
            check(bwd <= tol, f"backward kernel vs plain, {label}: {bwd}")
            check(zero, f"fully masked rows give 0, {label}")
            key = f"H={H} hd={hd} {name}"
            w = worst.get(key, (0.0, 0.0))
            worst[key] = (max(w[0], fwd), max(w[1], bwd))
        print(f"  {name} (tol {tol:g}), worst over N {HPO_N}: " + "; ".join(
            f"{k.rsplit(' ', 1)[0]} forward {f:.3e} backward {b:.3e}"
            for k, (f, b) in worst.items() if k.endswith(name)))
    return worst


def _same_run(a, b):
    """Two runs (the golden layout) equal bit for bit."""
    import torch

    return (a["train_loss"] == b["train_loss"]
            and a["val_loss"] == b["val_loss"]
            and a["val_f1"] == b["val_f1"]
            and a["best_epoch"] == b["best_epoch"]
            and all(torch.equal(a["params"][k], b["params"][k])
                    for k in b["params"]))


def phase_graph_train(golden, tb, vb, host_run):
    """[15b] ``train_perona`` at dropout 0 over the golden's epochs
    against the JAX scanned trainer's history, twice (the second run
    replays the cached graph)."""
    import torch

    from repro_torch.core.trainer import train_perona

    m = golden.meta
    kw = dict(epochs=m["epochs"], patience=m["patience"], lr=m["lr"],
              weight_decay=m["weight_decay"], seed=m["seed"])
    runs, seconds, stats = [], [], []
    for _ in range(2):
        model = golden_model(golden, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_perona(model, tb, vb, device="cuda", **kw)
        seconds.append(time.perf_counter() - t0)
        runs.append(run_of(res))
        stats.append(res.stats)
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the sync debug mode is restored after the replays")
    check([s["captured"] for s in stats] == [1, 0],
          f"one capture, then the cached graph: {stats}")
    errs = run_errors(runs[0], golden.scan)
    repeat = _same_run(runs[1], runs[0])
    host = _same_run(runs[0], host_run)
    host_errs = run_errors(runs[0], host_run)
    out = {"errors_vs_jax_scan": errs, "seconds": seconds,
           "repeat_bit_identical": repeat,
           "host_loop_bit_identical": host, "vs_host_loop": host_errs}
    print(f"  b. train_perona at dropout 0, {m['epochs']} epochs, replays "
          f"under set_sync_debug_mode('error'): {seconds[0]:.2f} s with the "
          f"capture, {seconds[1]:.2f} s on the cached graph; vs the JAX "
          f"scanned trainer (golden scan/*): epochs {errs['epochs']}; "
          f"losses' max rel error by {TRAIN_EPOCH_BLOCK} epochs "
          + " ".join(f"{x:.1e}" for x in errs["block_rel"])
          + f" ({errs['loss_share']:.2f} of the limits); val F1 "
          f"{errs['f1_abs']:.3e} (atol {TRAIN_SCAN_F1_ATOL:g}); best epoch "
          f"{errs['best_epoch']}"
          + ("" if errs["best_epoch"][0] == errs["best_epoch"][1] else
             " (they differ: a near tie, so the keys are compared)")
          + f", key {errs['key_diff'][0]:.2e} / {errs['key_diff'][1]:.2e}; "
          f"selected parameters rel L2 "
          f"{errs.get('params_rel', float('nan')):.2e} (tol "
          f"{TRAIN_PARAMS_RTOL:g}); second run bit for bit: {repeat}; equal "
          f"to the host loop train_perona_reference bit for bit: {host} "
          f"(losses by {TRAIN_EPOCH_BLOCK} epochs "
          + " ".join(f"{x:.1e}" for x in host_errs.get("block_rel", []))
          + ")")
    check_run(errs, "graphed train_perona vs JAX scanned trainer",
              f1_atol=TRAIN_SCAN_F1_ATOL)
    return out


def graph_nodes(graph) -> int:
    """The node count of a CUDA graph captured with ``keep_graph``, from
    ``cuGraphGetNodes`` of ``libcuda``."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    check(rc == 0, f"cuGraphGetNodes returned {rc}")
    return n.value


def profile_graph(golden, tb, vb, epochs=20):
    """The default-dropout epoch as its own program: the graph's nodes,
    ``epochs`` replays timed with CUDA events, and the profiler's view of
    them (device activity only): busy and idle share over the host's
    clock, the edge-softmax kernels per replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import trainer as T
    from repro_torch.kernels.edge_softmax import ops

    cfg = golden.config
    dev = torch.device("cuda")
    prog = T.EpochProgram(T.canonical_config(cfg), epochs, 25, True, dev)
    params0 = {k: v.to(dev) for k, v in golden.init.items()}
    tbt, vbt = T.batch_to_torch(tb, dev), T.batch_to_torch(vb, dev)
    hypers = {k: float(v) for k, v in
              T.model_hypers(cfg, 3e-3, 1e-4, "cpu").items()}
    before = ops.LAUNCHES, ops.BWD_LAUNCHES
    t0 = time.perf_counter()
    prog.run(params0, tbt, vbt, hypers, 0)  # warm-up, capture, a run
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    eager_epochs = T.WARMUP_EPOCHS + 1  # the warm-up and the capture
    captured = [(b - a) / eager_epochs for a, b in zip(
        before, (ops.LAUNCHES, ops.BWD_LAUNCHES))]
    nodes = graph_nodes(prog.graph)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    prog.run(params0, tbt, vbt, hypers, 0)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / epochs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.run(params0, tbt, vbt, hypers, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, top = _top_device(prof, n=None)
    port = _port_device(prof)
    entries = sum(c for _, c, _ in top)
    per_replay = {k: c / epochs for k, (_, c) in port.items()}
    row = {"epochs": epochs, "graph_nodes": nodes,
           "first_run_s": first, "replay_ms": event_ms,
           "wall_s": wall, "epoch_ms": wall / epochs * 1e3,
           "device_s": device_us / 1e6,
           "device_idle_share": 1.0 - device_us / 1e6 / wall,
           "device_entries_per_replay": entries / epochs,
           "launches_captured_per_epoch": {"forward": captured[0],
                                           "backward": captured[1]},
           "launches_per_replay": per_replay,
           "top": [{"name": k[:90], "us": us, "count": c}
                   for us, c, k in top[:10]]}
    resolved = device_us > 0
    print(f"  profiled the default-dropout epoch as a graph of {nodes} "
          f"nodes: {epochs} replays {event_ms:.3f} ms an epoch (CUDA "
          f"events), {wall * 1e3:.1f} ms wall under the profiler "
          f"({row['epoch_ms']:.3f} ms an epoch); "
          + (f"{device_us / 1e3:.2f} ms of device activity in "
             f"{entries / epochs:.0f} kernels and copies a replay, busy "
             f"share {1 - row['device_idle_share']:.4f}, idle share "
             f"{row['device_idle_share']:.4f}; edge_softmax kernels a "
             f"replay: " + ", ".join(f"{k} {v:g}"
                                     for k, v in per_replay.items())
             if resolved else
             "the profiler resolved no kernel inside the graph's launches")
          + f"; captured an epoch: {captured[0]:g} forward, "
          f"{captured[1]:g} backward launches")
    check(captured == [3.0, 1.0],
          f"an epoch launches 3 forward and 1 backward kernels: {captured}")
    if resolved:
        check(per_replay == {"edge_softmax_fwd": 3.0,
                             "edge_softmax_bwd": 1.0},
              f"each replay runs the edge-softmax kernels: {per_replay}")
        for us, c, k in top[:10]:
            print(f"    {us:10.1f} us x{c:5d}  {k[:90]}")
    return row


def phase_graph_dropout(golden, tb, vb, host_seconds, host_run):
    """[15c] the default-dropout recipe over 80 epochs: finite falling
    losses, two runs of one seed identical and two seeds apart, the
    first epochs equal to the host loop's ([14d], the same seed), F1 and
    type accuracy beside the golden's, the epoch's time. The host loop
    draws new training masks every epoch from a generator seeded
    ``seed + 1``; a graph whose replays reused one epoch's masks would
    part from it at the second epoch."""
    import numpy as np
    import torch

    from repro_torch.core.trainer import evaluate, train_perona

    res, seconds = {}, {}
    for key, seed in (("a", 0), ("b", 0), ("c", 1)):
        model = golden_model(golden, "cuda", dropout=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[key] = (train_perona(model, tb, vb, device="cuda", epochs=80,
                                 seed=seed), model)
        seconds[key] = time.perf_counter() - t0
    runs = {k: run_of(r) for k, (r, _) in res.items()}
    same = _same_run(runs["b"], runs["a"])
    apart = runs["c"]["train_loss"] != runs["a"]["train_loss"]

    def host_rel(run):
        """Max relative difference of the first epochs' training and
        validation losses from the host loop's."""
        n = DROPOUT_HOST_EPOCHS
        got = np.asarray([run[k][:n] for k in ("train_loss", "val_loss")])
        want = np.asarray([host_run[k][:n]
                           for k in ("train_loss", "val_loss")])
        return float(np.abs(got / want - 1.0).max())

    host = host_rel(runs["a"])
    other_seed = host_rel(runs["c"])
    first, model = res["a"]
    tl = np.asarray(runs["a"]["train_loss"])
    ev = evaluate(model, first.params, vb)
    epoch_ms = seconds["b"] / 80 * 1e3
    row = {"epochs": len(tl), "best_epoch": first.best_epoch,
           "train_loss_first": float(tl[0]), "train_loss_last": float(tl[-1]),
           **{k: ev[k] for k in ("f1_outlier", "type_accuracy", "mse")},
           "golden": golden.eval, "seconds": seconds,
           "same_seed_identical": same, "seeds_differ": apart,
           "host_loop_rel": host, "seed1_host_loop_rel": other_seed,
           "epoch_ms": epoch_ms, "host_loop_epoch_ms": host_seconds / 80 * 1e3}
    print(f"  c. default dropouts, 80 epochs: {seconds['a']:.2f} s with the "
          f"capture, {seconds['b']:.2f} s on the cached graph "
          f"({epoch_ms:.3f} ms an epoch, readback included; the host loop "
          f"{row['host_loop_epoch_ms']:.2f} ms in [14d] of this run); train "
          f"loss {tl[0]:.4f} -> {tl[-1]:.4f}, best epoch {first.best_epoch}; "
          f"validation F1 (outlier) {ev['f1_outlier']:.4f}, type accuracy "
          f"{ev['type_accuracy']:.4f} (JAX-trained golden: "
          f"{golden.eval['f1_outlier']:.4f}, "
          f"{golden.eval['type_accuracy']:.4f}; measured, not gated); seed "
          f"0 twice bit for bit: {same}; seeds 0 and 1 differ: {apart}; "
          f"first {DROPOUT_HOST_EPOCHS} epochs' losses vs the host loop's "
          f"([14d], seed 0) max rel {host:.2e} (rtol "
          f"{DROPOUT_HOST_RTOL:g}; seed 1 vs it: {other_seed:.2e})")
    check(np.isfinite(tl).all(), "finite training losses")
    check(tl[-10:].mean() < tl[:10].mean(), "training losses fall")
    check(same, "two runs of one seed are identical")
    check(apart, "two seeds draw different masks")
    check(host <= DROPOUT_HOST_RTOL,
          "every replay draws the host loop's next training masks")
    row["profile"] = profile_graph(golden, tb, vb)
    return row


def phase_graph_hpo(golden, tb, vb):
    """[15d] the dropout-0 search against the host-loop search, then the
    default search at the reference's size."""
    import numpy as np

    from repro_torch.core.trainer import train_perona_reference
    from repro_torch.tuning import hpo

    base = dropout_free(golden.config)
    n, epochs = HPO_CHECK_TRIALS, HPO_CHECK_EPOCHS
    space = hpo.SPACE
    hpo.SPACE = {**space, "feature_dropout": (0.0, 0.0),
                 "edge_dropout": (0.0, 0.0)}
    try:
        t0 = time.perf_counter()
        best, trials, stats = hpo.search(base, tb, vb, n_trials=n,
                                         epochs=epochs, return_stats=True)
        graphed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        best_r, trials_r = hpo.search_sequential(
            base, tb, vb, n_trials=n, epochs=epochs,
            train_fn=train_perona_reference)
        host_s = time.perf_counter() - t0
    finally:
        hpo.SPACE = space
    check([t.params for t in trials] == [t.params for t in trials_r],
          "the two searches run the same trials")
    f1_err = max(abs(a.val_f1 - b.val_f1) for a, b in zip(trials, trials_r))
    loss_err = max(abs(a.val_loss - b.val_loss) / abs(b.val_loss)
                   for a, b in zip(trials, trials_r))
    out = {"check": {"trials": n, "epochs": epochs, "seconds": graphed_s,
                     "host_loop_seconds": host_s, "f1_abs": f1_err,
                     "val_loss_rel": loss_err,
                     "buckets": stats.n_buckets,
                     "captures": stats.trace_count,
                     "same_best": best.params == best_r.params}}
    if best.params == best_r.params:
        errs = run_errors(run_of(best.result), run_of(best_r.result))
        out["check"]["best_run"] = errs
    print(f"  d. HPO, dropout-0 space, {n} trials x {epochs} epochs: search "
          f"{graphed_s:.2f} s ({stats.n_buckets} buckets, "
          f"{stats.trace_count} captures) vs search_sequential with the host "
          f"loop {host_s:.2f} s; trials' selected F1 max abs difference "
          f"{f1_err:.3e} (atol {TRAIN_F1_ATOL:g}), validation loss max rel "
          f"{loss_err:.2e} (tol {loss_rtol(epochs - 1):g}); same best trial: "
          f"{out['check']['same_best']}"
          + (f", its losses by {TRAIN_EPOCH_BLOCK} epochs "
             + " ".join(f"{x:.1e}" for x in errs.get("block_rel", []))
             if out["check"]["same_best"] else ""))
    check(f1_err <= TRAIN_F1_ATOL, "HPO trials' F1, graphed vs host loop")
    check(loss_err <= loss_rtol(epochs - 1),
          "HPO trials' validation loss, graphed vs host loop")
    check(stats.trace_count == stats.n_buckets, "one capture a bucket")
    if out["check"]["same_best"]:
        check_run(errs, "the best trial, graphed vs host loop")

    t0 = time.perf_counter()
    best, trials, stats = hpo.search(golden.config, tb, vb,
                                     n_trials=HPO_TRIALS, epochs=HPO_EPOCHS,
                                     return_stats=True)
    wall = time.perf_counter() - t0
    f1s = np.asarray([t.val_f1 for t in trials])
    out["default"] = {"trials": HPO_TRIALS, "epochs": HPO_EPOCHS,
                      "seconds": wall, "buckets": stats.n_buckets,
                      "bucket_sizes": {str(k): v for k, v in
                                       stats.bucket_sizes.items()},
                      "captures": stats.trace_count,
                      "device_calls": stats.device_calls,
                      "best_f1": best.val_f1, "best_val_loss": best.val_loss,
                      "best_hypers": best.params,
                      "median_f1": float(np.median(f1s))}
    print(f"  d. HPO, the default space at the reference's size, "
          f"{HPO_TRIALS} trials x {HPO_EPOCHS} epochs on the §IV-C batch: "
          f"{wall:.2f} s ({wall / HPO_TRIALS * 1e3:.1f} ms a trial), "
          f"{stats.n_buckets} buckets, {stats.trace_count} captures, "
          f"{stats.device_calls} trial runs; best trial F1 {best.val_f1:.4f}"
          f" (validation loss {best.val_loss:.4f}, heads "
          f"{best.params['heads']}, root weight "
          f"{best.params['use_root_weight']}), median F1 "
          f"{out['default']['median_f1']:.4f}")
    check(np.isfinite([t.val_loss for t in trials]).all(),
          "every HPO trial trained to a finite validation loss")
    check(stats.device_calls == HPO_TRIALS, "every trial ran")
    return out


def phase_graph_ranking():
    """[15e] the train-then-rank entry points at their callers' sizes."""
    import numpy as np

    from repro_torch.core.ranking import rank_machines
    from repro_torch.launch.train import fingerprint_cluster
    from repro_torch.tuning.perona_weights import fingerprint_machine_scores

    t0 = time.perf_counter()
    wd, ranked, _ = fingerprint_cluster(CLUSTER, seed=0)
    cluster_s = time.perf_counter() - t0
    probs = wd.engine.score(wd.history).anomaly_prob
    t0 = time.perf_counter()
    scores = fingerprint_machine_scores(SCOUT_VM_TYPES,
                                        runs_per_type=MACHINE_RUNS,
                                        epochs=MACHINE_EPOCHS)
    machines_s = time.perf_counter() - t0
    by_score = rank_machines(scores)
    out = {"cluster": {"seconds": cluster_s, "ranked": ranked,
                       "history": len(wd.history)},
           "machines": {"seconds": machines_s, "ranked": by_score,
                        "scores": scores}}
    print(f"  e. fingerprint_cluster, {len(CLUSTER)} x n2-standard-4, 8 "
          f"runs a type, 40 epochs: {cluster_s:.2f} s, ranked {ranked}, "
          f"watchdog history {len(wd.history)} runs; "
          f"fingerprint_machine_scores, {len(SCOUT_VM_TYPES)} machine types x "
          f"{MACHINE_RUNS} runs, {MACHINE_EPOCHS} epochs: {machines_s:.2f} s,"
          f" ranked {by_score}")
    for m in by_score:
        print(f"    {m:11s} " + " ".join(f"{a} {v:.4f}"
                                         for a, v in sorted(scores[m].items())))
    check(sorted(ranked) == sorted(CLUSTER), "every host is ranked")
    check(np.isfinite(probs).all(), "the watchdog scores its history")
    check(sorted(scores) == sorted(SCOUT_VM_TYPES)
          and all(np.isfinite(v) for per in scores.values()
                  for v in per.values()), "finite machine scores")
    return out


# ------------------------------------------------------- the fleet tier
# [16b-d]: the Perona serving modes of launch/serve.py at fleet size
SERVE_NODES = FLEET_NODES
SERVE_FLEET_ROUNDS = 4
SERVE_DAEMON_ROUNDS = 6
SERVE_FP_ROUNDS = 8
# [16c]: the no-fault daemon against the closed loop
CLOSED_LOOP_ROUNDS = 3
DAY = 86400.0


@contextlib.contextmanager
def dispatch_launches():
    """Edge-softmax forward launches of every stacked dispatch made
    inside the block, in order (the ``ops.LAUNCHES`` delta around each
    ``ShardedScorer.score_stack`` call)."""
    from repro_torch.fleet.shard import ShardedScorer
    from repro_torch.kernels.edge_softmax import ops

    real, per = ShardedScorer.score_stack, []

    def counted(self, params, stack):
        before = ops.LAUNCHES
        out = real(self, params, stack)
        per.append(ops.LAUNCHES - before)
        return out

    ShardedScorer.score_stack = counted
    try:
        yield per
    finally:
        ShardedScorer.score_stack = real


class RoundSplit:
    """Times one service's round by its steps: intake (validation),
    the store append, request assembly, host-to-device copy, the scoring
    function (CUDA events), the device-to-host copy and the store
    attach, each on the host clock between synchronisations; stacking is
    read from the service's own ``fleet.stack`` span. What is left
    (``other``) is the new rows' feature preparation, the result objects
    and the watchdog's decisions. Installed on the instances only."""

    STEPS = (("intake", "submit", "service"),
             ("append", "append", "store"),
             ("assembly", "_assemble_requests", "service"),
             ("copy_in", "to_device", "scorer"),
             ("copy_out", "to_host", "scorer"),
             ("attach", "attach", "store"))

    def __init__(self, svc):
        import torch

        self.svc, self.parts, self.device_ms = svc, {}, []
        owners = {"service": svc, "scorer": svc.scorer, "store": svc.store}
        for part, name, owner in self.STEPS:
            obj = owners[owner]
            setattr(obj, name, self._timed(part, getattr(obj, name)))
        forward = svc.scorer.forward

        def timed_forward(*args):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = forward(*args)
            end.record()
            end.synchronize()
            self._add("forward", time.perf_counter() - t0)
            self.device_ms.append(start.elapsed_time(end))
            return out

        svc.scorer.forward = timed_forward

    def _add(self, part, dt):
        self.parts[part] = self.parts.get(part, 0.0) + dt

    def _timed(self, part, fn):
        import torch

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self._add(part, time.perf_counter() - t0)
            return out

        return wrapped

    def observe(self, wd, new):
        """One watchdog round through the service, split by step."""
        from repro_torch import obs

        self.parts, self.device_ms = {}, []
        obs.tracer().clear()
        t0 = time.perf_counter()
        decisions = wd.observe(new)
        wall = time.perf_counter() - t0
        self.parts["stack"] = sum(e.dur for e in obs.tracer().events()
                                  if e.name == "fleet.stack")
        device_s = sum(self.device_ms) / 1e3
        split = {"wall_s": wall, "parts_s": dict(self.parts),
                 "device_s": device_s,
                 "other_s": wall - sum(self.parts.values()),
                 "device_idle_share": 1.0 - device_s / wall}
        return decisions, split


def _round_rows(store, first_id):
    """(row ids, anomaly) of the rows appended from ``first_id`` on,
    in row-id order."""
    import numpy as np

    sel = store.row_id >= first_id
    order = np.argsort(store.row_id[sel], kind="stable")
    return store.row_id[sel][order], store.anomaly[sel][order]


def phase_fleet_watchdog(golden, pre, fleet):
    """[16a] the watchdog through the fleet service at phase [4]'s size,
    on the card and on the CPU, against [4]'s engine path."""
    import numpy as np

    from repro_torch.core.model import PeronaModel
    from repro_torch.fleet import FleetScoringService
    from repro_torch.runtime.watchdog import PeronaWatchdog

    print(f"  a. PeronaWatchdog(service=FleetScoringService(..., "
          f"context_per_chain={FLEET_HISTORY})): {FLEET_NODES} nodes, "
          f"{len(fleet['history'])} rows of history, {FLEET_ROUNDS} rounds "
          f"of {len(fleet['rounds'][0])} rows")
    model = PeronaModel(golden.config)
    wd, svc = {}, {}
    for dev in ("cuda", "cpu"):
        svc[dev] = FleetScoringService(model, golden.params, pre,
                                       context_per_chain=FLEET_HISTORY,
                                       device=dev)
        wd[dev] = PeronaWatchdog(model, golden.params, pre,
                                 service=svc[dev])
        t0 = time.perf_counter()
        wd[dev].history = fleet["history"]
        print(f"     {dev}: history seeded (features cached) in "
              f"{time.perf_counter() - t0:.2f} s")
    split = RoundSplit(svc["cuda"])
    rounds = []
    with dispatch_launches() as launches:
        for r, new in enumerate(fleet["rounds"]):
            first_id = svc["cuda"].store.next_id
            n0 = len(launches)
            d_gpu, row = split.observe(wd["cuda"], new)
            row["launches"] = launches[n0:]  # one entry a dispatch
            t0 = time.perf_counter()
            d_cpu = wd["cpu"].observe(new)
            row["cpu_round_s"] = time.perf_counter() - t0
            ref = fleet["engine_path"][r]
            ids, prob = _round_rows(svc["cuda"].store, first_id)
            cids, cprob = _round_rows(svc["cpu"].store, first_id)
            order = np.argsort(ref["row_id"], kind="stable")
            check(np.array_equal(ids, ref["row_id"][order])
                  and np.array_equal(ids, cids),
                  f"round {r}: the same rows scored on every path")
            row["err_vs_engine"] = float(
                np.abs(prob - ref["anomaly"][order]).max())
            row["err_vs_cpu"] = float(np.abs(prob - cprob).max())
            key = [(d.node, d.flagged, d.confirmed) for d in d_gpu]
            check(key == [(d.node, d.flagged, d.confirmed)
                          for d in ref["decisions"]]
                  and key == [(d.node, d.flagged, d.confirmed)
                              for d in d_cpu],
                  f"round {r}: decisions equal the engine path and the CPU")
            row["mean_prob_err_vs_engine"] = max(
                abs(a.anomaly_prob - b.anomaly_prob)
                for a, b in zip(d_gpu, ref["decisions"]))
            row["confirmed"] = sorted(d.node for d in d_gpu if d.confirmed)
            rounds.append(row)
            p = row["parts_s"]
            print(f"     round {r}: {row['wall_s'] * 1e3:.2f} ms wall = "
                  f"intake {p['intake'] * 1e3:.2f} + append "
                  f"{p['append'] * 1e3:.2f} + "
                  f"assembly {p['assembly'] * 1e3:.2f} + stack "
                  f"{p['stack'] * 1e3:.2f} + copy in "
                  f"{p['copy_in'] * 1e3:.2f} + forward "
                  f"{p['forward'] * 1e3:.2f} (device "
                  f"{row['device_s'] * 1e3:.3f}, CUDA events) + copy out "
                  f"{p['copy_out'] * 1e3:.2f} + attach "
                  f"{p['attach'] * 1e3:.2f} + other "
                  f"{row['other_s'] * 1e3:.2f}; idle share "
                  f"{row['device_idle_share']:.4f}; kernel launches a "
                  f"dispatch {row['launches']}; anomaly_prob vs engine path "
                  f"{row['err_vs_engine']:.3e}, vs CPU "
                  f"{row['err_vs_cpu']:.3e} (atol {ENGINE_ATOL:g}); CPU "
                  f"round {row['cpu_round_s']:.2f} s")
            check(max(row["err_vs_engine"], row["err_vs_cpu"])
                  <= ENGINE_ATOL, f"round {r}: service anomaly_prob")
            check(len(row["launches"]) == 1 and row["launches"][0] >= 1,
                  f"round {r}: one dispatch, and the kernel launched")
    st = svc["cuda"].stats
    sigs = sorted(svc["cuda"]._stack_sigs)
    print(f"     stats: {st['dispatches']} dispatches, "
          f"{st['requests_served']} requests, {st['rows_scored']} rows, "
          f"{st['traces']} signature(s) {sigs}, {st['scorer_retries']} "
          f"retries; confirmed after the last round "
          f"{rounds[-1]['confirmed']}")
    check(st["dispatches"] == FLEET_ROUNDS
          and st["requests_served"] == FLEET_ROUNDS * FLEET_NODES,
          "one stacked dispatch a round, every node a request")
    check(sigs == [(FLEET_NODES, 512)] and st["traces"] == 1,
          "each round is one stack of R=512 x bucket 512")
    check(st["scorer_retries"] == 0, "no dispatch was retried")
    check(rounds[-1]["confirmed"] == sorted(DEGRADED),
          "exactly the degraded nodes are confirmed")
    return {"rounds": rounds, "stats": st, "signatures": sigs}


def _check_dispatches(label, launches, st):
    print(f"     {label}: kernel launches per stacked dispatch {launches}")
    check(len(launches) > 0 and min(launches) >= 1,
          f"{label}: the kernel launched on every dispatch")
    check(st["scorer_retries"] == 0, f"{label}: no retries")


def phase_fleet_serve():
    """[16b] ``serve_fleet`` (the ``--fleet`` mode) on the card."""
    from repro_torch.launch import serve

    with dispatch_launches() as launches:
        t0 = time.perf_counter()
        fl = serve.serve_fleet(SERVE_NODES, SERVE_FLEET_ROUNDS,
                               device="cuda")
        fl["wall_s"] = time.perf_counter() - t0
    s = fl["stats"]
    print(f"  b. serve_fleet({SERVE_NODES} nodes, {SERVE_FLEET_ROUNDS} "
          f"rounds), training included: {fl['wall_s']:.2f} s; serving "
          f"{fl['seconds']:.3f} s, {s['requests_served']} requests, "
          f"{s['rows_scored']} rows, {s['requests_per_s']:.1f} req/s, "
          f"{s['dispatches']} dispatches, {s['traces']} signature(s), "
          f"worst drift node {fl['worst_node']}")
    _check_dispatches("serve_fleet", launches, s)
    check(s["requests_served"] == SERVE_FLEET_ROUNDS * SERVE_NODES
          and s["dispatches"] == SERVE_FLEET_ROUNDS,
          "every node served every round")
    check(s["rows_scored"] == SERVE_FLEET_ROUNDS * SERVE_NODES * 6,
          "rows scored")
    return {"wall_s": fl["wall_s"], "seconds": fl["seconds"], "stats": s,
            "worst_node": fl["worst_node"], "launches": launches}


def phase_fleet_daemon(golden, pre):
    """[16c] ``serve_daemon(faults=True)`` (``--daemon --faults``), then
    the same stream and faults through a daemon that scores with the
    golden model."""
    from repro_torch.core.model import PeronaModel
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.fleet import (FaultPlan, FleetScoringService,
                                   IngestionDaemon, fleet_telemetry,
                                   inject_faults)
    from repro_torch.launch import serve

    with dispatch_launches() as launches:
        t0 = time.perf_counter()
        dm = serve.serve_daemon(SERVE_NODES, SERVE_DAEMON_ROUNDS,
                                faults=True, device="cuda")
        wall = time.perf_counter() - t0
    st, faults = dm["stats"], dm["faults"]
    ladder = {k: st[k] for k in (
        "events_seen", "events_accepted", "duplicates_dropped",
        "deadline_flushes", "row_trigger_flushes", "forced_flushes",
        "drain_flushes", "blocked_events", "shed_rows", "degrade_entries",
        "degraded_flushes", "degrade_unscored_rows", "recoveries",
        "flush_failures", "scorer_retries", "peak_staged_rows")}
    print(f"  c. serve_daemon({SERVE_NODES} nodes, {SERVE_DAEMON_ROUNDS} "
          f"rounds, faults), training included: {wall:.2f} s; ladder "
          f"{ladder}; p99 queue latency {st['latency_p99']:.3f} s; "
          f"quarantined {st['service']['quarantined_rows']} rows; "
          f"injected {faults}; degraded node {dm['degraded_node']} -> "
          f"flagged {dm['flagged']} (its 40-epoch model's)")
    _check_dispatches("serve_daemon", launches, st)
    check(st["flush_failures"] == 0, "no flush failed")
    check(st["service"]["quarantined_rows"] == faults["corrupted_rows"],
          "quarantined rows equal the injector's corrupted rows")
    check(st["duplicates_dropped"] == faults["duplicated"],
          "every duplicate dropped once")

    # The flag needs a model that separates stressed runs: serve_daemon's
    # 40 full-batch steps do not at this size (nor do the JAX package's
    # at 16 and 64 nodes, ROADMAP.md §3), so the same stream and faults
    # go through a daemon scoring with the golden model (JAX-trained).
    machines = {f"fleet-{i}": "e2-medium" for i in range(SERVE_NODES)}
    svc = FleetScoringService(PeronaModel(golden.config), golden.params,
                              pre, context_per_chain=16, device="cuda")
    svc.seed_history(SuiteRunner(seed=0).run_frame(
        machines, runs_per_type=10, stress_fraction=0.2))
    daemon = IngestionDaemon(svc, capacity_rows=64 * SERVE_NODES,
                             flush_interval=0.5, min_flush_gap=0.05)
    degraded = dm["degraded_node"]
    events, log = inject_faults(
        fleet_telemetry(machines, rounds=SERVE_DAEMON_ROUNDS,
                        runs_per_type=1, seed=1, interval=1.0, jitter=0.25,
                        degraded={degraded: SERVE_DAEMON_ROUNDS // 2}),
        FaultPlan(seed=2, **serve.DAEMON_FAULTS))
    with dispatch_launches() as golden_launches:
        daemon.run(events)
    gst = daemon.stats()
    flagged = daemon.flagged_nodes()
    report = daemon.drift.report()
    ewma = sorted((r.anomaly_ewma, n) for n, r in report.items())
    print(f"     the same stream, golden model: flagged {flagged}; "
          f"{degraded} anomaly EWMA {report[degraded].anomaly_ewma:.4f}, "
          f"the highest healthy node's {ewma[-2][0]:.4f} "
          f"({ewma[-2][1]}); quarantined "
          f"{gst['service']['quarantined_rows']} rows (injected "
          f"{log.corrupted_rows})")
    _check_dispatches("golden daemon", golden_launches, gst)
    check(gst["flush_failures"] == 0, "no flush failed")
    check(gst["service"]["quarantined_rows"] == log.corrupted_rows,
          "quarantined rows equal the injector's corrupted rows")
    check(degraded in flagged, "the injected degraded node is flagged")
    return {"wall_s": wall, "ladder": ladder, "faults": faults,
            "flagged": dm["flagged"], "latency_p99": st["latency_p99"],
            "service": st["service"], "launches": launches,
            "golden": {"flagged": flagged, "degraded_ewma":
                       report[degraded].anomaly_ewma,
                       "top_healthy": ewma[-2], "launches": golden_launches,
                       "ladder": {k: gst[k] for k in ladder}}}


def phase_fleet_fingerprint():
    """[16d] ``serve_fingerprints`` (the ``--fingerprint`` mode)."""
    from repro_torch.launch import serve

    with dispatch_launches() as launches:
        fp = serve.serve_fingerprints(SERVE_FP_ROUNDS, device="cuda")
    print(f"  d. serve_fingerprints({SERVE_FP_ROUNDS} rounds): "
          f"{fp['scored']} executions in {fp['seconds']:.3f} s, "
          f"{fp['traces']} signature(s), excluded {fp['excluded']}")
    _check_dispatches("serve_fingerprints", launches, fp["stats"])
    check(fp["stats"]["requests_served"] == SERVE_FP_ROUNDS * 3,
          "every fingerprint round served")
    return {"scored": fp["scored"], "seconds": fp["seconds"],
            "traces": fp["traces"], "excluded": fp["excluded"],
            "launches": launches}


def phase_fleet_closed_loop(golden, pre):
    """[16c] a no-fault daemon at service_time_scale=0.0 against the
    closed loop (score_round a round), bit for bit on the card."""
    import numpy as np

    from repro_torch.core.model import PeronaModel
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.fleet import (FleetScoringService, IngestionDaemon,
                                   fleet_telemetry)

    machines = {f"node-{i:03d}": "e2-medium" for i in range(FLEET_NODES)}
    history = SuiteRunner(seed=3).run_frame(machines, runs_per_type=10)
    model = PeronaModel(golden.config)

    def service():
        svc = FleetScoringService(model, golden.params, pre, device="cuda")
        svc.seed_history(history)
        return svc

    closed, src = service(), SuiteRunner(seed=7)
    want = {}
    for k in range(CLOSED_LOOP_ROUNDS):
        rnd = src.run_frame(machines, runs_per_type=1,
                            t_offset=(k + 1) * DAY)
        for n, r in closed.score_round(rnd).items():
            want.setdefault(n, []).append(r)
    svc = service()
    daemon = IngestionDaemon(svc, capacity_rows=8 * len(machines) * 6,
                             flush_interval=0.5, flush_rows=1 << 30,
                             service_time_scale=0.0)
    got = daemon.run(fleet_telemetry(machines, rounds=CLOSED_LOOP_ROUNDS,
                                     runs_per_type=1, seed=7, interval=1.0,
                                     jitter=0.01))
    st = daemon.stats()
    same = sorted(got) == sorted(want) and all(
        len(got[n]) == len(want[n]) == CLOSED_LOOP_ROUNDS
        and all(np.array_equal(getattr(a, k), getattr(b, k))
                for a, b in zip(got[n], want[n])
                for k in ("anomaly_prob", "codes", "type_logits"))
        for n in want)
    print(f"     no-fault daemon ({FLEET_NODES} nodes, "
          f"{CLOSED_LOOP_ROUNDS} rounds, service_time_scale 0): "
          f"{st['deadline_flushes']} deadline + {st['drain_flushes']} drain "
          f"flushes, {closed.stats['dispatches']} closed-loop dispatches; "
          f"equal to the closed loop bit for bit: {same}")
    check(st["deadline_flushes"] == CLOSED_LOOP_ROUNDS - 1
          and st["drain_flushes"] == 1, "one flush a round")
    check(same, "no-fault daemon equals the closed loop bit for bit")
    check(st["flush_failures"] == 0 and st["scorer_retries"] == 0,
          "no failures or retries")
    return {"bit_identical": same, "daemon": {
        k: st[k] for k in ("deadline_flushes", "drain_flushes",
                           "flush_failures", "scorer_retries")}}


def phase_fleet(golden, pre, fleet):
    import torch

    print("[16] the fleet tier: stacked request scoring, the service, "
          "the watchdog's service path, the ingestion daemon and the "
          "Perona serving modes")
    out = {"watchdog": phase_fleet_watchdog(golden, pre, fleet),
           "fleet": phase_fleet_serve(),
           "daemon": phase_fleet_daemon(golden, pre),
           "closed_loop": phase_fleet_closed_loop(golden, pre),
           "fingerprint": phase_fleet_fingerprint()}
    torch.cuda.empty_cache()
    return out


def timed(label, seconds, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[label] = time.perf_counter() - t0
    print(f"  -- {label}: {seconds[label]:.1f} s")
    return out


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
    seconds = {}
    timed("card", seconds, phase_card)
    timed("build", seconds, phase_build)
    max_err = timed("edge_softmax kernel", seconds, phase_kernels)

    golden = load_golden()
    frame = paper_acquisition_frame(seed=0)
    pre = Preprocessor().fit(chronological_split(frame)[0])
    for key in ("lo", "hi", "maximize", "fill_mean", "edge_lo", "edge_hi",
                "feature_names", "benchmark_types", "edge_names"):
        check(np.array_equal(np.asarray(getattr(pre, key)),
                             np.asarray(getattr(golden.preproc, key))),
              f"preprocessor statistic {key} equals the golden file's")

    ops.LAUNCHES = 0  # the Perona main path starts here
    engine = timed("engine", seconds, phase_engine, golden, pre, frame)
    fleet = timed("watchdog", seconds, phase_watchdog, golden, pre)
    launches = ops.LAUNCHES  # ... and ends here
    check(launches > 0, "the main path launched the kernel")

    lm_err = timed("LM kernels", seconds, phase_lm_kernels)
    lm_golden = timed("LM golden", seconds, phase_lm_golden)
    lm_full, lm_launches = timed("LM full width", seconds, phase_lm_full)
    torch.cuda.empty_cache()

    timing, engine_rows, lm_timing = timed(
        "timing", seconds, phase_timing, engine, frame, fleet["frame"])
    torch.cuda.empty_cache()

    from repro_torch.models.params import XLSTM_GOLDEN_PATH

    mlstm_err = timed("mLSTM kernel", seconds, phase_mlstm_kernel)
    # before the xLSTM's profiled prefill of some 10^5 launches, after
    # which the profiler's next short session recorded no kernel
    mlstm = timed("mLSTM timing", seconds, time_mlstm)
    xlstm_golden = timed("xLSTM golden", seconds, phase_lm_golden,
                         XLSTM_GOLDEN_PATH, "[11] small xLSTM")
    xlstm_full, mlstm_launches = timed("xLSTM full width", seconds,
                                       phase_xlstm_full)
    torch.cuda.empty_cache()

    from repro_torch.core.params import load_train_golden

    train_golden = load_train_golden()
    tb, vb = train_batches()
    bwd_err = timed("training: backward kernel", seconds,
                    phase_train_kernel)
    fixed = timed("training: fixed point", seconds, phase_train_fixed_point,
                  train_golden, tb)
    ops.LAUNCHES = ops.BWD_LAUNCHES = 0  # the training main path starts here
    runs = timed("training: runs", seconds, phase_train_runs, train_golden,
                 tb, vb)
    train_launches = {"forward": ops.LAUNCHES,
                      "backward": ops.BWD_LAUNCHES}  # ... and ends here
    check(train_launches["backward"] > 0,
          "the training path launched the backward kernel")
    bwd_timing, epoch_prof = timed("training: timing", seconds,
                                   phase_train_timing, train_golden, tb, vb)
    host_run = runs.pop("dropout0_run")
    host_dropout_run = runs.pop("dropout_run")

    hpo_err = timed("graphed trainer: kernels", seconds, phase_graph_kernels)
    ops.LAUNCHES = ops.BWD_LAUNCHES = 0  # the graphed path starts here
    graph_train = timed("graphed trainer: dropout 0", seconds,
                        phase_graph_train, train_golden, tb, vb, host_run)
    graph_dropout = timed("graphed trainer: default dropouts", seconds,
                          phase_graph_dropout, train_golden, tb, vb,
                          runs["dropout_s"], host_dropout_run)
    graph_hpo = timed("graphed trainer: HPO", seconds, phase_graph_hpo,
                      train_golden, tb, vb)
    graph_ranking = timed("graphed trainer: ranking", seconds,
                          phase_graph_ranking)
    graph_launches = {"forward": ops.LAUNCHES,
                      "backward": ops.BWD_LAUNCHES}  # ... and ends here
    check(graph_launches["forward"] > 0 and graph_launches["backward"] > 0,
          "the graphed path captured both edge-softmax kernels")
    # null where the profiler resolved no kernel inside the replays
    per_replay = graph_dropout["profile"]["launches_per_replay"]
    from repro_torch.core.trainer import _program

    _program.cache_clear()  # the graphed epochs' memory pools
    torch.cuda.empty_cache()

    ops.LAUNCHES = ops.BWD_LAUNCHES = 0  # the fleet tier starts here
    fleet_tier = timed("fleet tier", seconds, phase_fleet, golden, pre,
                       fleet)
    fleet_launches = {"forward": ops.LAUNCHES,
                      "backward": ops.BWD_LAUNCHES}  # ... and ends here
    check(fleet_launches["forward"] > 0,
          "the fleet tier launched the edge-softmax kernel")

    big = timing["262144"]
    big_bwd = bwd_timing["262144"]
    flash, lru = lm_timing["flash"], lm_timing["rg_lru"]
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
        "launches_graphed_trainer": graph_launches["forward"],
        "launches_per_replay": per_replay.get("edge_softmax_fwd"),
        "hpo_head_errors": {k: v[0] for k, v in hpo_err.items()},
        "launches_fleet_tier": fleet_launches["forward"],
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": lm_launches["flash"],
        "max_abs_err": lm_err["flash_main"],
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "shape": flash["shape"],
        "design": flash["design"],
        "f32_ms": flash["f32_ms"],
    }, {
        "name": "rg_lru_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rg_lru.cu",
        "replaces": "src/repro/kernels/rg_lru/kernel.py:23",
        "launches": lm_launches["rg_lru"],
        "max_abs_err": lm_err["rg_lru_main"],
        "ms": lru["ms"],
        "plain_ms": lru["plain_ms"],
        "bound_ms": lru["bound_ms"],
        "bound_by": lru["bound_by"],
        "library_ms": lru["library_ms"],
        "shape": lru["shape"],
        "design": lru["design"],
    }, {
        "name": "mlstm_chunkwise",
        "route": "cuda",
        "source": "src/repro_torch/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm/kernel.py:24",
        "launches": mlstm_launches,
        "max_abs_err": mlstm_err["main"],
        "ms": mlstm["ms"],
        "plain_ms": mlstm["plain_ms"],
        "bound_ms": mlstm["bound_ms"],
        "bound_by": mlstm["bound_by"],
        "library_ms": mlstm["library_ms"],
        "shape": mlstm["shape"],
        "design": mlstm["design"],
        "f32_ms": mlstm["f32_ms"],
    }, {
        "name": "edge_softmax_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/edge_softmax.cu",
        "replaces": "src/repro/kernels/edge_softmax/ops.py:58",
        "launches": train_launches["backward"],
        "max_abs_err": bwd_err["main"],
        "ms": big_bwd["ms"],
        "plain_ms": big_bwd["plain_ms"],
        "bound_ms": big_bwd["bound_ms"],
        "bound_by": big_bwd["bound_by"],
        "library_ms": big_bwd["library_ms"],
        "shape": "N=262144 H=4 hd=8 P=3 float32, no att cotangent",
        "by_n": bwd_timing,
        "launches_per_epoch": runs["launches_per_epoch"],
        "launches_graphed_trainer": graph_launches["backward"],
        "launches_per_replay": per_replay.get("edge_softmax_bwd"),
        "hpo_head_errors": {k: v[1] for k, v in hpo_err.items()},
        "launches_fleet_tier": fleet_launches["backward"],
    }]
    card = card_line()
    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "seconds": seconds, "kernels": kernels, "engine": engine_rows,
        "lm_kernel_errors": lm_err, "lm_golden": lm_golden,
        "lm_full_width": lm_full, "lm_kernel_timing": lm_timing,
        "mlstm_kernel_errors": mlstm_err, "xlstm_golden": xlstm_golden,
        "xlstm_full_width": xlstm_full, "mlstm_timing": mlstm,
        "training": {"backward_errors": bwd_err, "fixed_point": fixed,
                     "runs": runs, "launches": train_launches,
                     "backward_timing": bwd_timing,
                     "epoch_profile": epoch_prof},
        "graphed_training": {"hpo_head_errors": hpo_err,
                             "dropout0": graph_train,
                             "dropout": graph_dropout, "hpo": graph_hpo,
                             "ranking": graph_ranking,
                             "launches": graph_launches},
        "fleet_tier": {**fleet_tier, "launches": fleet_launches}},
        indent=1, default=str))
    print(f"[17] done in {time.perf_counter() - t_start:.1f} s; report in "
          f"{REPORT.relative_to(ROOT)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
