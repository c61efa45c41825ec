#!/usr/bin/env python3
"""Drive the PyTorch port of Perona (``src/repro_torch``) on one NVIDIA
GPU, hold it against its plain versions and the JAX package's stored
outputs, and time its kernels. The paths driven: Perona's scoring
path (edge-softmax kernel), RecurrentGemma-9B serving at full width
(flash-attention and RG-LRU scan kernels), xLSTM-1.3B serving at full
width (chunkwise mLSTM kernel), Perona's host-loop training and its
device-resident training with the HPO and the train-then-rank entry
points (the edge-softmax forward and backward kernels), Perona's fleet
serving tier: stacked request scoring, the scoring service, the
ingestion daemon and the serve modes (the edge-softmax forward), and
its operations layer: the model plane with its drift retrain, the
registry, the timeline and the checkpoint manager (both edge-softmax
kernels), and the configuration search of paper §IV-D/E: the scout
simulator's threefry draws, CherryPick and Arrow with Perona's
acquisition weighting, the batched float64 BO replay, Lotaru and Tarema
(both edge-softmax kernels, through the machine scores), and the LM
zoo's dense and MoE decoders, smollm-135m, qwen2.5-3b, olmo-1b,
gemma3-4b and granite-moe-1b-a400m, serving at full width (the
flash-attention kernel, head dims 64, 128 and 256), and DeepSeek-V2-Lite
(latent attention and MoE) and Qwen2-VL (M-RoPE, embeddings input)
serving at full width (the flash-attention kernel with q/k head dim 192
and v head dim 128, and at a GQA group of 7), and whisper-small, an
encoder-decoder, at full width through its model API (the
flash-attention kernel without a mask in the encoder and the
cross-attention), and LM training: smollm-135m at full width through
``launch/train.py::main``, Perona ranking the hosts first, a host
failure and a restart from a checkpoint (the flash-attention forward
and its backward kernel, and the edge-softmax kernels), and
RecurrentGemma's training at every published width through
``launch/train.py::make_step`` and at small scale through ``main`` (the
RG-LRU scan's forward and backward kernels and flash's), xLSTM-1.3B's
(the mLSTM's forward and backward kernels), DeepSeek-V2-Lite's (the
flash forward and backward at the latent attention's (192, 128), the
MoE with shared experts under grad), and Qwen2-VL's and whisper-small's
(the flash forward and backward at a GQA group of 7 with M-RoPE from
embeddings, and without a mask in an encoder and a cross-attention over
1500 frames).

    python3 chip_smoke.py

Phases, each printing on lines of its own:

0. the card: name and power limit, torch and CUDA versions;
1. build: the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, one
   process per source (five), all started together;
2. the edge-softmax kernel against its plain PyTorch version on the
   card, at the main path's shapes ((H, hd) (4, 8), and the HPO's (2, 16)
   and (8, 4)), ragged N, single heads and fully masked rows;
3. the scoring engine on the §IV-C acquisition (1800 rows, bucket 2048)
   against the JAX engine's outputs stored in the golden file;
4. the watchdog at fleet size (512 nodes, 196,608 rows of history,
   3 rounds of 6,144 new rows) against a CPU run of the port;
5. the flash-attention and RG-LRU kernels against their plain versions
   on the card (f32 and bf16; B 1/2, (H, KH) (16, 1)/(16, 16)/(9, 3)/
   (16, 2), D 64/256, S up to 4096, window 0/2048; then the bf16
   kernel's tile edges: S, T in 15..191 around multiples of 64 and 128,
   window 0/1/64/65, (H, KH) (16, 1)/(16, 4)/(16, 16)/(9, 3)/(16, 2), D
   16/64/128/256; the scan at C=4096, S 1/257/4096, with and without h0;
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
17. the operations layer: (a) ``--daemon --modelplane --faults`` at 512
   nodes x 6 rounds through ``launch/serve.py::main`` with ``--registry``
   and ``--timeline``: the identical candidate passes its canary (its
   divergence printed) and is promoted at a flush boundary, the NaN
   candidate is rolled back on the watch's first flush, the offline
   ``--modelplane-cmd list``, the timeline valid and holding the promote
   and rollback instants; each step's time (flush, the canary's shadow
   flush, warm, swap, the repair's rows and time); then the same stream
   and faults at ``service_time_scale=0`` through a daemon scoring with
   the golden model, with the plane's sequence and without it: the
   repaired rows, the store and the results equal bit for bit; (b) one
   drift retrain episode through the default ``retrain_fn`` (a fresh
   model trained on the store) on a 256-node fleet, forced with
   ``drift_ewma_threshold=0.0``, fired on a store of 24,576 rows: its
   time, the N x N reckoning, peak memory, its canary and promote with
   source ``drift-retrain``, the backward kernel launched; (c)
   ``CheckpointManager(async_save=True)``: the card's parameters saved,
   updated in place, restored onto the card bit for bit. Every dispatch
   launches the kernel; no dispatch is retried and no flush fails.
18. the configuration search, against the JAX package's golden file
   ``src/repro_torch/assets/scout_search_golden.npz``: (a) the threefry
   words and float64 uniforms of the scout's parameter and noise draws
   bit for bit, normals within ``NORMAL_ULP``, the parameter grid within
   ``BOUNDED_ULP``, the noise, runtime, cost and lows grids of
   ``ScoutDataset(device="cuda")`` within ``GRID_RTOL``, and the seeded
   expansion on the card equal to the dataset's host tables bit for
   bit; (b) the §IV-D matrix (18 workloads x seeds 0-2 x 4 variants x
   healthy and the c4 fleet degraded through the store path, 432
   lanes) at the golden's stand-in scores: picks and counts equal to
   JAX's in every lane, costs within ``GRID_RTOL``; (c) the same matrix
   at [15e]'s machine scores: ``replay_pipelined(seeded=True,
   block_lanes=128)`` against the sequential tuner on the host in every
   lane (a lane may leave it only at a 1-ulp float32 EI tie, printed),
   and the host-table, seeded and unpipelined replays equal; (d) the
   fleet sweep of ``benchmarks/bench_optimizer.py`` (12 seeds x the
   healthy fleet and three deferred drift conditions, 3,456 lanes in
   blocks of 128), seeded and from host tables, picks equal; (e) one
   seeded dispatch of the 432 lanes: first and later time, launches and
   idle share from the profiler, and no host sync from the first copy
   to the fetch under ``set_sync_debug_mode("error")``; (f) §IV-E as
   ``benchmarks/bench_workflows.py`` prints it: the Lotaru table and
   the Tarema grouping on calibrated scores of the four GCP types, the
   paper's claims holding.
19. the LM zoo's dense and MoE decoders: (a) the flash kernel on both
   routes against its plain version at the zoo's (H, KH, D, window),
   (9, 3, 64, 0), (16, 2, 128, 0), (16, 16, 128, 0), (8, 4, 256, 1024),
   (8, 4, 256, 0), (16, 8, 64, 0), S 1/100/2048/3000/4096, and the
   tensor-core kernel's resources at D = 128; (b) the five small models
   (float32) against the JAX package's prefill and decode logits and
   served tokens (``lm_zoo_small_golden.npz``); (c) each arch at full
   width (bf16, seed-0 weights drawn on the card) serving 8 requests of
   128..4096 prompt tokens through ``SlotServer``: completion, flash
   launches per prefill equal to its attention layers, TTFT from arrival
   and prefill latency, prefill and decode tokens/s, peak memory;
   prefill logits through the kernels vs the plain versions (bf16 at
   4096 and 3000, float32 at 4096) and decode after a 3000-token prefill
   vs a no-cache forward, in bf16 and float32 (gemma3's window of 1024:
   the port's ring layout off a multiple of W); granite: the routing
   choices each prefill dropped, and decode steps after a prefill that
   dropped none vs the forward at positions before its first drop; the
   profiler's view of a 4096-token prefill of smollm-135m and
   qwen2.5-3b; (d) the flash kernel at head dim 128, B=1 H=16 KH=2
   S=4096 causal: time, TFLOP/s, bound, plain version, SDPA and the
   float32 route.
20. the MLA and M-RoPE decoders: (a) the flash kernel on both routes
   against its plain version at (H, KH, D, DV) (16, 16, 192, 128)
   (DeepSeek-V2-Lite's prefill), (28, 4, 128, 128) (Qwen2-VL's group of
   7) and, on the float32 route, (4, 4, 24, 16) (the small DeepSeek's;
   the bf16 route refuses it with a ValueError naming the pair), S
   1/100/2048/3000/4096; the bf16 tile edges of phase [5] at (192, 128)
   with (H, KH) (28, 4) added, and (28, 4) at (128, 128); the (192, 128)
   kernel at B=1 H=16 KH=16 S=4096 causal: time, TFLOP/s, bound, plain
   version, SDPA, the float32 route, registers and shared memory, and
   which of SDPA's backends runs that problem; (b) the small DeepSeek
   and Qwen2-VL (float32) against the JAX package's prefill and decode
   logits, served tokens and (Qwen2-VL) a prefill from embeddings with
   M-RoPE rows that differ (``lm_zoo_mla_mrope_small_golden.npz``); (c)
   each at full width as in [19c] (27 and 28 flash launches a prefill),
   DeepSeek's decode through the MoE check with its bf16 decode and
   forward each measured against the float32 plain route, and
   Qwen2-VL's 4096-token prefill from seeded embeddings with an image's
   positions (32 text tokens, a 64 x 64 patch grid merged to 32 x 32,
   text), kernels vs plain, and the same with three equal rows equal to
   RoPE positions bit for bit. The float32 copies of the weights are
   made through the host, one leaf at a time.
21. whisper-small: (a) the flash kernel without a mask on both routes
   against its plain version at (H, KH, D) (12, 12, 64), S
   1/100/448/1500/4096 over T = 1500 keys and over T = S; the bf16 tile
   edges of phase [5] without a mask (window 0); the kernel at the
   encoder's problem (B=4 S=T=1500) and the cross-attention's (B=1
   S=4096 T=1500): time, TFLOP/s, bound, plain version, SDPA without a
   mask and which backend runs it, the float32 route, registers and
   shared memory; (b) the small whisper (float32) against the JAX
   package's encoder output, prefill and decode logits and greedy tokens
   (``lm_zoo_whisper_small_golden.npz``); (c) whisper-small at full
   width (bf16, seed-0 weights drawn on the card): 4 rows of seeded
   frames (4, 1500, 768), a prefill of 4 x 448 tokens, 16 greedy decode
   steps, a prefill of 1 x 4096 tokens; 36 flash launches a prefill (12
   encoder layers without a mask, 12 causal self-attentions, 12
   cross-attentions without a mask), the encoder's time, prefill latency
   and tokens/s, decode tokens/s, peak memory; kernels vs plain on the
   encoder output and both prefills' logits, and the decode steps vs a
   no-cache forward with the same encoder output, in bf16 (1e-1) and
   float32 (1e-4) as relative L2.
22. LM training: (a) the backward's routes (bf16 on the tensor cores,
   float32 on the CUDA cores) at every head dim and each tensor-core
   kernel's registers, spills and shared memory; the flash backward
   kernels (``flash_attention`` under
   autograd on the card) against the plain version's autograd, dq, dk
   and dv at |a - b| <= TOL (1 + |b|), the cotangent zeroed at rows with
   no live key for the plain version: (H, KH) (9, 3)/(16, 2)/(16, 16)/
   (8, 4)/(16, 1), D 16/64/128/256, causal with window 0, 1024 and 2048
   and without a mask over T = S and T = 1500, S 1/777/4096, f32 and
   bf16; 576 bf16
   tile edges (S 31..191 around multiples of 32 and 64, T = S and about
   S / 2, windows 0/1/65, no mask); 5 launches bit for bit at smollm's
   training problem; (b) the five small decoders against
   ``lm_train_small_golden.npz``: their ``TokenPipeline`` batches bit for
   bit, the loss terms (1e-5), every gradient leaf at each of 3 steps
   (1e-4 of the leaf's largest) and the port's AdamW under
   ``cosine_schedule`` fed the JAX gradients (1e-5), the flash launches
   a step; the full-vocabulary batches (49,152, B 8, S 2048) bit for
   bit; (c) ``launch.train.main`` on smollm-135m at full width (bf16
   seed-0 weights, B 8 x S 2048, 30 steps, host-1 failing at step 12, a
   checkpoint every 10): 31 finite losses falling, one restart, 60
   forward and 30 backward flash launches a step, every kernel of the
   path launched; step time (CUDA events), tokens/s, peak memory,
   ``batch_at``'s time, a profiled step's top entries and idle share;
   the loss and every gradient leaf through the kernels against the
   plain versions on one batch, bf16 (1e-1) and float32 (1e-4) relative
   L2; the backward's split by kernel (delta, dK/dV, dQ) in the profiled
   step; (d) the backward, with L from the forward, at smollm's problem
   (B 8 H 9 KH 3 S 2048 D 64), at D = 128 (B 1 H 16 KH 2 S 4096) and at
   gemma3-4b's (B 1 H 8 KH 4 S 4096 D 256, window 1024), causal: time,
   bound (2.5x the forward's FLOPs at the bf16 rate; the f32 route at
   the f32 rate), plain version, SDPA's backward with ``is_causal`` (k/v
   repeated or ``enable_gqa``, the faster; the window as a boolean mask)
   and the backend nearest its gradients; the bf16 forward without and
   with L at D = 128 and D = 256, in turns.
23. RecurrentGemma's training: (a) the RG-LRU backward kernel
   (``ops.linear_scan_bwd``) against ``ref.linear_scan_bwd`` at |a - b|
   <= TOL (1 + |b|) over da, db and dh0: S 1/31/32/33/63/64/65/1000/4096
   by C 1/100/128/4096, B 1/4, with and without h0 and g_last (288
   cases), its order in plain PyTorch measured; 20 launches at B=4
   S=4096 C=4096 bit for bit; a long-memory case against float64 (e_k <=
   1.5 e_p); one launch through autograd at B=2 S=4096; the flash
   backward on both routes at the cell's (B 2, H 16, KH 1, S 4096, D 256,
   window 2048); (b) the small RecurrentGemma against
   ``lm_train_recurrentgemma_small_golden.npz`` as [22b], the RG-LRU and
   flash backwards launched; (c) ``recurrentgemma-9b`` at every published
   width with its body cut to 2 of 12 periods (8 layers, 2.64 B
   parameters: its weights, gradients and float32 moments fit the card,
   the full depth's do not), bf16 seed-0 weights, 12 steps of B 2 x S
   4096 through ``make_step`` with AdamW (in place) under
   ``cosine_schedule(3e-4, 10, 12)``: losses finite and falling, the
   launches a step (RG-LRU 10 forward, 6 backward; flash 4 and 2), step
   time, tokens/s, peak memory, a profiled step; at the trained weights,
   B 1 x S 1024, the loss and every gradient through the kernels against
   the plain versions in float32 (1e-4), and in bf16 each route's
   distance from the float32 plain route, the kernels' within max(1e-1,
   1.25 x) the plain versions'; then
   ``launch.train.main`` on the small RecurrentGemma, 20 steps, a failure
   at step 12 (21 finite losses, one restart, the backward kernels
   launched); (d) the RG-LRU backward at B 1 and 2, S 4096, C 4096 (back
   to back and in a CUDA graph, bound, TB/s, scratch, plain version) and
   the flash backward at (c)'s problem beside its bound and SDPA's.
   A script that imports this one and calls ``phase_card()``,
   ``phase_build()`` and ``phase_rg_train()`` runs it alone.
24. xLSTM's training: (a) the mLSTM backward kernel
   (``ops.mlstm_chunkwise_bwd``; bf16 on the tensor-core route, float32
   on the CUDA-core route) against ``ref.mlstm_chunkwise_bwd`` per
   tensor (max |a - b| / max |b|: float32 1e-4, bf16 2e-2) over dq, dk,
   dv, dlog_i and dlog_f: S 1/15/16/17/63/64/65/127/128/129/255/256/257/
   1000/4096 by hd 32/96/1024, chunks 64 and 256, (B, H) (1, 1) and
   (2, 4), both input types (360 cases), and hd 160 at S 65/129/257/1000
   (32 cases); float32 also against the plain version in float64
   (e_k <= 2 e_p); each route's kernels' registers, spills and shared
   memory; 20 launches at B=1 H=4 S=4096 hd=1024 bf16 bit for bit; the
   reference's state overflow through both routes (non-finite entries
   as the plain version's); one launch through autograd at the cell's
   shape; (b) the
   small xLSTM against ``lm_train_xlstm_small_golden.npz`` as [22b] (the
   sLSTM's ``ri/b``, whose exact gradient is 0, by the global norm); (c)
   ``xlstm-1.3b`` at every published width and full depth (1.918 B
   parameters), bf16 seed-0 weights, 6 steps of B 4 x S 2048 through
   ``make_step`` with AdamW (in place) under ``cosine_schedule(1e-3, 1,
   6)``: losses finite and falling, 84 mLSTM forward and 42 backward
   launches a step, step time, tokens/s, peak memory, the sLSTM's host
   time, a profiled step at S 512; at the trained weights, B 1 x S 512,
   kernels vs plain in float32 (1e-4) and in bf16 by distance from the
   float32 plain route (max(1e-1, 1.25 x)); ``launch.train.main`` on the
   small xLSTM at S 300, 20 steps, a failure at step 12; the profiled
   step's mLSTM time split by kernel; (d) the backward at B 1 x S 4096
   and B 4 x S 2048 (H 4, hd 1024, chunk 256) on both routes (bf16 and
   float32), TFLOP/s, beside its bounds at each route's rate (the bf16
   tensor-core rate, the float32 CUDA-core rate), scratch and the plain
   version.
   ``phase_card()``, ``phase_build()`` and ``phase_xlstm_train()`` run
   it alone.
25. DeepSeek-V2-Lite's training: (a) the flash backward at the latent
   attention's head-dim pairs against the plain version's autograd at
   |a - b| <= TOL (1 + |b|) over dq, dk and dv (float32 against float64):
   (192, 128) on both routes and (24, 16) on the float32 route, S
   1/63/64/65/129/777/4096, T = S and (S + 1) // 2, H = KH 4 and 16,
   causal (84 cases); the tensor-core kernels' registers, spills (none)
   and shared memory at (192, 128); a bf16 gradient at (24, 16) refused
   with a ValueError before a launch; at DeepSeek's training problem (B
   2, H 16, S 4096) 5 launches bit for bit and one call through autograd;
   (b) the small DeepSeek (float32, flash at (24, 16) on the CUDA cores)
   against ``lm_train_deepseek_small_golden.npz`` as [22b]; (c)
   ``deepseek-v2-lite-16b`` at every published width with its body cut
   to 4 of 26 periods (the dense layer and 4 MLA-MoE layers, 2.84 B
   parameters: 12 bytes a parameter fit the card, the full depth's 15.7
   B do not), bf16 seed-0 weights, 8 steps of B 2 x S 4096 through
   ``make_step`` with AdamW (in place) under ``cosine_schedule(1e-3, 1,
   8)``: losses finite and falling, 9 flash forward and 5 backward
   launches a step, step time, tokens/s, peak memory beside the card, a
   profiled step (its device rows, idle share, the share of routing
   choices dropped past capacity); at the trained weights, B 1 x S 1024,
   kernels vs plain in float32 (1e-4) and in bf16 by distance from the
   float32 plain route (max(1e-1, 1.25 x)); ``launch.train.main`` on the
   small DeepSeek in float32, 20 steps, a failure at step 12; (d) the
   backward at (c)'s attention problem on both routes, and on the
   float32 route at the small DeepSeek's (24, 16) in ``main``'s problem
   (B 8, H = KH = 4, S 256), each beside its bound and SDPA's backward.
   ``phase_card()``, ``phase_build()`` and ``phase_ds_train()`` run it
   alone;
26. Qwen2-VL's and whisper-small's training: (a) the flash backward at
   Qwen2-VL's (H, KH) (28, 4), D 128, causal, and whisper's (12, 12), D
   64, causal and without a mask over T = S and over T = 1500, on both
   routes against the plain version's autograd at |a - b| <= TOL (1 +
   |b|) (S 1/63/64/65/129/448/1500/4096; T = 1500 at S 1/448/1500; 54
   cases), the tensor-core kernels' registers at D 64 and 128 (no
   spills), and the float32 route where a cross-attention's keys and
   values nearly agree (dq, dk, dv and E^T dk within VW_AGREE_RTOL of
   float64, relative L2); (b) the small Qwen2-VL (from embeddings with an
   image's positions) and the small whisper (with frames) against
   ``lm_train_qwen2_vl_small_golden.npz`` and
   ``lm_train_whisper_small_golden.npz`` as [22b]; (c) ``qwen2-vl-7b`` at
   every published width with 8 of its 28 layers (2.954 B parameters: 12
   bytes a parameter fit the card, the full depth's 7.62 B do not), B 2 x
   S 4096 of seeded embeddings with an image's M-RoPE positions, and
   ``whisper-small`` at full width and depth, B 16 x S 448 tokens with
   seeded frames (16, 1500, 768), bf16 seed-0 weights, 8 steps each
   through ``make_step`` with AdamW (in place) under
   ``cosine_schedule(1e-3, 1, 8)``: losses finite and falling, flash
   launches a step (16 forward and 8 backward; 72 and 36) against
   ``vw_launches``, step time, tokens/s, peak memory beside the card, a
   profiled step (idle share, flash's share, top entries); at the trained
   weights kernels vs plain in float32 (1e-4) and in bf16 by distance from
   the float32 plain route (max(1e-1, 1.25 x)); (d) the bf16 backward at
   the cells' four attention problems (Qwen2-VL's; whisper's encoder,
   cross-attention and decoder self-attention) beside its bound and
   SDPA's backward. ``phase_card()``, ``phase_build()`` and
   ``phase_vw_train()`` run it alone.

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
import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
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
    built = build.build("edge_softmax", "flash_attention",
                        "flash_attention_bwd", "rg_lru", "mlstm")
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


def _flash_inputs(g, B, H, KH, S, D, dtype, DV=None, T=None):
    """q (B, S, H, D), k (B, T, KH, D), v (B, T, KH, DV) (DV = D and
    T = S unless given): the model's layout."""
    import torch

    T = S if T is None else T
    return tuple(torch.randn(B, n, h, d, generator=g, device="cuda")
                 .to(dtype) for n, h, d in ((S, H, D), (T, KH, D),
                                            (T, KH, D if DV is None
                                             else DV)))


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
# (H, KH) of the flash sweeps: MQA and MHA at 16 heads, RecurrentGemma's
# group of 16, and the LM zoo's groups of 3 (smollm: 9 heads, not a power
# of two) and 8 (qwen2.5)
FLASH_HEADS = ((16, 1), (16, 16), (9, 3), (16, 2))
EDGE_HEADS = ((16, 1), (16, 4), (16, 16), (9, 3), (16, 2))


def _flash_tile_edges(g, causal=True, windows=EDGE_WINDOWS):
    """The bf16 kernel against the plain version at every S, T in
    EDGE_LENGTHS, window in ``windows``, (H, KH) in EDGE_HEADS, D in
    HEAD_DIMS (B 1), causal or (``causal=False``) with no mask, at the
    bf16 tolerance on the rows with a live key. A row with no live key
    (i >= T + window - 1, only when T < S) is 0 from the kernel; the
    plain version, as the reference's oracle, averages v over all keys
    there, so those rows are checked to be 0."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    tol = TOL["bfloat16"]
    n, largest, dead_rows = 0, 0.0, 0
    for S, T, W, (H, KH), D in itertools.product(
            EDGE_LENGTHS, EDGE_LENGTHS, windows, EDGE_HEADS,
            fa_ops.HEAD_DIMS):
        q = torch.randn(1, S, H, D, generator=g, device="cuda")
        k, v = (torch.randn(1, T, KH, D, generator=g, device="cuda")
                for _ in range(2))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=W)
        expect = _plain_flash(q, k, v, causal=causal, window=W)
        rows = torch.arange(S, device="cuda")
        rows = rows < T + W - 1 if W > 0 else rows >= 0
        label = (f"S={S} T={T} window={W} H={H} KH={KH} D={D} "
                 f"{'causal' if causal else 'non-causal'} bfloat16")
        err = float((out.float() - expect.float())[:, rows].abs().max())
        check(err <= tol, f"flash kernel vs plain, {label}: {err}")
        check(not out[:, ~rows].any(), f"flash rows with no live key are "
                                       f"0, {label}")
        largest = max(largest, err)
        dead_rows += int((~rows).sum())
        n += 1
    print(f"  flash bfloat16 tile edges, "
          f"{'causal' if causal else 'non-causal'}: {n} cases (S, T "
          f"{'/'.join(map(str, EDGE_LENGTHS))}, window "
          f"{'/'.join(map(str, windows))}, (H, KH) {EDGE_HEADS}, D "
          f"{fa_ops.HEAD_DIMS}), largest error {largest:.3e} (tol "
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
            for B, (H, KH), D, S, W in itertools.product(
                    (1, 2), FLASH_HEADS, (64, 256),
                    (1, 100, 2048, 3000, 4096), (0, 2048)):
                q, k, v = _flash_inputs(g, B, H, KH, S, D, dtype)
                out = fa_ops.flash_attention(q, k, v, window=W)
                expect = _plain_flash(q, k, v, window=W)
                torch.cuda.synchronize()
                check(out.shape == expect.shape and out.dtype == q.dtype,
                      "flash shapes and type")
                err = float((out.float() - expect.float()).abs().max())
                label = (f"B={B} H={H} KH={KH} D={D} S={S} window={W} "
                         f"{name}")
                check(err <= tol, f"flash kernel vs plain, {label}: {err}")
                largest = max(largest, err)
                if (B, H, KH, D, S, W) == (1, 16, 1, 256, 4096, 2048) and \
                        dtype == torch.bfloat16:
                    worst["flash_main"] = err
                n += 1
                del q, k, v, out, expect
            worst["flash"] = max(worst["flash"], largest)
            print(f"  flash {name}: {n} cases (B 1/2, (H, KH) "
                  f"{FLASH_HEADS}, D 64/256, S 1/100/2048/3000/4096, window "
                  f"0/2048), largest error {largest:.3e} (tol {tol:g}) ok")
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


def phase_lm_golden(path=None, label="[6] small RecurrentGemma",
                    prefix=""):
    """The small model of an LM golden file (an arch of the LM zoo's file
    under ``prefix``), on the card, in float32: prefill and decode logits
    against the JAX package's, and the served tokens."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import (LM_GOLDEN_PATH, cast_params,
                                           load_lm_golden)

    print(f"{label} on the card vs the JAX package's outputs (golden "
          f"file)")
    golden = load_lm_golden(path or LM_GOLDEN_PATH, prefix=prefix)
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
        if golden.embeddings is not None:  # a prefill from embeddings
            e = golden.embeddings
            cache = model.init_cache(
                B, int(e["cache_len"]),
                dtype=getattr(torch, golden.cache_dtype), device="cuda")
            le, _ = model.prefill(
                params, cache,
                embeddings=torch.as_tensor(e["inputs"], device="cuda"),
                positions=torch.as_tensor(e["positions"], device="cuda"))
            errs.append(float(np.abs(le.cpu().numpy() - e["logits"]).max()))
            print(f"  {cfg.name}: prefill from embeddings with (3, B, S) "
                  f"positions whose rows differ: logits err {errs[-1]:.3e}")
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
    hidden, _, _ = tfm.forward(params, cfg, tokens=torch.cat([toks, first], 1),
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


class _DeviceRows:
    """The card's activity in a profile, summed by name over its raw
    events (kernels, copies, memsets): what ``key_averages()`` reports
    for them, without building the profile's event tree, which over the
    some 10^5 launches of an xLSTM prefill or training step takes longer
    than the profiled work."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.rows = {}  # name -> (device us, launches)
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() == DeviceType.CUDA:
                us, count = self.rows.get(evt.name(), (0.0, 0))
                self.rows[evt.name()] = (us + evt.duration_ns() / 1e3,
                                         count + 1)


def _device_rows(prof):
    return prof if isinstance(prof, _DeviceRows) else _DeviceRows(prof)


def _top_device(prof, n=10):
    kernels = [(us, count, name)
               for name, (us, count) in _device_rows(prof).rows.items()
               if not name.startswith("Activity Buffer")]
    kernels.sort(reverse=True)
    return sum(us for us, _, _ in kernels), kernels[:n]  # n=None: all


# the port's kernels, as the profiler names them (csrc/*.cu)
PORT_KERNELS = ("rg_lru_scan_kernel", "rg_lru_scan_bwd_kernel", "flash_fwd",
                "flash_bwd", "mlstm_", "edge_softmax_fwd", "edge_softmax_bwd")
# the flash backward's three kernels, as the profiler names them
FLASH_BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")


def _device_by_name(prof, names):
    """Device time (us) and launches of the kernels whose names hold each
    of ``names``, whatever their rank."""
    out = {}
    for key, (us, count) in _device_rows(prof).rows.items():
        for name in names:
            if name in key:
                total, launches = out.get(name, (0.0, 0))
                out[name] = (total + us, launches + count)
    return out


def _port_device(prof):
    """Device time (us) and launches of each of PORT_KERNELS' entries,
    whatever their rank."""
    return _device_by_name(prof, PORT_KERNELS)


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
            prof = _DeviceRows(prof)
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

    g = torch.Generator(device="cuda").manual_seed(3)
    flash = time_flash(g, 1, 16, 1, 4096, 256, 2048)
    return {"flash": flash, "rg_lru": time_lru(g)}


def time_flash(g, B, H, KH, S, D, W, DV=None, causal=True, T=None):
    """The flash kernel at one shape in bf16 (the tensor-core route) and
    float32 (the CUDA-core route), its plain version, one SDPA call of
    the same function on each problem, and the bounds; v's head dim is
    DV (D unless given), the keys T (S unless given), and ``causal=False``
    masks nothing."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops

    DV = D if DV is None else DV
    T = S if T is None else T
    mask = dict(causal=causal, window=W)
    q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.bfloat16, DV, T)
    with torch.no_grad():
        ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, **mask), 20)
        plain = cuda_ms(lambda: _plain_flash(q, k, v, **mask), 3)
        # the float32 route (the CUDA-core kernel) at the same shape
        qf, kf, vf = (t.float() for t in (q, k, v))
        f32_ms = cuda_ms(lambda: fa_ops.flash_attention(qf, kf, vf,
                                                        **mask), 5)
        # one library call of the same function, SDPA in its own layout
        # (B, H, S, D). A window needs a boolean mask; plain causal
        # attention takes is_causal, which keeps SDPA's flash backend
        # open, and attention without a mask takes neither, on k/v
        # repeated to the query heads (the copies are not timed) and on
        # the KH heads as they are (enable_gqa); the faster of the two is
        # the library's time
        if W > 0:
            pos = torch.arange(S, device="cuda")
            rel = pos[:, None] - pos[None, :]
            how = {"attn_mask": (rel >= 0) & (rel < W)}
        else:
            how = {"is_causal": causal}

        def heads(t):
            t = t.transpose(1, 2).contiguous()
            return (t.expand(B, H, T, t.shape[-1]) if KH == 1
                    else t.repeat_interleave(H // KH, dim=1))

        def sdpa_args(q, k, v):
            return q.transpose(1, 2).contiguous(), heads(k), heads(v)

        def sdpa(q, k, v, **gqa):
            return F.scaled_dot_product_attention(q, k, v, **how, **gqa)

        def sdpa_ms(q, k, v):
            """The library's time on one problem, and which call it was."""
            args = sdpa_args(q, k, v)
            times = {"repeated": cuda_ms(lambda: sdpa(*args), 5)}
            del args
            if W == 0 and KH < H:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                times["enable_gqa"] = cuda_ms(
                    lambda: sdpa(qt, kt, vt, enable_gqa=True), 5)
            best = min(times, key=times.get)
            return times[best], best, times

        # the same on the float32 route's problem
        f32_library, _, _ = sdpa_ms(qf, kf, vf)
        del qf, kf, vf
        library, library_call, library_times = sdpa_ms(q, k, v)
        qt, ke, ve = sdpa_args(q, k, v)
        lib_err = float((sdpa(qt, ke, ve).transpose(1, 2).float()
                         - fa_ops.flash_attention(q, k, v, **mask).float())
                        .abs().max())
    check(lib_err <= TOL["bfloat16"], f"SDPA vs flash kernel: {lib_err}")
    # live (q, k) pairs per head; 2 D flops a pair for the score, 2 DV
    # for the weighted sum; q, k, v read once, the output (B, S, H, DV)
    # written once
    if causal:
        pairs = sum(min(i + 1, W, T) if W > 0 else min(i + 1, T)
                    for i in range(S))
    else:
        pairs = S * T
    flops = 2 * (D + DV) * pairs * H * B
    nbytes = q.nbytes + q.nbytes // D * DV + k.nbytes + v.nbytes
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    f32_bound = f32_bound_ms(flops, 2 * nbytes)
    attrs = fa_ops.tensor_core_attributes(D, DV)
    dims = f"D={D}" if DV == D else f"D={D} DV={DV}"
    keys = "" if T == S else f" T={T}"
    flash = {"shape": f"B={B} H={H} KH={KH} S={S}{keys} {dims} window={W}"
                      f"{'' if causal else ' non-causal'} bfloat16",
             "ms": ms, "plain_ms": plain,
             "library_ms": library, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "flops": flops, "bytes": nbytes, "pairs_per_head": pairs,
             "tflop_per_s": flops / ms / 1e9, "f32_ms": f32_ms,
             "f32_tflop_per_s": flops / f32_ms / 1e9,
             "f32_bound_ms": f32_bound, "f32_library_ms": f32_library,
             "design": fa_ops.route(q.dtype, D, DV), "attributes": attrs,
             "library_vs_kernel": lib_err,
             "library_call": (f"{next(iter(how))}, {library_call}"
                              if W > 0 or causal
                              else f"no mask, {library_call}"),
             "library_times_ms": library_times}
    print(f"  flash {flash['shape']}: kernel ({flash['design']}) {ms:.4f} "
          f"ms, plain {plain:.4f} ms, SDPA {library:.4f} ms "
          f"({flash['library_call']}: {library_times}), bound "
          f"{flash['bound_ms']:.4f} ms ({flash['bound_by']}: "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"{flash['tflop_per_s']:.1f} TFLOP/s; SDPA vs kernel "
          f"{lib_err:.2e}")
    print(f"  flash float32 route (cuda_core) at the same shape: "
          f"{f32_ms:.4f} ms, {flash['f32_tflop_per_s']:.1f} TFLOP/s; its "
          f"own bound {f32_bound:.4f} ms (operations at the float32 rate, "
          f"{F32_FLOP_PER_S / 1e12:g} TFLOP/s); SDPA on the float32 problem "
          f"{f32_library:.4f} ms")
    print(f"  flash bfloat16 kernel at {dims}: {attrs['registers']} "
          f"registers a thread, {attrs['local_bytes']} local bytes, "
          f"{attrs['static_smem_bytes'] + attrs['dynamic_smem_bytes']} "
          f"bytes of shared memory a block")
    del q, k, v, qt, ke, ve
    torch.cuda.empty_cache()
    return flash


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


# the tensor-core backward's product kernels, by their template argument
MLSTM_TC_PRODUCTS = ("cu", "dq", "dk", "dv")


def _mlstm_split(prof):
    """Device time (us) and launches of each mLSTM kernel in ``prof``,
    by the name between ``mlstm_`` and ``_kernel`` (``tc::`` before the
    tensor-core route's; a product kernel with what it computes), the
    longest first."""
    out = {}
    for key, (us, count) in _device_rows(prof).rows.items():
        found = re.search(r"(tc::)?mlstm_(\w+?)_kernel(?:<(\d+)>)?", key)
        if not found:
            continue
        name = (found.group(1) or "") + found.group(2)
        if found.group(3) is not None:
            kinds = (MLSTM_TC_PRODUCTS if found.group(2) == "dproduct_tc"
                     else ("dq", "dk", "dv"))
            name += f"<{kinds[int(found.group(3))]}>"
        total, launches = out.get(name, (0.0, 0))
        out[name] = (total + us, launches + count)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


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
    out = {name.removeprefix("tc::"): us / count / 1e3
           for name, (us, count) in _mlstm_split(prof).items()}
    if not out:
        _, top = _top_device(prof, n=None)
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


# ------------------------------------------------ the operations layer
# [17a]: the --modelplane run at the fleet tier's size, and the same
# stream at service_time_scale 0 with and without the plane
PLANE_NODES = SERVE_NODES
PLANE_ROUNDS = SERVE_DAEMON_ROUNDS
PLANE_REGISTRY = ROOT / "build" / "chip_registry"
PLANE_TIMELINE = ROOT / "build" / "chip_timeline.json"
# [17b]: two drift retrain episodes through the default retrain_fn on a
# 256-node fleet: 10 runs a type of history, then rounds of one run a
# type, one flush a round. The drift report a flush hook reads holds the
# flushes before it, so with drift_flag_flushes 5 the first retrain
# fires at the 6th flush, on a store of 256 x 6 x (10 + 6) = 24,576 rows;
# one more flush runs its canary and one its watch, whose pass re-arms
# the drift check, and the second retrain fires five flushes later, at
# the 13th, on 256 x 6 x (10 + 13) = 35,328 rows.
RETRAIN_NODES = 256
RETRAIN_FLAG_FLUSHES = 5
RETRAIN_AT = (RETRAIN_FLAG_FLUSHES + 1, 2 * RETRAIN_FLAG_FLUSHES + 3)
RETRAIN_ROUNDS = RETRAIN_AT[1] + 2
# what a retrain may leave allocated or reserved on the card (the
# returned parameters are some kilobytes; a kept graph pool, gigabytes)
RETRAIN_MEMORY_SLACK = 64 << 20
CHECKPOINT_DIR = ROOT / "build" / "chip_checkpoint"


@contextlib.contextmanager
def plane_steps():
    """The fleet service's calls that the model plane makes or waits on,
    inside the block, in order: ``flush``, ``shadow`` and ``repair``
    (``rescore`` with ``attach`` False and True), ``warm`` and ``swap``,
    each timed on the host clock between synchronisations, with the rows
    (and their ids) that a flush or a rescore returned."""
    import numpy as np
    import torch

    from repro_torch.fleet import FleetScoringService

    names = {"flush": "flush", "rescore": None, "warm": "warm",
             "swap_params": "swap"}
    real = {n: getattr(FleetScoringService, n) for n in names}
    rec = []

    def timed_call(name):
        fn = real[name]

        def wrapped(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            row = {"step": names[name] or ("repair" if kw.get("attach")
                                           else "shadow"),
                   "s": time.perf_counter() - t0}
            if name in ("flush", "rescore"):
                row["ids"] = (np.concatenate([r.row_ids
                                              for r in out.values()])
                              if out else np.empty(0, np.int64))
                row["rows"] = len(row["ids"])
            rec.append(row)
            return out

        return wrapped

    for n in names:
        setattr(FleetScoringService, n, timed_call(n))
    try:
        yield rec
    finally:
        for n, fn in real.items():
            setattr(FleetScoringService, n, fn)


def _step_ms(rec, step):
    return [round(r["s"] * 1e3, 3) for r in rec if r["step"] == step]


def _instants(tracer, name):
    return [e for e in tracer.events() if e.name == name]


def phase_plane_cli():
    """[17a] ``--daemon --modelplane --faults`` at 512 nodes x 6 rounds
    through ``launch/serve.py::main`` with ``--registry`` and
    ``--timeline``, then ``--modelplane-cmd list`` on that registry."""
    import io
    import shutil

    from repro_torch.launch import serve
    from repro_torch.obs import validate_chrome_trace_file

    shutil.rmtree(PLANE_REGISTRY, ignore_errors=True)
    argv = ["--daemon", "--modelplane", "--faults", "--nodes",
            str(PLANE_NODES), "--rounds", str(PLANE_ROUNDS), "--registry",
            str(PLANE_REGISTRY), "--timeline", str(PLANE_TIMELINE)]
    print(f"  a. serve.main({' '.join(argv)}), training included:")
    with dispatch_launches() as launches, plane_steps() as rec:
        t0 = time.perf_counter()
        out = serve.main(argv)
        wall = time.perf_counter() - t0
    st, mp, versions = out["stats"], out["modelplane"], out["versions"]
    v2, v3 = versions[1], versions[2]
    promote = _instants(out["tracer"], "modelplane.promote")
    rollback = _instants(out["tracer"], "modelplane.rollback")
    flush_ms = _step_ms(rec, "flush")
    steps = {k: _step_ms(rec, k) for k in ("shadow", "warm", "swap",
                                           "repair")}
    repair_rows = [r["rows"] for r in rec if r["step"] == "repair"]
    print(f"     {wall:.2f} s; {mp['retrains']} drift retrain(s); "
          f"{len(flush_ms)} flushes, median "
          f"{statistics.median(flush_ms):.3f} ms; canary shadow flush "
          f"{steps['shadow']} ms; warm {steps['warm']} ms; swap "
          f"{steps['swap']} ms; repair {repair_rows} rows in "
          f"{steps['repair']} ms")
    print(f"     v2 ({v2['source']}) canary: passed "
          f"{v2['verdict']['passed']}, divergence max "
          f"{v2['verdict']['divergence_max']:.3e}, latency ratio "
          f"{v2['verdict']['latency_ratio_max']:.3f}, false positives "
          f"{v2['verdict']['false_positive_rate']:.4f}; status "
          f"{[(e['version'], e['status']) for e in versions]}; "
          f"promotions {mp['promotions']}, rollbacks {mp['rollbacks']} "
          f"after {[e.args['after_flushes'] for e in rollback]} watch "
          f"flush(es), reason {[e.args['reason'] for e in rollback]}")
    _check_dispatches("--modelplane", launches, st)
    check(st["flush_failures"] == 0, "no flush failed")
    check(v2["source"] == "cli-demo" and v2["verdict"]["passed"],
          "the identical candidate passes its canary")
    check([e.args["version"] for e in promote][:1] == [2]
          and not promote[0].args["forced"],
          "the identical candidate is promoted at a flush boundary")
    check(v3["source"] == "cli-demo-bad" and v3["status"] == "rolled_back"
          and mp["rollbacks"] == 1, "the NaN candidate is rolled back")
    check(rollback[0].args["version"] == 3
          and rollback[0].args["reason"] == "nonfinite"
          and rollback[0].args["after_flushes"] == 1,
          "on the watch's first flush")
    check(repair_rows == [mp["repaired_rows"]] and repair_rows[0] > 0,
          "one repair rescore of the candidate's rows")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--modelplane-cmd", "list", "--registry",
                    str(PLANE_REGISTRY)])
    listed = buf.getvalue().splitlines()
    print(f"     --modelplane-cmd list: {listed}")
    check([x.split()[:2] for x in listed]
          == [[f"v{e['version']}", e["status"]] for e in versions],
          "the offline list prints the registry's versions")
    summary = validate_chrome_trace_file(str(PLANE_TIMELINE))
    names = [e["name"] for e in
             json.loads(PLANE_TIMELINE.read_text())["traceEvents"]]
    print(f"     --timeline: {summary}; modelplane instants "
          f"{[n for n in names if n.startswith('modelplane.')]}")
    check("modelplane.promote" in names and "modelplane.rollback" in names,
          "the timeline holds the promote and rollback instants")
    return {"wall_s": wall, "flush_ms": flush_ms, "steps_ms": steps,
            "repair_rows": repair_rows, "versions": versions, "status": mp,
            "launches": launches, "timeline": summary,
            "listed": listed,
            "median_flush_ms": statistics.median(flush_ms)}


def phase_plane_repair(golden, pre):
    """[17a] the same stream and faults at service_time_scale 0 through a
    daemon scoring with the golden model, once with the plane's sequence
    (``serve.run_modelplane_demo``) and once without: the store and every
    result equal bit for bit, the repaired rows among them."""
    import tempfile

    import numpy as np

    from repro_torch.core.model import PeronaModel
    from repro_torch.core.params import flat_params
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.fleet import (FaultPlan, FleetScoringService,
                                   IngestionDaemon, fleet_telemetry,
                                   inject_faults)
    from repro_torch.launch import serve

    machines = {f"fleet-{i}": "e2-medium" for i in range(PLANE_NODES)}
    history = SuiteRunner(seed=0).run_frame(machines, runs_per_type=10,
                                            stress_fraction=0.2)
    events, _ = inject_faults(
        fleet_telemetry(machines, rounds=PLANE_ROUNDS, runs_per_type=1,
                        seed=1, interval=1.0, jitter=0.25,
                        degraded={f"fleet-{PLANE_NODES - 1}":
                                  PLANE_ROUNDS // 2}),
        FaultPlan(seed=2, **serve.DAEMON_FAULTS))
    params = flat_params(golden.params)
    model = PeronaModel(golden.config)
    runs = {}
    for with_plane in (True, False):
        svc = FleetScoringService(model, params, pre, context_per_chain=16,
                                  device="cuda")
        svc.seed_history(history)
        daemon = IngestionDaemon(svc, capacity_rows=64 * PLANE_NODES,
                                 flush_interval=0.5, min_flush_gap=0.05,
                                 service_time_scale=0.0)
        with dispatch_launches() as launches, plane_steps() as rec, \
                tempfile.TemporaryDirectory() as reg:
            if with_plane:
                # serve_daemon's plane; the golden model flags the
                # degraded node, and a drift retrain on this 50,000-row
                # store is not what this run holds ([17b] retrains)
                plane = serve.demo_plane(svc, daemon, reg, params,
                                         retrain_fn=lambda service: None)
                serve.run_modelplane_demo(daemon, plane, params, events)
                versions = plane.registry.list_versions()
            else:
                daemon.run(events)
        runs[with_plane] = {"svc": svc, "res": daemon.results(),
                            "launches": launches, "rec": rec,
                            "stats": daemon.stats()}
    a, b = runs[True], runs[False]
    repaired = np.concatenate([r["ids"] for r in a["rec"]
                               if r["step"] == "repair"])
    rows = np.isin(a["svc"].store.row_id, repaired)
    pa, pb = a["svc"].store.anomaly, b["svc"].store.anomaly
    same_store = np.array_equal(pa, pb, equal_nan=True)
    same_results = sorted(a["res"]) == sorted(b["res"]) and all(
        len(a["res"][n]) == len(b["res"][n])
        and all(np.array_equal(getattr(x, k), getattr(y, k))
                for x, y in zip(a["res"][n], b["res"][n])
                for k in ("anomaly_prob", "codes", "type_logits",
                          "row_ids"))
        for n in b["res"])
    finite = np.isfinite(pb)
    diff = np.abs(pa[finite] - pb[finite])
    flush_sigs = sorted(a["svc"]._stack_sigs)
    out = {"repaired_rows": int(rows.sum()),
           "repaired_rows_equal": bool(np.array_equal(pa[rows], pb[rows])),
           "store_equal": bool(same_store),
           "results_equal": bool(same_results),
           "max_abs_diff": float(diff.max()) if len(diff) else 0.0,
           "rows_differing": int((pa[finite] != pb[finite]).sum()),
           "nonfinite_rows": int((~np.isfinite(pa[finite])).sum()),
           "versions": [(e["version"], e["status"]) for e in versions],
           "shadow_divergence": versions[1]["verdict"]["divergence_max"],
           "signatures": flush_sigs,
           "launches": a["launches"] + b["launches"]}
    print(f"     the same stream at service_time_scale 0, golden model, "
          f"with and without the plane: versions {out['versions']}, "
          f"shadow divergence {out['shadow_divergence']:.3e}; "
          f"{out['repaired_rows']} repaired rows equal bit for bit: "
          f"{out['repaired_rows_equal']}; store {out['store_equal']}, "
          f"results {out['results_equal']}; rows differing "
          f"{out['rows_differing']}, max |d| {out['max_abs_diff']:.3e}; "
          f"stacked signatures {flush_sigs}")
    for r in runs.values():
        _check_dispatches("repair pair", r["launches"], r["stats"])
    check(out["repaired_rows"] > 0, "the rollback repaired rows")
    check(out["nonfinite_rows"] == 0, "no NaN of the candidate is left")
    check(out["repaired_rows_equal"] and out["store_equal"]
          and out["results_equal"],
          "the repaired store equals the run without the plane bit for bit")
    return out


def phase_plane_retrain(golden, pre):
    """[17b] two drift retrain episodes through the default retrain_fn
    (a fresh model trained on the store by ``train_perona``), forced
    with drift_ewma_threshold 0.0, each followed by its canary and
    promote; the card's memory after each retrain is what it was
    before."""
    import tempfile

    import torch

    from repro_torch.core.model import PeronaModel
    from repro_torch.core.params import flat_params
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.fleet import (FleetScoringService, IngestionDaemon,
                                   ModelPlane, fleet_telemetry)
    from repro_torch.kernels.edge_softmax import ops

    machines = {f"node-{i:03d}": "e2-medium" for i in range(RETRAIN_NODES)}
    svc = FleetScoringService(PeronaModel(golden.config),
                              flat_params(golden.params), pre,
                              context_per_chain=16, device="cuda")
    svc.seed_history(SuiteRunner(seed=4).run_frame(
        machines, runs_per_type=10, stress_fraction=0.2))
    daemon = IngestionDaemon(svc, capacity_rows=8 * RETRAIN_NODES * 6,
                             flush_interval=0.5, flush_rows=1 << 30,
                             service_time_scale=0.0)
    episodes = []
    real = ModelPlane._default_retrain

    def retrain(self, service):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ep = {"rows": len(service.store), "bwd0": ops.BWD_LAUNCHES,
              "allocated0": torch.cuda.memory_allocated(),
              "reserved0": torch.cuda.memory_reserved()}
        t0 = time.perf_counter()
        out = real(self, service)
        torch.cuda.synchronize()
        ep.update(s=time.perf_counter() - t0,
                  bwd=ops.BWD_LAUNCHES - ep.pop("bwd0"),
                  peak=torch.cuda.max_memory_allocated(),
                  allocated=torch.cuda.memory_allocated(),
                  reserved=torch.cuda.memory_reserved())
        episodes.append(ep)
        return out

    ModelPlane._default_retrain = retrain
    try:
        with tempfile.TemporaryDirectory() as reg, \
                dispatch_launches() as launches:
            # a retrained model is a new model: it is meant to diverge
            # from the incumbent, so the divergence budget admits any
            # score (probabilities lie in [0, 1]); finiteness, false
            # positives and latency are gated as by default. Only a
            # non-finite output may trip the watch (the reference
            # test's min_health_shift).
            plane = ModelPlane(svc, reg, daemon=daemon, canary_flushes=1,
                               watch_flushes=1, divergence_budget=1.0,
                               min_health_shift=1.0,
                               drift_flag_flushes=RETRAIN_FLAG_FLUSHES,
                               drift_ewma_threshold=0.0, drift_min_scored=1)
            plane.bootstrap()
            daemon.run(fleet_telemetry(machines, rounds=RETRAIN_ROUNDS,
                                       runs_per_type=1, seed=5,
                                       interval=1.0, jitter=0.01))
            status = plane.status()
            versions = plane.registry.list_versions()
    finally:
        ModelPlane._default_retrain = real
    print(f"  b. {len(episodes)} drift retrain(s) on {RETRAIN_NODES} nodes, "
          f"{plane.retrain_epochs} epochs each:")
    for ep in episodes:
        n = ep["rows"]
        print(f"     the store held {n} rows; the triplet loss's c @ c.T is "
              f"4 N^2 = {4 * n * n / 1e9:.2f} GB a float32 N x N matrix; "
              f"retrain {ep['s']:.2f} s ({ep['bwd']} backward launches); "
              f"peak memory {ep['peak'] / 1e9:.2f} GB; allocated "
              f"{ep['allocated0'] / 1e6:.1f} -> {ep['allocated'] / 1e6:.1f} "
              f"MB, reserved {ep['reserved0'] / 1e6:.1f} -> "
              f"{ep['reserved'] / 1e6:.1f} MB")
    for e in versions[1:]:
        verdict = e.get("verdict") or {}
        print(f"     v{e['version']} {e['source']} {e['status']}, canary "
              f"passed {verdict.get('passed')} (divergence max "
              f"{verdict.get('divergence_max', float('nan')):.4f}, latency "
              f"ratio {verdict.get('latency_ratio_max', float('nan')):.3f})")
    print(f"     retrains {status['retrains']}, promotions "
          f"{status['promotions']}")
    _check_dispatches("retrain", launches, daemon.stats())
    check([ep["rows"] for ep in episodes]
          == [RETRAIN_NODES * 6 * (10 + k) for k in RETRAIN_AT]
          and status["retrains"] == len(RETRAIN_AT),
          "two retrains, on the 6- and the 13-round store")
    check(len(versions) == 3 and all(
        e["source"] == "drift-retrain" and e["verdict"]["passed"]
        for e in versions[1:]),
          "each retrained candidate passes its canary")
    check([e["status"] for e in versions[1:]] == ["retired", "incumbent"]
          and status["promotions"] == 2,
          "each retrained candidate is promoted")
    check(all(ep["bwd"] > 0 for ep in episodes),
          "each retrain launched the backward kernel")
    check(all(ep["allocated"] - ep["allocated0"] <= RETRAIN_MEMORY_SLACK
              and ep["reserved"] - ep["reserved0"] <= RETRAIN_MEMORY_SLACK
              for ep in episodes),
          "the card's memory after each retrain is what it was before")
    first = episodes[0]
    return {"store_rows": first["rows"], "retrain_s": first["s"],
            "peak_bytes": first["peak"],
            "backward_launches": first["bwd"], "episodes": episodes,
            "status": status, "versions": versions[1:],
            "launches": launches}


def phase_plane_checkpoint(golden):
    """[17c] ``CheckpointManager(async_save=True)``: the card's parameters
    saved, updated in place at once, then restored onto the card."""
    import shutil

    import torch

    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.core.params import flat_params

    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    params = {k: v.to("cuda") for k, v in flat_params(golden.params).items()}
    want = {k: v.clone() for k, v in params.items()}
    mgr = CheckpointManager(CHECKPOINT_DIR, async_save=True)
    t0 = time.perf_counter()
    mgr.save(1, params)
    save_s = time.perf_counter() - t0
    for v in params.values():  # the writer must hold its own copy
        v.mul_(-2.0)
    mgr.wait()
    got, meta = mgr.restore({k: torch.empty_like(v)
                             for k, v in params.items()})
    mgr.close()
    same = all(got[k].is_cuda and torch.equal(got[k], v)
               for k, v in want.items())
    print(f"  c. CheckpointManager(async_save=True): {len(params)} leaves "
          f"saved from the card in {save_s * 1e3:.2f} ms (host copy), "
          f"restored onto the card bit for bit: {same} (meta {meta})")
    check(same and sorted(got) == sorted(want),
          "the card's parameters round-trip bit for bit")
    return {"leaves": len(params), "save_ms": save_s * 1e3,
            "bit_identical": same}


def phase_model_plane(golden, pre):
    import torch

    print("[17] the operations layer: the model plane (canary, hot "
          "promote, rollback with repair, drift retrain), the registry, "
          "the timeline, the checkpoint manager")
    out = {"cli": phase_plane_cli(),
           "repair": phase_plane_repair(golden, pre),
           "retrain": phase_plane_retrain(golden, pre),
           "checkpoint": phase_plane_checkpoint(golden)}
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the configuration search
# [18]: the §IV-D configuration search (paper §IV-D/E). (a) and (b) hold
# the port to the JAX package's golden file (scout_search_golden.npz),
# (c) to the port's own sequential tuner on the host, (d) is the fleet
# sweep of benchmarks/bench_optimizer.py:151-170.
SEARCH_GOLDEN = (ROOT / "src" / "repro_torch" / "assets"
                 / "scout_search_golden.npz")
NORMAL_ULP = 32  # normals against JAX's (tests/test_torch_rng.py)
BOUNDED_ULP = 1  # the parameter grid: XLA may fuse lo + (hi - lo) * U
GRID_RTOL = 1e-13  # noise, runtime and cost grids, relative
SEARCH_BLOCK = 128
SWEEP_SEEDS = tuple(range(12))
SWEEP_DRIFTS = (("c4.large", "cpu"), ("m4.xlarge", "memory"),
                ("r4.large", "disk"))
SEARCH_REPEATS = 5
# [18f]: benchmarks/bench_workflows.py's machines
WORKFLOW_TYPES = ("e2-medium", "n1-standard-4", "n2-standard-4",
                  "c2-standard-4")
TAREMA_MACHINES = {"a": "n1-standard-4", "b": "n1-standard-4",
                   "c": "n2-standard-4", "d": "c2-standard-4",
                   "e": "e2-medium"}


def load_search_golden(path=SEARCH_GOLDEN):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _ulps(a, b) -> int:
    """Largest distance between two float64 arrays in ulps (values of
    one sign, as every grid here)."""
    import numpy as np

    a = np.ascontiguousarray(a, np.float64).view(np.int64)
    b = np.ascontiguousarray(b, np.float64).view(np.int64)
    return int(np.max(np.abs(a - b))) if a.size else 0


def _max_rel(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(a - b) / np.abs(b)))


def search_matrix(ds, seeds, conditions, condition_major=False):
    """The §IV-D scenario matrix over all 18 workloads and 4 variants:
    the healthy fleet plus ``conditions``."""
    from repro_torch.optimizer import HEALTHY, build_scenarios

    return build_scenarios(ds, seeds=tuple(seeds),
                           conditions=(HEALTHY,) + tuple(conditions),
                           condition_major=condition_major)


def golden_condition(golden):
    """The golden matrix's degraded fleet, derived by the port's store
    path (``drifted_condition``), held to the drops JAX derived."""
    import json

    from repro_torch.optimizer import drifted_condition

    meta = json.loads(str(golden["meta"]))
    cond = drifted_condition(tuple(meta["degraded_types"]),
                             name=meta["condition"])
    drop = {vm: {str(a): v for a, v in per.items()}
            for vm, per in cond.score_drop.items()}
    check(drop == json.loads(str(golden["search/drop"])),
          "the degraded fleet's score drops equal JAX's")
    return cond


def check_search_rng(golden, device):
    """[18a] threefry words and uniforms of the golden's keys bit for
    bit, normals within ``NORMAL_ULP``, the parameter grid within
    ``BOUNDED_ULP``, the noise, runtime, cost and lows grids within
    ``GRID_RTOL``; then the seeded expansion on ``device`` against the
    dataset's host tables, bit for bit."""
    import json

    import numpy as np
    import torch

    from repro_torch.common import rng
    from repro_torch.optimizer import (HEALTHY, build_scenarios,
                                       lane_spec, lane_tables)
    from repro_torch.optimizer.replay import (TABLE_NAMES, expand_seeded,
                                              seeded_inputs)
    from repro_torch.tuning.scout import (CONTENTION_SCALE, PARAM_BOUNDS,
                                          ScoutDataset)

    dev = torch.device(device)
    meta = json.loads(str(golden["meta"]))
    seed = meta["seed"]
    check(np.array_equal(rng.stream_key(seed, rng.STREAM_WORKLOAD_PARAMS),
                         golden["keys/params"])
          and np.array_equal(rng.stream_key(seed, rng.STREAM_CONTENTION),
                             golden["keys/noise"]),
          "stream keys equal JAX's")
    uids = golden["grid/uid"].astype(np.int64)
    n_w = len(golden["grid/runtime"])
    out = {}
    for name, cols in (("params", np.arange(len(PARAM_BOUNDS))),
                       ("noise", uids)):
        key = rng.as_key(golden[f"keys/{name}"], dev)
        cells = rng.fold_in(
            rng.fold_in(key, torch.arange(n_w, device=dev)).unsqueeze(1),
            torch.as_tensor(cols, device=dev))
        hi, lo = rng.random_bits(cells)
        words = torch.stack([hi, lo], -1).cpu().numpy().astype(np.uint32)
        check(np.array_equal(words, golden[f"{name}/words"]),
              f"{name}: threefry words equal JAX's bit for bit")
        check(np.array_equal(rng.uniform(cells).cpu().numpy(),
                             golden[f"{name}/uniform"]),
              f"{name}: uniforms equal JAX's bit for bit")
        out[f"{name}_draws"] = int(words.size // 2)
    normal = rng.normal(cells).cpu().numpy()
    out["normal_max_ulp"] = _ulps(normal, golden["noise/normal"])
    out["normal_differing"] = int(np.sum(normal != golden["noise/normal"]))
    lo_b = np.asarray([b[1] for b in PARAM_BOUNDS])
    hi_b = np.asarray([b[2] for b in PARAM_BOUNDS])
    bounded = rng.bounded_uniform_grid(golden["keys/params"], n_w, lo_b,
                                       hi_b, dev).cpu().numpy()
    out["bounded_max_ulp"] = _ulps(bounded, golden["params/grid"])
    noise = rng.lognormal_noise_grid(golden["keys/noise"], n_w, uids,
                                     CONTENTION_SCALE, dev).cpu().numpy()
    out["noise_max_ulp"] = _ulps(noise, golden["noise/grid"])
    ds = ScoutDataset(seed=seed, device=dev)
    rel = {"noise": _max_rel(noise, golden["noise/grid"])}
    for name in ("base_runtime", "runtime", "cost", "lows"):
        rel[name] = _max_rel(getattr(ds.grid, name), golden[f"grid/{name}"])
    out["grid_rel"] = rel
    out["grid_max_rel"] = max(rel.values())
    check(out["normal_max_ulp"] <= NORMAL_ULP,
          f"normals within {NORMAL_ULP} ulp of JAX's")
    check(out["bounded_max_ulp"] <= BOUNDED_ULP,
          f"the parameter grid within {BOUNDED_ULP} ulp of JAX's")
    check(out["grid_max_rel"] <= GRID_RTOL,
          f"noise, runtime, cost and lows grids within {GRID_RTOL} of "
          "JAX's")
    # the seeded expansion on the device against the host tables: one
    # lane a (workload, variant)
    scens = build_scenarios(ds, seeds=(0,), conditions=(HEALTHY,))
    spec = lane_spec(ds, scens, meta["scores"])
    tab = lane_tables(ds, scens, meta["scores"])
    got = expand_seeded(*seeded_inputs(spec, dev), spec.noise_scale)
    for name, t in zip(TABLE_NAMES, got):
        check(np.array_equal(t.cpu().numpy(), getattr(tab, name)),
              f"the seeded expansion's {name} equals the dataset's host "
              "table bit for bit")
    out["seeded_lanes"] = len(scens)
    return out


def check_search_jax(golden, device):
    """[18b] the port's replay of the golden's 432-lane matrix at its
    stand-in scores: picks and counts equal to JAX's in every lane,
    costs within ``GRID_RTOL``."""
    import json

    import numpy as np

    from repro_torch.optimizer import (lane_tables, replay,
                                       traces_from_result)
    from repro_torch.tuning.scout import ScoutDataset

    meta = json.loads(str(golden["meta"]))
    ds = ScoutDataset(seed=meta["seed"], device=device)
    scens = search_matrix(ds, meta["seeds"], (golden_condition(golden),))
    tab = lane_tables(ds, scens, meta["scores"])
    res = replay(tab, device=ds.device)
    picks, counts = golden["search/picks"], golden["search/counts"]
    differ = np.any(res.chosen != picks, axis=1) | (res.count != counts)
    traces = traces_from_result(tab, res, ds.configs)
    costs = np.full(picks.shape, np.nan)
    for lane, tr in enumerate(traces):
        costs[lane, :len(tr.costs)] = tr.costs
    both = np.isfinite(costs) & np.isfinite(golden["search/costs"])
    return {"lanes": len(scens), "lanes_differing": int(differ.sum()),
            "differing": np.flatnonzero(differ).tolist(),
            "cost_max_rel": _max_rel(costs[both],
                                     golden["search/costs"][both])}


def _same_trace(a, b) -> bool:
    return ([c.key for c in a.evaluated] == [c.key for c in b.evaluated]
            and a.best_valid_cost == b.best_valid_cost)


def tie_at_divergence(ds, scenario, scores, seq, got):
    """Where a replayed lane leaves its sequential trace: the round,
    both picks, and whether they are the lane's two top float32
    selection scores at most one float32 ulp apart (the replay's scores
    recomputed for that round on the dataset's device)."""
    import numpy as np
    import torch

    from repro_torch.common.mesh import shard_size
    from repro_torch.optimizer import ReplayConfig, lane_tables
    from repro_torch.optimizer.replay import (TABLE_NAMES, _to_device,
                                              selection_scores)

    cfg = ReplayConfig()
    col = {c.key: j for j, c in enumerate(ds.configs)}
    a = [col[c.key] for c in seq.evaluated]
    b = [col[c.key] for c in got.evaluated]
    k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    out = {"round": k, "sequential": a[k:k + 1], "replay": b[k:k + 1],
           "tie": False}
    if k >= min(len(a), len(b)):
        return out  # a stop decision, not a pick
    tab = lane_tables(ds, [scenario], scores, cfg)
    tables = tuple(_to_device(getattr(tab, n), ds.device)
                   for n in TABLE_NAMES)
    sel = np.full((1, cfg.max_runs), -1, np.int64)
    sel[0, :k] = a[:k]
    ei, _ = selection_scores(_to_device(sel, ds.device),
                             torch.full((1,), k, device=ds.device),
                             tables, cfg=cfg,
                             slots=shard_size(cfg.max_runs))
    ei = ei[0].cpu().numpy().astype(np.float32)
    top = np.argsort(-ei, kind="stable")[:2]
    out["top_scores"] = ei[top].tolist()
    out["tie"] = bool(sorted((a[k], b[k])) == sorted(top.tolist())
                      and np.nextafter(ei[top[1]], np.float32(np.inf))
                      >= ei[top[0]])
    return out


def phase_search_sequential(ds, scores, cond):
    """[18c] the 432-lane matrix at [15e]'s scores: the pipelined seeded
    replay against the port's sequential tuner on the host in every
    lane; the host-table, seeded and pipelined replays equal."""
    import torch

    from repro_torch.optimizer import (reference_search, replay_pipelined,
                                       replay_scenarios)

    scens = search_matrix(ds, (0, 1, 2), (cond,))
    t0 = time.perf_counter()
    piped, stats = replay_pipelined(ds, scens, scores, seeded=True,
                                    block_lanes=SEARCH_BLOCK,
                                    return_stats=True)
    piped_s = time.perf_counter() - t0
    host = replay_scenarios(ds, scens, scores)
    seeded = replay_scenarios(ds, scens, scores, seeded=True)
    check(all(_same_trace(x, y) and _same_trace(x, z)
              for x, y, z in zip(host, seeded, piped)),
          "host-table, seeded and pipelined replays pick alike")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [reference_search(ds, sc, scores) for sc in scens]
    seq_s = time.perf_counter() - t0
    diverged = [lane for lane, (a, b) in enumerate(zip(seq, piped))
                if not _same_trace(a, b)]
    ties = {lane: tie_at_divergence(ds, scens[lane], scores, seq[lane],
                                    piped[lane]) for lane in diverged}
    for lane, t in ties.items():
        sc = scens[lane]
        print(f"    lane {lane} ({sc.workload}, seed {sc.seed}, "
              f"{sc.variant}, {sc.condition.name}) leaves the sequential "
              f"trace at run {t['round']}: {t}")
    check(all(t["tie"] for t in ties.values()),
          "every lane equals the sequential tuner but at 1-ulp float32 "
          "EI ties")
    out = {"lanes": len(scens), "diverged": len(diverged),
           "ties": {str(k): v for k, v in ties.items()},
           "sequential_s": seq_s,
           "sequential_searches_per_s": len(scens) / seq_s,
           "pipelined_s": piped_s,
           "pipelined_searches_per_s": len(scens) / piped_s,
           "blocks": stats["blocks"], "table_s": stats["table_s"]}
    print(f"  c. {len(scens)} lanes at [15e]'s scores: pipelined seeded "
          f"replay (blocks of {SEARCH_BLOCK}) {piped_s:.3f} s "
          f"({out['pipelined_searches_per_s']:.1f} searches/s), "
          f"sequential tuner on the host {seq_s:.3f} s "
          f"({out['sequential_searches_per_s']:.1f} searches/s); "
          f"{len(diverged)} lanes leave the sequential trace, "
          f"{sum(t['tie'] for t in ties.values())} of them at a 1-ulp "
          "float32 tie; host-table, seeded and unpipelined replays equal")
    return out


def phase_search_sweep(ds, scores):
    """[18d] the fleet sweep (benchmarks/bench_optimizer.py:151-170):
    18 workloads x 12 seeds x 4 variants x the healthy fleet and three
    deferred drift conditions, condition-major, in blocks of 128 lanes,
    seeded and from host tables."""
    from repro_torch.optimizer import REPLAY_TRACES, drifted_condition
    from repro_torch.optimizer import replay_pipelined

    conds = tuple(drifted_condition((vm,), aspects=(aspect,), seed=i,
                                    name=f"sweep-{vm}-{aspect}",
                                    deferred=True)
                  for i, (vm, aspect) in enumerate(SWEEP_DRIFTS))
    scens = search_matrix(ds, SWEEP_SEEDS, conds, condition_major=True)
    check(len(scens) == 3456, "the sweep has 3,456 lanes")
    runs = {}
    signatures = REPLAY_TRACES.count
    for name, seeded in (("seeded_cold", True), ("host_tables", False),
                         ("seeded", True)):
        t0 = time.perf_counter()
        traces, stats = replay_pipelined(ds, scens, scores, seeded=seeded,
                                         block_lanes=SEARCH_BLOCK,
                                         return_stats=True)
        wall = time.perf_counter() - t0
        runs[name] = {"wall_s": wall, "searches_per_s": len(scens) / wall,
                      "blocks": stats["blocks"],
                      "table_s": stats["table_s"], "traces": traces}
    check(all(_same_trace(a, b) and _same_trace(a, c) for a, b, c in zip(
        runs["seeded"]["traces"], runs["host_tables"]["traces"],
        runs["seeded_cold"]["traces"])),
        "the sweep's seeded picks equal its host-table picks")
    for r in runs.values():
        del r["traces"]
    out = {"lanes": len(scens), "runs": runs,
           "new_signatures": REPLAY_TRACES.count - signatures}
    print(f"  d. fleet sweep, {len(scens)} lanes in "
          f"{runs['seeded']['blocks']} blocks: seeded "
          f"{runs['seeded']['wall_s']:.3f} s "
          f"({runs['seeded']['searches_per_s']:.1f} searches/s; first run, "
          f"deriving the 3 drift conditions, "
          f"{runs['seeded_cold']['wall_s']:.3f} s), host tables "
          f"{runs['host_tables']['wall_s']:.3f} s "
          f"({runs['host_tables']['table_s']:.3f} s building tables); "
          f"picks equal; {out['new_signatures']} new signatures")
    return out


def _profiled(fn):
    """Wall seconds, device seconds and CUDA activities (kernels and
    copies) of one call of ``fn``, which ends in a fetch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA
                and not evt.key.startswith("Activity Buffer")):
            device_us += evt.self_device_time_total
            launches += evt.count
    return wall, device_us / 1e6, launches


def phase_search_timing(ds, scores, cond):
    """[18e] one dispatch of the 432-lane seeded replay: first and
    later, its launches and idle share (profiler), one round's and the
    seeded expansion's launches, and no host sync from the first copy to
    the fetch (``set_sync_debug_mode("error")``)."""
    import statistics

    import torch

    from repro_torch.common.mesh import pad_lanes, shard_size
    from repro_torch.optimizer import (ReplayConfig, lane_spec,
                                       lane_tables, replay_async,
                                       replay_seeded,
                                       replay_seeded_async)
    from repro_torch.optimizer.replay import (_init_carry, _round,
                                              expand_seeded, seeded_inputs)

    cfg = ReplayConfig()
    scens = search_matrix(ds, (0, 1, 2), (cond,))
    spec = lane_spec(ds, scens, scores, cfg)
    tab = lane_tables(ds, scens, scores, cfg)
    dev = ds.device
    # a lane count no earlier call used: its first dispatch is cold
    lanes_floor = 1024
    t0 = time.perf_counter()
    first = replay_seeded(spec, cfg, device=dev, lanes_floor=lanes_floor)
    first_s = time.perf_counter() - t0
    later = []
    for _ in range(SEARCH_REPEATS):
        t0 = time.perf_counter()
        again = replay_seeded(spec, cfg, device=dev, lanes_floor=lanes_floor)
        later.append(time.perf_counter() - t0)
        check((again.chosen == first.chosen).all(),
              "repeated dispatches pick alike")
    later_s = statistics.median(later)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [replay_seeded_async(spec, cfg, device=dev),
                   replay_async(tab, cfg, device=dev)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    results = [p.result() for p in pending]
    check((results[0].chosen == results[1].chosen).all(),
          "seeded and host-table dispatches pick alike")
    wall, device_s, launches = _profiled(
        lambda: replay_seeded(spec, cfg, device=dev))
    lanes = shard_size(len(spec))
    grid, lane_args = seeded_inputs(spec, dev, lanes=lanes,
                                    n_conds=shard_size(len(
                                        spec.norm_scores)))
    _, _, expand_launches = _profiled(
        lambda: expand_seeded(grid, lane_args, spec.noise_scale))
    tables = expand_seeded(grid, lane_args, spec.noise_scale)
    carry = _init_carry(pad_lanes(spec.init_idx, lanes), lanes, cfg, dev)
    _, _, round_launches = _profiled(
        lambda: _round(*carry, tables, cfg=cfg,
                       slots=shard_size(cfg.max_runs)))
    out = {"lanes": len(scens), "padded": lanes, "first_s": first_s,
           "later_s": later_s, "first_searches_per_s": len(scens) / first_s,
           "later_searches_per_s": len(scens) / later_s,
           "profiled_wall_s": wall, "device_s": device_s,
           "device_idle_share": 1.0 - device_s / wall,
           "launches_per_dispatch": launches,
           "launches_expansion": expand_launches,
           "launches_per_round": round_launches,
           "rounds": cfg.max_runs - cfg.n_init,
           "no_sync_inside_dispatch": True}
    print(f"  e. one seeded dispatch of {len(scens)} lanes (padded to "
          f"{lanes}; {lanes_floor} for the timed ones): first "
          f"{first_s * 1e3:.1f} ms, later {later_s * 1e3:.1f} ms (median of "
          f"{SEARCH_REPEATS}; {out['later_searches_per_s']:.1f} searches/s);"
          f" profiled {wall * 1e3:.1f} ms wall, {device_s * 1e3:.2f} ms of "
          f"device activity, idle share {out['device_idle_share']:.4f}, "
          f"{launches} launches and copies a dispatch ({expand_launches} "
          f"in the seeded expansion, {round_launches} a round x "
          f"{out['rounds']}); no host sync from the first copy to the "
          "fetch under set_sync_debug_mode('error')")
    return out


def phase_search_workflows():
    """[18f] §IV-E as benchmarks/bench_workflows.py prints it: the
    Lotaru table and the Tarema grouping on calibrated machine scores
    of the four GCP types (10 runs a type, 40 epochs on the card)."""
    import numpy as np

    from repro_torch.tuning import lotaru, tarema
    from repro_torch.tuning.perona_weights import (
        calibrate_scores, fingerprint_machine_scores)

    t0 = time.perf_counter()
    scores, proxies = fingerprint_machine_scores(
        WORKFLOW_TYPES, runs_per_type=10, epochs=40,
        return_calibration=True)
    train_s = time.perf_counter() - t0
    cal = calibrate_scores(scores, proxies)
    tab = lotaru.evaluate_predictors(cal)
    rows = []
    for method in ("naive", "online_m", "online_p", "lotaru", "perona"):
        for stat in ("median", "p90", "p95"):
            rows.append((f"tableIII.{method}.{stat}",
                         f"{tab[method][stat]:.4f}"))
    same = tarema.same_grouping(
        tarema.groups_from_microbenchmarks(TAREMA_MACHINES),
        tarema.groups_from_perona(TAREMA_MACHINES, cal))
    rows.append(("tarema.same_groups", str(same)))
    print(f"  f. §IV-E on calibrated scores of {len(WORKFLOW_TYPES)} GCP "
          f"types (training {train_s:.2f} s):")
    for name, value in rows:
        print(f"    {name},,{value}")
    check(all(np.isfinite(tab[m][s]) for m in tab for s in tab[m]),
          "the Lotaru table is finite")
    claims = {
        "lotaru_beats_naive": tab["lotaru"]["median"] < tab["naive"]["median"],
        "perona_beats_naive": tab["perona"]["median"] < tab["naive"]["median"],
        "perona_within_2x_lotaru": (tab["perona"]["median"]
                                    < 2.0 * tab["lotaru"]["median"] + 0.02),
        "tarema_same_groups": same}
    print(f"    the paper's claims (tests/test_tuning.py): {claims}")
    check(all(claims.values()), f"the paper's §IV-E claims hold: {claims}")
    return {"train_s": train_s, "table": tab, "claims": claims}


def phase_search(scores):
    import torch

    from repro_torch.tuning.scout import ScoutDataset

    print("[18] the configuration search: scout draws on threefry, "
          "CherryPick and Arrow with Perona's weighting, the batched "
          "float64 replay, Lotaru and Tarema")
    golden = load_search_golden()
    rng_out = check_search_rng(golden, "cuda")
    print(f"  a. threefry words and uniforms bit for bit "
          f"({rng_out['params_draws']} parameter and "
          f"{rng_out['noise_draws']} noise draws); normals "
          f"{rng_out['normal_differing']} differ, max "
          f"{rng_out['normal_max_ulp']} ulp (limit {NORMAL_ULP}); "
          f"parameter grid max {rng_out['bounded_max_ulp']} ulp (limit "
          f"{BOUNDED_ULP}); noise grid max {rng_out['noise_max_ulp']} ulp; "
          f"grids max relative {rng_out['grid_max_rel']:.3e} (limit "
          f"{GRID_RTOL}); the seeded expansion equals the dataset's "
          f"tables bit for bit ({rng_out['seeded_lanes']} lanes)")
    jax_out = check_search_jax(golden, "cuda")
    print(f"  b. {jax_out['lanes']} lanes at the stand-in scores: "
          f"{jax_out['lanes_differing']} differ from JAX's picks and "
          f"counts; costs max relative {jax_out['cost_max_rel']:.3e}")
    check(jax_out["lanes_differing"] == 0,
          f"every lane picks what JAX picked ({jax_out['differing']})")
    check(jax_out["cost_max_rel"] <= GRID_RTOL,
          f"costs within {GRID_RTOL} of JAX's")
    ds = ScoutDataset(seed=0, device="cuda")
    cond = golden_condition(golden)
    out = {"rng": rng_out, "jax": jax_out,
           "sequential": phase_search_sequential(ds, scores, cond),
           "sweep": phase_search_sweep(ds, scores),
           "timing": phase_search_timing(ds, scores, cond),
           "workflows": phase_search_workflows()}
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the LM zoo (phase [19])
ZOO_ARCHS = ("smollm-135m", "qwen2.5-3b", "olmo-1b", "gemma3-4b",
             "granite-moe-1b-a400m")
ZOO_PROFILED = ("smollm-135m", "qwen2.5-3b")
# the flash kernel at the zoo's attention shapes, (H, KH, D, window):
# smollm, qwen2.5, olmo, gemma3's local and global layers, granite, and
# Qwen2-VL's group of 7
ZOO_FLASH = ((9, 3, 64, 0), (16, 2, 128, 0), (16, 16, 128, 0),
             (8, 4, 256, 1024), (8, 4, 256, 0), (16, 8, 64, 0),
             (28, 4, 128, 0))
ZOO_FLASH_S = (1, 100, 2048, 3000, 4096)
# the timed D = 128 shape, (B, H, KH, S, D, window): qwen2.5-3b's prefill
ZOO_D128 = (1, 16, 2, 4096, 128, 0)
# MoE decode vs the no-cache forward: decode steps after a prefill that
# dropped no routing choice, at positions before the forward's first drop
MOE_DECODE_STEPS = 8


def phase_zoo_kernels():
    """(a) The flash kernel at the zoo's shapes, both routes, against the
    plain version at the kernel tolerances."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol, largest, n = TOL[name], 0.0, 0
            for (H, KH, D, W), S in itertools.product(ZOO_FLASH,
                                                      ZOO_FLASH_S):
                q, k, v = _flash_inputs(g, 1, H, KH, S, D, dtype)
                out = fa_ops.flash_attention(q, k, v, window=W)
                expect = _plain_flash(q, k, v, window=W)
                err = float((out.float() - expect.float()).abs().max())
                label = f"H={H} KH={KH} D={D} S={S} window={W} {name}"
                check(out.shape == expect.shape and out.dtype == dtype,
                      f"flash shapes and type, {label}")
                check(err <= tol, f"flash kernel vs plain, {label}: {err}")
                largest = max(largest, err)
                if (1, H, KH, S, D, W) == ZOO_D128 and name == "bfloat16":
                    worst["d128_main"] = err
                n += 1
                del q, k, v, out, expect
            worst[name] = largest
            print(f"  flash {name} at the zoo's shapes: {n} cases ((H, KH, "
                  f"D, window) {ZOO_FLASH}, S {ZOO_FLASH_S}), largest error "
                  f"{largest:.3e} (tol {tol:g}) ok")
    attrs = fa_ops.tensor_core_attributes(128)
    print(f"  tensor_core_attributes(128): {attrs}")
    worst["d128_attributes"] = attrs
    torch.cuda.empty_cache()
    return worst


def _moe_decode_check(model, params, prompt, cache_dtype, tol, label,
                      stash=None):
    """Decode after prefill vs the no-cache forward for an MoE model,
    where a forward over more tokens may drop routing choices that a
    decode step (one token, never past capacity) keeps: the forward over
    ``prompt`` finds its first position with a dropped choice in any
    layer, f; the longest prefix p0 below f - MOE_DECODE_STEPS whose
    prefill drops no choice is prefilled (halving until none drops), and
    decode steps fed the prompt's next tokens are held to the forward's
    logits at positions p0 .. p0 + MOE_DECODE_STEPS - 1, all before f.
    A dict ``stash`` receives the positions and both sets of logits (on
    the host)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    t0 = time.perf_counter()
    toks = torch.as_tensor(prompt, device="cuda").long()[None]
    N = toks.shape[1]
    with moe.record_keep() as keeps:
        hidden, _, _ = tfm.forward(params, cfg, tokens=toks, skip_unembed=True)
    kept = torch.stack([k[0].all(-1) for k in keeps]).all(0)  # (N,)
    dropped = int(sum(int((~k).sum()) for k in keeps))
    bad = (~kept).nonzero()
    first = int(bad[0]) if len(bad) else N
    p0 = max(1, first - MOE_DECODE_STEPS)
    while True:
        cache = model.init_cache(1, FULL_MAX_LEN, dtype=cache_dtype,
                                 device="cuda")
        with moe.record_keep() as pkeeps:
            model.prefill(params, cache, tokens=toks[:, :p0])
        prefill_drops = int(sum(int((~k).sum()) for k in pkeeps))
        if prefill_drops == 0 or p0 == 1:
            break
        p0 = max(1, p0 // 2)
    check(prefill_drops == 0, f"{label}: a prefill without drops")
    steps = min(MOE_DECODE_STEPS, first - p0, N - p0)
    got = []
    for i in range(steps):
        with moe.record_keep() as dkeeps:
            ld, cache = model.decode_step(
                params, toks[:, p0 + i:p0 + i + 1],
                torch.tensor([p0 + i], device="cuda"), cache)
        check(all(bool(k.all()) for k in dkeeps),
              f"{label}: a decode step keeps every choice")
        got.append(ld[0])
    del cache
    want = tfm.unembed(params, cfg, hidden[:, p0:p0 + steps])[0]
    got = torch.stack(got)
    check(bool(torch.isfinite(got).all()), "finite decode logits")
    err = _rel(got, want)
    if stash is not None:
        stash.update(p0=p0, steps=steps, decode=got.float().cpu(),
                     forward=want.float().cpu())
    print(f"  {label}: the forward over {N} tokens dropped {dropped} "
          f"choices, the first at position {first}; prefill of {p0} tokens "
          f"(0 dropped), {steps} decode steps vs the forward at positions "
          f"{p0}..{p0 + steps - 1}: max err {err[0]:.3e} of max |logit| "
          f"{err[1]:.1f}, relative L2 {err[2]:.2e} (tol {tol:g}); "
          f"{time.perf_counter() - t0:.1f} s")
    return {"err": err, "forward_dropped": dropped, "first_drop": first,
            "prefill_len": p0, "steps": steps}


ROUTER_REPEATS = 20


def _router_repeats(params, cfg):
    """The router's top-k on the card at a 4096-token prefill's shape, the
    first layer's weights: 20 launches give the same ids and weights bit
    for bit, with the weights as drawn and with every odd expert's column
    a copy of the even one before it (every token then meets ties), where
    each pair must come lower index first, as ``jax.lax.top_k`` orders
    it."""
    import torch

    from repro_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(1, 4096, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)
    w = params["body"][0]["moe"]["router"]["w"][0]
    tied = w.clone()
    tied[:, 1::2] = tied[:, 0::2]
    out = {}
    for name, weights in (("drawn", w), ("tied", tied)):
        p = {"router": {"w": weights}}
        first_w, first_ids, _ = moe.router_topk(p, cfg.moe, x)
        same = all(
            torch.equal(first_ids, ids) and torch.equal(first_w, wts)
            for wts, ids, _ in (moe.router_topk(p, cfg.moe, x)
                                for _ in range(ROUTER_REPEATS - 1)))
        check(same, f"router top-k, {name} weights: {ROUTER_REPEATS} "
                    f"launches bit for bit")
        if name == "tied":
            check(bool((first_ids[..., 0::2] % 2 == 0).all()
                       and (first_ids[..., 1::2]
                            == first_ids[..., 0::2] + 1).all()),
                  "tied experts come lower index first")
        out[name] = same
    print(f"    router top-k at (1, 4096, {cfg.d_model}): {ROUTER_REPEATS} "
          f"launches give the same ids and weights bit for bit, with the "
          f"drawn weights and with every expert tied to a neighbour (each "
          f"pair lower index first): {out}")
    return out


def _prefill_drops(keeps):
    """{prompt length: routing choices dropped over its prefill's
    layers} from ``moe.record_keep``'s masks of a serving run (decode
    steps, one token a row, never drop)."""
    out = {}
    for k in keeps:
        if k.shape[1] > 1:
            out[k.shape[1]] = out.get(k.shape[1], 0) + int((~k).sum())
    return out


def _decode_vs_f32(model32, params32, prompt, stash, label):
    """The bf16 decode's and the bf16 no-cache forward's logits of
    ``_moe_decode_check`` (``stash``), each against the float32 plain
    route's forward at the same positions: whether the absorbed decode,
    which takes the q.k product through the 512-wide latent, leaves the
    bf16 model further from float32 than the forward does."""
    import torch

    from repro_torch.models import transformer as tfm

    toks = torch.as_tensor(prompt, device="cuda").long()[None]
    p0, steps = stash["p0"], stash["steps"]
    with plain_versions():
        hidden, _, _ = tfm.forward(params32, model32.cfg, tokens=toks,
                                   skip_unembed=True)
    ref = tfm.unembed(params32, model32.cfg, hidden[:, p0:p0 + steps])[0]
    del hidden
    out = {name: _rel(stash[name].to(ref.device), ref)
           for name in ("decode", "forward")}
    print(f"  {label}: at positions {p0}..{p0 + steps - 1}, against the "
          f"float32 plain route's forward: bf16 decode relative L2 "
          f"{out['decode'][2]:.2e}, bf16 forward {out['forward'][2]:.2e} "
          f"(measured, not gated)")
    return out


def _float32_in_place(tree):
    """The tree with every leaf in float32 on the card, converted one leaf
    at a time, largest first: a model of 31.4 GB in bf16 (62.8 GB in
    float32) never holds both copies. The bf16 leaves wait on the host
    first, so that the card starts empty: a bf16 init leaves its segments
    shared with the float32 draws it rounded, and at DeepSeek-V2-Lite's
    size 27 GB of them stayed reserved but unusable. Where the card has
    room for the float32 copy beside the bf16 weights (every arch but
    DeepSeek), the leaves stay on it."""
    import torch

    # (node, key) of every leaf, found by a loop: a recursive closure
    # would keep this list, and the weights, alive in a reference cycle
    # past the return
    slots, stack = [], [tree]
    while stack:
        node = stack.pop()
        for key in (node if isinstance(node, dict) else range(len(node))):
            if isinstance(node[key], torch.Tensor):
                slots.append((node, key))
            else:
                stack.append(node[key])
    slots.sort(key=lambda nk: -nk[0][nk[1]].numel())
    device = slots[0][0][slots[0][1]].device
    torch.cuda.empty_cache()
    f32_bytes = 4 * sum(node[key].numel() for node, key in slots)
    if f32_bytes > torch.cuda.mem_get_info(device)[0]:
        for node, key in slots:
            node[key] = node[key].cpu()
        torch.cuda.empty_cache()
    for node, key in slots:
        node[key] = node[key].to(device).float()
        torch.cuda.empty_cache()  # the bf16 copy's segment
    return tree


def phase_zoo_full(arch, extra=None):
    """(c) One arch of the zoo at full width, bf16, weights from seed 0 on
    the card, serving eight requests through SlotServer; then the same
    weights in float32 for the sharp checks. ``extra(model, params, tol,
    label)``, where given, adds the arch's own checks on each type's
    weights."""
    import contextlib as ctx
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import SlotServer, make_requests
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch)
    is_moe = any(k in tfm.MOE_KINDS for k in cfg.layer_kinds)
    print(f"  {cfg.name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, H {cfg.n_heads} / KH {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
             if is_moe else ""))
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"    weights: {n_params / 1e9:.3f} B parameters, "
          f"{n_bytes / 1e9:.2f} GB on the card, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    n_attn = sum(k in tfm.ATTN_KINDS + tfm.MLA_KINDS
                 for k in cfg.layer_kinds)
    requests = make_requests(len(FULL_LENGTHS), cfg.vocab_size,
                             FULL_MAX_NEW, seed=0, lengths=FULL_LENGTHS)
    server = SlotServer(model, params, n_slots=FULL_SLOTS,
                        max_len=FULL_MAX_LEN)
    warm = make_requests(1, cfg.vocab_size, 2, seed=1, lengths=(64,))
    SlotServer(model, params, n_slots=FULL_SLOTS,
               max_len=FULL_MAX_LEN).serve(warm)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record = moe.record_keep() if is_moe else ctx.nullcontext([])
    fa_ops.LAUNCHES = 0  # this arch's serving path starts here
    t0 = time.perf_counter()
    with record as keeps:
        out = server.serve(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_ops.LAUNCHES  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    done = sorted(out["completed"], key=lambda r: r.rid)
    check(len(done) == len(FULL_LENGTHS), f"{arch}: every request completed")
    check(all(len(r.tokens) == FULL_MAX_NEW for r in done),
          f"{arch}: every request got {FULL_MAX_NEW} tokens")
    check(launches == n_attn * len(FULL_LENGTHS),
          f"{arch}: {launches} flash launches, expected {n_attn} per "
          f"prefill x {len(FULL_LENGTHS)}")
    prompt_tokens = sum(FULL_LENGTHS)
    prefill_s = sum(r.prefill_s for r in done)
    row = {
        "arch": arch, "parameters": n_params, "weight_bytes": n_bytes,
        "requests": len(done), "prompt_tokens": prompt_tokens,
        "decode_steps": out["decode_steps"], "wall_s": wall,
        "ttft_s": {len(r.prompt): r.ttft_s for r in done},
        "prefill_latency_s": {len(r.prompt): r.prefill_s for r in done},
        "prefill_tokens_per_s": prompt_tokens / prefill_s,
        "decode_tokens": server.decode_tokens, "decode_s": server.decode_s,
        "decode_tokens_per_s": server.decode_tokens / server.decode_s,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_prefill": n_attn,
    }
    print(f"    served {len(done)} requests x {FULL_MAX_NEW} tokens in "
          f"{wall:.2f} s, {out['decode_steps']} decode steps; flash launches "
          f"{launches} ({n_attn} per prefill)")
    print("    TTFT (from arrival): " + ", ".join(
        f"S={s} {t * 1e3:.1f} ms" for s, t in row["ttft_s"].items()))
    print("    prefill latency: " + ", ".join(
        f"S={s} {t * 1e3:.1f} ms"
        for s, t in row["prefill_latency_s"].items()))
    print(f"    prefill {row['prefill_tokens_per_s']:.0f} tokens/s; decode "
          f"{row['decode_tokens_per_s']:.1f} tokens/s ({server.decode_tokens}"
          f" tokens in {server.decode_s:.2f} s, {FULL_SLOTS} slots); peak "
          f"memory {peak / 1e9:.2f} GB")
    if is_moe:
        row["prefill_drops"] = _prefill_drops(keeps)
        row["router_repeats"] = _router_repeats(params, cfg)
        n_moe = sum(k in tfm.MOE_KINDS for k in cfg.layer_kinds)
        print(f"    routing choices dropped per prefill (of S x "
              f"{cfg.moe.top_k} x {n_moe}): "
              + ", ".join(f"S={s} {n}"
                          for s, n in row["prefill_drops"].items()))
        del keeps

    by_len = {len(r.prompt): r for r in done}
    ring_req = by_len[FULL_RING_LENGTH]
    checks = {}
    with torch.inference_mode():
        for length in FULL_CHECK_LENGTHS:
            toks = torch.as_tensor(by_len[length].prompt, device="cuda")
            logits, _ = model.prefill(
                params, model.init_cache(1, FULL_MAX_LEN, device="cuda"),
                tokens=toks.long()[None])
            check(int(logits.argmax()) == by_len[length].tokens[0],
                  f"{arch}: a prefill of the served prompt gives the "
                  f"served token")
        checks["bf16_kernels_vs_plain"] = _kernels_vs_plain(
            model, params, [by_len[n].prompt for n in FULL_CHECK_LENGTHS],
            FULL_BF16_REL_TOL, f"  {arch} bf16")
        stash = {} if cfg.mla is not None else None
        if is_moe:
            checks["bf16_decode"] = _moe_decode_check(
                model, params, ring_req.prompt, torch.bfloat16,
                FULL_BF16_REL_TOL, f"  {arch} bf16 MoE decode check",
                stash=stash)
            err = checks["bf16_decode"]["err"]
        else:
            err = checks["bf16_decode"] = _ring_check(
                model, params, ring_req, torch.bfloat16, FULL_BF16_REL_TOL,
                f"  {arch} bf16 ring check")
        check(err[2] <= FULL_BF16_REL_TOL, f"{arch}: bf16 decode check")
        if arch in ZOO_PROFILED:
            row["profile"] = profile_lm(model, params, server,
                                        by_len[4096])
        if extra is not None:
            checks.update(extra(model, params, FULL_BF16_REL_TOL, "bf16"))
        del server
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = build_model(cfg32)
        params32 = _float32_in_place(params)
        del params
        torch.cuda.empty_cache()
        checks["f32_kernels_vs_plain"] = _kernels_vs_plain(
            model32, params32, [by_len[FULL_CHECK_LENGTHS[0]].prompt],
            FULL_F32_REL_TOL, f"  {arch} f32")
        if is_moe:
            checks["f32_decode"] = _moe_decode_check(
                model32, params32, ring_req.prompt, torch.float32,
                FULL_F32_REL_TOL, f"  {arch} f32 MoE decode check")
            err = checks["f32_decode"]["err"]
        else:
            err = checks["f32_decode"] = _ring_check(
                model32, params32, ring_req, torch.float32,
                FULL_F32_REL_TOL, f"  {arch} f32 ring check")
        check(err[2] <= FULL_F32_REL_TOL, f"{arch}: f32 decode check")
        if stash:
            checks["bf16_decode_vs_f32"] = _decode_vs_f32(
                model32, params32, ring_req.prompt, stash,
                f"  {arch} bf16 absorbed decode")
        if extra is not None:
            checks.update(extra(model32, params32, FULL_F32_REL_TOL, "f32"))
        del params32
    torch.cuda.empty_cache()
    row["checks"] = {k: ({str(s): e for s, e in v.items()}
                         if isinstance(v, dict) and k.endswith("plain")
                         else v)
                     for k, v in checks.items()}
    return row, launches


def phase_zoo():
    import torch

    from repro_torch.models.params import LM_ZOO_GOLDEN_PATH

    print(f"[19] the LM zoo's dense and MoE decoders: {', '.join(ZOO_ARCHS)}"
          f"; the flash kernel at their shapes (head dim 128 new), the small "
          f"models vs the JAX package's outputs, each at full width serving "
          f"{len(FULL_LENGTHS)} requests (prompts {FULL_LENGTHS}, "
          f"{FULL_SLOTS} slots, max_new {FULL_MAX_NEW})")
    out = {"kernel_errors": phase_zoo_kernels()}
    out["golden"] = {
        arch: phase_lm_golden(LM_ZOO_GOLDEN_PATH, f"  small {arch}",
                              prefix=f"{arch}/")
        for arch in ZOO_ARCHS}
    out["full"], out["launches"] = {}, {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        out["full"][arch], out["launches"][arch] = phase_zoo_full(arch)
        out["full"][arch]["seconds"] = time.perf_counter() - t0
        print(f"    -- {arch}: {out['full'][arch]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    print("  (d) the flash kernel at head dim 128 (CUDA events after "
          "warm-up)")
    g = torch.Generator(device="cuda").manual_seed(5)
    out["d128"] = time_flash(g, *ZOO_D128)
    return out


# ------------------------------- the MLA and M-RoPE decoders (phase [20])
MLA_ARCHS = ("deepseek-v2-lite-16b", "qwen2-vl-7b")
# the flash kernel at their attention shapes, (H, KH, D, DV): DeepSeek's
# prefill (latent attention, q/k 128 + 64 wide, v 128), Qwen2-VL's group
# of 7, and the small DeepSeek's (16 + 8, 16), which the float32 route
# alone takes (the tensor-core route refuses it)
MLA_FLASH = ((16, 16, 192, 128), (28, 4, 128, 128), (4, 4, 24, 16))
MLA_FLASH_S = ZOO_FLASH_S
# the tile edges at (192, 128), with the (H, KH) of phase [5] and
# Qwen2-VL's (28, 4); (28, 4) also at (128, 128)
MLA_EDGE_PAIRS = (((192, 128), EDGE_HEADS + ((28, 4),)),
                  ((128, 128), ((28, 4),)))
# the timed (192, 128) shape, (B, H, KH, S, D, window, DV): DeepSeek's
# 4096-token prefill
MLA_TIMED = (1, 16, 16, 4096, 192, 0, 128)
# Qwen2-VL's image prompt: 32 text tokens, a 64 x 64 patch grid merged
# 2 x 2 into 32 x 32 tokens (t fixed, h and w along the grid), then text
# from the largest position + 1 on all three rows, to 4096 tokens
VL_TEXT_BEFORE = 32
VL_GRID = 64
VL_MERGE = 2
VL_PROMPT = 4096


def vl_positions(n_before, grid, merge, length):
    """(3, length) M-RoPE positions of a prompt of ``n_before`` text
    tokens, one image of ``grid`` x ``grid`` patches merged ``merge`` x
    ``merge``, and text to ``length`` tokens, as Qwen2-VL's
    ``get_rope_index`` lays them out."""
    import torch

    side = grid // merge
    text = torch.arange(n_before).expand(3, -1)
    hh, ww = torch.meshgrid(torch.arange(side), torch.arange(side),
                            indexing="ij")
    image = n_before + torch.stack([torch.zeros_like(hh).flatten(),
                                    hh.flatten(), ww.flatten()])
    start = n_before + side
    after = start + torch.arange(length - n_before - side * side)
    return torch.cat([text, image, after.expand(3, -1)], 1)


def lm_train_batch(cfg, B, S, seed=0, device="cuda",
                   image=(VL_TEXT_BEFORE, VL_GRID, VL_MERGE)):
    """The training batch of ``cfg``'s family, with the keys, shapes and
    types of the reference's ``Model.input_specs(ShapeConfig(..., S, B,
    "train"))``, drawn on ``device`` from ``seed``: labels (B, S) int32
    over the vocabulary; for a "vlm" embeddings (B, S, d_model) of the
    stub frontend in the compute type and (3, B, S) int32 M-RoPE
    positions of an image, row b laid out as ``vl_positions(n_before +
    3 b, grid, merge, S)`` for ``image = (n_before, grid, merge)``;
    otherwise tokens (B, S) int32, and for "audio" the stub frontend's
    frames (B, n_audio_frames, d_model) in the compute type."""
    import torch

    from repro_torch.models.transformer import compute_dtype

    g = torch.Generator(device=device).manual_seed(seed)
    dtype = compute_dtype(cfg)

    def ints(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device=device, dtype=torch.int32)

    batch = {"labels": ints(B, S)}
    if cfg.family == "vlm":
        batch["embeddings"] = torch.randn(B, S, cfg.d_model, generator=g,
                                          device=device).to(dtype)
        n_before, grid, merge = image
        batch["positions"] = torch.stack(
            [vl_positions(n_before + 3 * b, grid, merge, S)
             for b in range(B)], 1).to(device=device, dtype=torch.int32)
    else:
        batch["tokens"] = ints(B, S)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                      generator=g, device=device).to(dtype)
    return batch


def _mla_tile_edges(g):
    """The bf16 kernel against the plain version at the tile edges of
    ``_flash_tile_edges``, at the pairs and (H, KH) of MLA_EDGE_PAIRS."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    tol = TOL["bfloat16"]
    n, largest = 0, 0.0
    for (D, DV), heads in MLA_EDGE_PAIRS:
        for S, T, W, (H, KH) in itertools.product(
                EDGE_LENGTHS, EDGE_LENGTHS, EDGE_WINDOWS, heads):
            q = torch.randn(1, S, H, D, generator=g, device="cuda")
            k = torch.randn(1, T, KH, D, generator=g, device="cuda")
            v = torch.randn(1, T, KH, DV, generator=g, device="cuda")
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            out = fa_ops.flash_attention(q, k, v, window=W)
            expect = _plain_flash(q, k, v, window=W)
            rows = torch.arange(S, device="cuda")
            rows = rows < T + W - 1 if W > 0 else rows >= 0
            label = f"S={S} T={T} window={W} H={H} KH={KH} D={D} DV={DV}"
            check(out.shape == (1, S, H, DV), f"flash shape, {label}")
            err = float((out.float() - expect.float())[:, rows].abs().max())
            check(err <= tol, f"flash kernel vs plain, {label}: {err}")
            check(not out[:, ~rows].any(),
                  f"flash rows with no live key are 0, {label}")
            largest = max(largest, err)
            n += 1
    print(f"  flash bfloat16 tile edges at (D, DV) (192, 128) and "
          f"(128, 128): {n} cases (S, T {'/'.join(map(str, EDGE_LENGTHS))},"
          f" window 0/1/64/65, (H, KH) {MLA_EDGE_PAIRS[0][1]} and (28, 4)),"
          f" largest error {largest:.3e} (tol {tol:g}) ok")
    return largest, n


def phase_mla_kernels():
    """(a) The flash kernel at the MLA and M-RoPE decoders' shapes, both
    routes where the route takes the pair, against the plain version at
    the kernel tolerances; the tile edges at (192, 128); the (192, 128)
    kernel's resources and time."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol, largest, n = TOL[name], 0.0, 0
            for (H, KH, D, DV), S in itertools.product(MLA_FLASH,
                                                       MLA_FLASH_S):
                q, k, v = _flash_inputs(g, 1, H, KH, S, D, dtype, DV)
                label = f"H={H} KH={KH} D={D} DV={DV} S={S} {name}"
                if (D, DV) not in fa_ops.PAIRS[fa_ops.route(dtype, 16)]:
                    try:
                        fa_ops.flash_attention(q, k, v)
                    except ValueError as e:
                        check(f"({D}, {DV})" in str(e),
                              f"the refusal names the pair, {label}")
                    else:
                        check(False, f"flash refuses {label}")
                    continue
                out = fa_ops.flash_attention(q, k, v)
                expect = _plain_flash(q, k, v)
                err = float((out.float() - expect.float()).abs().max())
                check(out.shape == (1, S, H, DV) and out.dtype == dtype,
                      f"flash shapes and type, {label}")
                check(err <= tol, f"flash kernel vs plain, {label}: {err}")
                largest = max(largest, err)
                if (1, H, KH, S, D, 0, DV) == MLA_TIMED:
                    worst[f"{name}_main"] = err
                n += 1
                del q, k, v, out, expect
            worst[name] = largest
            print(f"  flash {name} at the MLA and M-RoPE shapes: {n} cases "
                  f"((H, KH, D, DV) {MLA_FLASH}, S {MLA_FLASH_S}; the "
                  f"tensor-core route refuses (24, 16) with a ValueError "
                  f"naming the pair), largest error {largest:.3e} (tol "
                  f"{tol:g}) ok")
        worst["edges"], worst["edge_cases"] = _mla_tile_edges(g)
    torch.cuda.empty_cache()
    print("  the flash kernel at (192, 128), DeepSeek-V2-Lite's 4096-token "
          "prefill (CUDA events after warm-up)")
    worst["timing"] = time_flash(g, *MLA_TIMED)
    worst["sdpa_backend"] = _sdpa_backend(g, *MLA_TIMED)
    return worst


def _sdpa_backend(g, B, H, KH, S, D, W, DV, causal=True, T=None):
    """Which of SDPA's backends a call on the timed problem (causal, or
    with no mask) runs: the backends whose output, when each alone is
    allowed, equals the default call's bit for bit, and each backend's
    time (None where it refuses the problem, as FlashAttention-2 refuses
    unequal q and v head dims). (The profiler records no kernel in a
    short session this late in the run.)"""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (t.transpose(1, 2).contiguous() for t in _flash_inputs(
        g, B, H, KH, S, D, torch.bfloat16, DV, T))
    check(W == 0 and H == KH, "the backend probe takes MHA without a "
                              "window")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    times, ran = {}, []
    with torch.no_grad(), warnings.catch_warnings():
        # SDPA warns of each backend that refuses the problem
        warnings.simplefilter("ignore", UserWarning)
        default = sdpa()
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(backend):
                    same = torch.equal(sdpa(), default)
                    times[backend.name] = cuda_ms(sdpa, 5)
            except RuntimeError:
                times[backend.name] = None
                continue
            if same:
                ran.append(backend.name)
    print(f"  SDPA at B={B} S={S} T={T or S} D={D} DV={DV} "
          f"{'causal' if causal else 'non-causal'}: the default call "
          f"equals {ran} bit for bit; each backend alone, ms (None: "
          f"refused): {times}")
    del q, k, v, default
    return {"default_equals": ran, "backend_ms": times}


def _vl_checks(model, params, tol, label):
    """Qwen2-VL's own checks: a 4096-token prefill from seeded embeddings
    with the image layout's (3, 1, S) positions, kernels vs plain; and the
    same embeddings with three equal position rows against (1, S) RoPE
    positions, equal bit for bit."""
    import torch

    from repro_torch.models.transformer import compute_dtype

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(8)
    emb = torch.randn(1, VL_PROMPT, cfg.d_model, generator=g, device="cuda")
    emb = emb.to(compute_dtype(cfg))
    pos3 = vl_positions(VL_TEXT_BEFORE, VL_GRID, VL_MERGE,
                        VL_PROMPT)[:, None].to("cuda")
    check(bool((pos3[0] != pos3[1]).any() and (pos3[1] != pos3[2]).any()),
          "the image's position rows differ")

    def prefill(positions, plain=False):
        cache = model.init_cache(1, FULL_MAX_LEN, device="cuda")
        with plain_versions() if plain else contextlib.nullcontext():
            logits, _ = model.prefill(params, cache, embeddings=emb,
                                      positions=positions)
        return logits

    t0 = time.perf_counter()
    with torch.inference_mode():
        out = {"kernels": prefill(pos3), "plain": prefill(pos3, plain=True)}
        err = _rel(out["kernels"], out["plain"])
        arange = torch.arange(VL_PROMPT, device="cuda")[None]
        same = torch.equal(prefill(arange.expand(3, 1, -1)),
                           prefill(arange))
    check(bool(torch.isfinite(out["kernels"]).all()), "finite VL logits")
    print(f"    {cfg.name} {label}: prefill of {VL_PROMPT} embeddings "
          f"({VL_TEXT_BEFORE} text, a {VL_GRID}x{VL_GRID} patch grid as "
          f"{(VL_GRID // VL_MERGE) ** 2} tokens, then text; t/h/w rows "
          f"differ), kernels vs plain: max err {err[0]:.3e} of max |logit| "
          f"{err[1]:.1f}, relative L2 {err[2]:.2e} (tol {tol:g}); three "
          f"equal rows == RoPE positions bit for bit: {same}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(err[2] <= tol, f"{cfg.name} {label}: embeddings prefill, "
                         f"kernels vs plain")
    check(same, f"{cfg.name} {label}: M-RoPE with equal rows equals RoPE")
    return {f"{label}_embeddings_kernels_vs_plain": err,
            f"{label}_equal_rows_equal_rope": same}


def phase_mla():
    import torch

    from repro_torch.models.params import LM_MLA_MROPE_GOLDEN_PATH

    print(f"[20] the MLA and M-RoPE decoders: {', '.join(MLA_ARCHS)}; the "
          f"flash kernel at (D, DV) (192, 128) new and at Qwen2-VL's group "
          f"of 7, the small models vs the JAX package's outputs, each at "
          f"full width serving {len(FULL_LENGTHS)} requests (prompts "
          f"{FULL_LENGTHS}, {FULL_SLOTS} slots, max_new {FULL_MAX_NEW})")
    out = {"kernel_errors": phase_mla_kernels()}
    out["golden"] = {
        arch: phase_lm_golden(LM_MLA_MROPE_GOLDEN_PATH, f"  small {arch}",
                              prefix=f"{arch}/")
        for arch in MLA_ARCHS}
    out["full"], out["launches"] = {}, {}
    for arch in MLA_ARCHS:
        t0 = time.perf_counter()
        extra = _vl_checks if arch == "qwen2-vl-7b" else None
        out["full"][arch], out["launches"][arch] = phase_zoo_full(arch,
                                                                  extra)
        out["full"][arch]["seconds"] = time.perf_counter() - t0
        print(f"    -- {arch}: {out['full'][arch]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- whisper-small (phase [21])
WHISPER = "whisper-small"
# the flash kernel without a mask at whisper's (H, KH, D): the encoder's
# S = T = 1500 and the cross-attention's S queries over T = 1500 keys
WHISPER_HEADS = (12, 12, 64)
WHISPER_FLASH_S = (1, 100, 448, 1500, 4096)
WHISPER_FRAMES = 1500
# the timed problems, (B, H, KH, S, D, window, DV, causal, T): the
# encoder's self-attention at 4 rows and the cross-attention of a
# 4096-token prefill
WHISPER_ENCODER_TIMED = (4, 12, 12, 1500, 64, 0, 64, False, 1500)
WHISPER_CROSS_TIMED = (1, 12, 12, 4096, 64, 0, 64, False, 1500)
# the main path: 4 rows of 448 tokens (whisper's own decoder context)
# and 16 greedy decode steps, then one row of 4096 tokens (S > T in the
# cross-attention, the longest causal self-attention)
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE = 4, 448, 16
WHISPER_LONG = 4096
WHISPER_PREFILLS = 2
WHISPER_PARAMS = 263_366_400  # the reference's abstract init


def phase_whisper_kernels():
    """(a) The flash kernel without a mask on both routes against its
    plain version at whisper's shapes, the bf16 tile edges without a
    mask, and the two timed problems with SDPA's backend on each."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(9)
    H, KH, D = WHISPER_HEADS
    worst = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            tol, largest, n = TOL[name], 0.0, 0
            for S in WHISPER_FLASH_S:
                for T in sorted({WHISPER_FRAMES, S}):
                    q, k, v = _flash_inputs(g, 1, H, KH, S, D, dtype, T=T)
                    out = fa_ops.flash_attention(q, k, v, causal=False)
                    expect = _plain_flash(q, k, v, causal=False)
                    err = float((out.float() - expect.float()).abs().max())
                    label = f"H={H} KH={KH} D={D} S={S} T={T} {name}"
                    check(out.shape == (1, S, H, D) and out.dtype == dtype,
                          f"flash shapes and type, {label}")
                    check(err <= tol, f"flash kernel vs plain, non-causal "
                                      f"{label}: {err}")
                    largest = max(largest, err)
                    if (S, T) == (WHISPER_LONG, WHISPER_FRAMES):
                        worst[f"{name}_cross"] = err
                    if S == T == WHISPER_FRAMES:
                        worst[f"{name}_encoder"] = err
                    n += 1
                    del q, k, v, out, expect
            worst[name] = largest
            print(f"  flash {name} without a mask at whisper's (H, KH, D) "
                  f"{WHISPER_HEADS}: {n} cases (S {WHISPER_FLASH_S}, T "
                  f"{WHISPER_FRAMES} and S), largest error {largest:.3e} "
                  f"(tol {tol:g}) ok")
        worst["edges"], worst["edge_cases"] = _flash_tile_edges(
            g, causal=False, windows=(0,))
    torch.cuda.empty_cache()
    print("  the flash kernel without a mask at the encoder's and the "
          "cross-attention's problems (CUDA events after warm-up)")
    for label, shape in (("encoder", WHISPER_ENCODER_TIMED),
                         ("cross", WHISPER_CROSS_TIMED)):
        B, H_, KH_, S, D_, W, DV, causal, T = shape
        worst[f"timing_{label}"] = time_flash(g, B, H_, KH_, S, D_, W, DV,
                                              causal=causal, T=T)
        worst[f"sdpa_backend_{label}"] = _sdpa_backend(
            g, B, H_, KH_, S, D_, W, DV, causal=causal, T=T)
    return worst


def whisper_golden_errors(golden, device="cuda"):
    """The small whisper of the golden file, from its stored parameters
    in float32 on ``device``: max |error| of the encoder output, the
    prefill logits and each decode step's logits against the JAX
    package's (the file's cache type), and whether a greedy decode's
    tokens equal JAX's."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import cast_params

    cfg = golden.config
    model = build_model(cfg)
    params = cast_params(golden.params, cfg, device)
    frames = torch.as_tensor(golden.frames, device=device)
    prompt = torch.as_tensor(golden.prefill_tokens, device=device).long()
    B, S = prompt.shape
    dtype = getattr(torch, golden.cache_dtype)

    def err(x, want):
        return float(np.abs(x.float().cpu().numpy() - want).max())

    def prefill():
        cache = model.init_cache(B, golden.cache_len, dtype=dtype,
                                 device=device)
        return model.prefill(params, cache, tokens=prompt, frames=frames)

    out = {}
    with torch.inference_mode():
        out["encoder"] = err(tfm.run_encoder(params, cfg, frames),
                             golden.enc_out)
        lp, cache = prefill()
        out["prefill"] = err(lp, golden.prefill_logits)
        out["finite"] = bool(torch.isfinite(lp).all())
        out["decode"] = []
        for i, tok in enumerate(golden.decode_tokens):
            ld, cache = model.decode_step(
                params, torch.as_tensor(tok, device=device).long()[:, None],
                torch.full((B,), S + i, device=device), cache)
            out["decode"].append(err(ld, golden.decode_logits[i]))
        lp, cache = prefill()
        got = [lp.argmax(-1)]
        for i in range(golden.greedy_tokens.shape[1] - 1):
            ld, cache = model.decode_step(
                params, got[-1][:, None],
                torch.full((B,), S + i, device=device), cache)
            got.append(ld.argmax(-1))
    out["greedy_equal"] = (torch.stack(got, 1).cpu().numpy().tolist()
                           == golden.greedy_tokens.tolist())
    return out


def phase_whisper_golden():
    """(b) The small whisper on the card against the golden file."""
    from repro_torch.models.params import load_whisper_golden

    golden = load_whisper_golden()
    out = whisper_golden_errors(golden)
    worst = max([out["encoder"], out["prefill"]] + out["decode"])
    print(f"  small whisper on the card (float32, "
          f"{golden.config.n_encoder_layers} encoder layer over "
          f"{golden.config.n_audio_frames} frames, {golden.cache_dtype} "
          f"caches) vs the JAX package's outputs: encoder output err "
          f"{out['encoder']:.3e}, prefill logits {out['prefill']:.3e}, "
          f"decode steps {max(out['decode']):.3e} (atol "
          f"{LM_GOLDEN_ATOL:g}); greedy tokens equal JAX's: "
          f"{out['greedy_equal']}")
    check(out["finite"], "finite small whisper logits")
    check(worst <= LM_GOLDEN_ATOL, f"small whisper vs golden: {out}")
    check(out["greedy_equal"], "small whisper's greedy tokens equal JAX's")
    return out


def _whisper_inputs(cfg):
    """Seeded frames (WHISPER_BATCH, 1500, d_model) in the compute type
    and token prompts, WHISPER_BATCH rows of WHISPER_PROMPT and one of
    WHISPER_LONG, on the card."""
    import torch

    from repro_torch.models.transformer import compute_dtype

    g = torch.Generator(device="cuda").manual_seed(10)
    frames = torch.randn(WHISPER_BATCH, cfg.n_audio_frames, cfg.d_model,
                         generator=g, device="cuda").to(compute_dtype(cfg))
    short = torch.randint(0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT),
                          generator=g, device="cuda")
    long = torch.randint(0, cfg.vocab_size, (1, WHISPER_LONG), generator=g,
                         device="cuda")
    return frames, short, long


def _whisper_prefill(model, params, frames, prompt, cache_dtype=None,
                     plain=False):
    """(last-position logits, cache) of one prefill through the kernels
    or (``plain``) their plain versions."""
    kw = {} if cache_dtype is None else {"dtype": cache_dtype}
    cache = model.init_cache(prompt.shape[0], FULL_MAX_LEN, device="cuda",
                             **kw)
    with plain_versions() if plain else contextlib.nullcontext():
        return model.prefill(params, cache, tokens=prompt, frames=frames)


def _whisper_checks(model, params, frames, short, long, greedy, tol,
                    label, cache_dtype):
    """Kernels vs plain versions on the encoder output and both
    prefills' logits, and the greedy decode after the batched prefill vs
    a no-cache forward with the same encoder output, as relative L2."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    out = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc = tfm.encode(params, cfg, frames)
        with plain_versions():
            enc_plain = tfm.encode(params, cfg, frames)
        out["encoder_kernels_vs_plain"] = _rel(enc, enc_plain)
        del enc_plain
        for name, rows, prompt in (("short", frames, short),
                                   ("long", frames[:1], long)):
            got = {plain: _whisper_prefill(model, params, rows, prompt,
                                           plain=plain)[0]
                   for plain in (False, True)}
            check(bool(torch.isfinite(got[False]).all()),
                  f"{label}: finite prefill logits")
            out[f"prefill_{name}_kernels_vs_plain"] = _rel(got[False],
                                                          got[True])
        # decode step i feeds greedy[:, i] at position P + i: the logits
        # the forward over the prompt and those tokens gives at P + i
        _, cache = _whisper_prefill(model, params, frames, short,
                                    cache_dtype)
        P = short.shape[1]
        steps = []
        for i in range(greedy.shape[1]):
            ld, cache = model.decode_step(
                params, greedy[:, i:i + 1],
                torch.full((short.shape[0],), P + i, device="cuda"), cache)
            steps.append(ld)
        del cache
        hidden, _, _ = tfm.forward(params, cfg,
                                   tokens=torch.cat([short, greedy], 1),
                                   enc_out=enc, skip_unembed=True)
        ref = tfm.unembed(params, cfg, hidden[:, P:])
        out["decode_vs_forward"] = _rel(torch.stack(steps, 1), ref)
        del hidden, ref, enc
    for key, err in out.items():
        print(f"    {label} {key.replace('_', ' ')}: max err {err[0]:.3e} "
              f"of max |x| {err[1]:.1f}, relative L2 {err[2]:.2e} (tol "
              f"{tol:g})")
        check(err[2] <= tol, f"whisper {label}: {key} {err}")
    print(f"    {label} checks: {time.perf_counter() - t0:.1f} s")
    return out


def phase_whisper_full():
    """(c) whisper-small at full width, bf16 weights from seed 0 on the
    card: the main path (a batched prefill of 4 x 448 tokens over 4 rows
    of frames, 16 greedy decode steps, a prefill of 4096 tokens) with its
    flash launches counted; then the checks in bf16 and, on the same
    weights, in float32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(WHISPER)
    print(f"  {cfg.name} at full width: {cfg.n_encoder_layers} encoder "
          f"layers over {cfg.n_audio_frames} frames, {cfg.n_layers} decoder "
          f"layers with cross-attention, d_model {cfg.d_model}, H "
          f"{cfg.n_heads}, hd {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"    weights: {n_params:,} parameters, {n_bytes / 1e9:.3f} GB on "
          f"the card, drawn in {time.perf_counter() - t0:.1f} s")
    check(n_params == WHISPER_PARAMS, f"whisper-small has {WHISPER_PARAMS} "
                                      f"parameters, got {n_params}")
    frames, short, long = _whisper_inputs(cfg)
    per_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    row = {"arch": WHISPER, "parameters": n_params, "weight_bytes": n_bytes,
           "launches_per_prefill": per_prefill}
    with torch.inference_mode():
        _whisper_prefill(model, params, frames[:1], short[:1, :64])  # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.LAUNCHES = 0  # the whisper main path starts here
        t0 = time.perf_counter()
        logits, cache = _whisper_prefill(model, params, frames, short)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits.argmax(-1)
        greedy = []
        for i in range(WHISPER_DECODE):
            greedy.append(tok)
            logits, cache = model.decode_step(
                params, tok[:, None],
                torch.full((WHISPER_BATCH,), WHISPER_PROMPT + i,
                           device="cuda"), cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del cache
        long_logits, long_cache = _whisper_prefill(model, params,
                                                   frames[:1], long)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = fa_ops.LAUNCHES  # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        del long_cache
        greedy = torch.stack(greedy, 1)
        check(bool(torch.isfinite(logits).all()
                   and torch.isfinite(long_logits).all()),
              "whisper: finite logits")
        check(tuple(long_logits.shape) == (1, cfg.vocab_size),
              "whisper: logits (B, V)")
        check(launches == WHISPER_PREFILLS * per_prefill,
              f"whisper: {launches} flash launches, expected {per_prefill} "
              f"per prefill x {WHISPER_PREFILLS}")
        encoder_ms = cuda_ms(lambda: tfm.encode(params, cfg, frames), 5)
        encoder_one_ms = cuda_ms(lambda: tfm.encode(params, cfg,
                                                    frames[:1]), 5)
    short_key = f"{WHISPER_BATCH}x{WHISPER_PROMPT}"
    long_key = f"1x{WHISPER_LONG}"
    row.update({
        "launches": launches, "peak_memory_bytes": peak,
        "encoder_ms": {str(WHISPER_BATCH): encoder_ms, "1": encoder_one_ms},
        "prefill_latency_s": {short_key: t1 - t0, long_key: t3 - t2},
        "prefill_tokens_per_s": {
            short_key: WHISPER_BATCH * WHISPER_PROMPT / (t1 - t0),
            long_key: WHISPER_LONG / (t3 - t2)},
        "decode_steps": WHISPER_DECODE, "decode_s": t2 - t1,
        "decode_tokens_per_s": WHISPER_BATCH * WHISPER_DECODE / (t2 - t1),
    })
    print(f"    main path: flash launches {launches} ({per_prefill} per "
          f"prefill: {cfg.n_encoder_layers} encoder without a mask, "
          f"{cfg.n_layers} causal self-attention, {cfg.n_layers} "
          f"cross-attention without a mask); peak memory "
          f"{peak / 1e9:.2f} GB")
    print(f"    encoder (CUDA events): {encoder_ms:.3f} ms at B="
          f"{WHISPER_BATCH}, {encoder_one_ms:.3f} ms at B=1")
    print(f"    prefill {short_key} with frames: {(t1 - t0) * 1e3:.1f} ms, "
          f"{row['prefill_tokens_per_s'][short_key]:.0f} tokens/s; "
          f"{long_key}: {(t3 - t2) * 1e3:.1f} ms, "
          f"{row['prefill_tokens_per_s'][long_key]:.0f} tokens/s; decode "
          f"{WHISPER_DECODE} steps x {WHISPER_BATCH} rows in "
          f"{(t2 - t1) * 1e3:.1f} ms, {row['decode_tokens_per_s']:.1f} "
          f"tokens/s")
    checks = {"bf16": _whisper_checks(model, params, frames, short, long,
                                      greedy, FULL_BF16_REL_TOL, "bf16",
                                      torch.bfloat16)}
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = _float32_in_place(params)
    del params
    torch.cuda.empty_cache()
    checks["f32"] = _whisper_checks(model32, params32, frames.float(),
                                    short, long, greedy, FULL_F32_REL_TOL,
                                    "f32", torch.float32)
    del params32, frames
    torch.cuda.empty_cache()
    row["checks"] = checks
    return row


def phase_whisper():
    print(f"[21] {WHISPER}: the flash kernel without a mask (the encoder's "
          f"self-attention and the cross-attention), the small model vs "
          f"the JAX package's outputs, and the model at full width: "
          f"{WHISPER_BATCH} rows of {WHISPER_FRAMES} frames, a prefill of "
          f"{WHISPER_BATCH}x{WHISPER_PROMPT} tokens, {WHISPER_DECODE} "
          f"greedy decode steps, a prefill of 1x{WHISPER_LONG}")
    out = {"kernel_errors": phase_whisper_kernels()}
    out["golden"] = phase_whisper_golden()
    t0 = time.perf_counter()
    out["full"] = phase_whisper_full()
    out["full"]["seconds"] = time.perf_counter() - t0
    print(f"    -- {WHISPER}: {out['full']['seconds']:.1f} s")
    return out


# ------------------------------------------- LM training (phase [22])
# (a) the flash backward kernel against the plain version's autograd:
# the (H, KH) of the zoo's and RecurrentGemma's training shapes at every
# square head dim, in the five modes of the forward's path (causal
# without a window and with gemma3's 1024 and RecurrentGemma's 2048; no
# mask over T = S and over whisper's 1500 keys)
FLASH_BWD_HEADS = ((9, 3), (16, 2), (16, 16), (8, 4), (16, 1))
FLASH_BWD_MODES = ((True, 0, None), (True, 1024, None), (True, 2048, None),
                   (False, 0, None), (False, 0, 1500))
FLASH_BWD_S = (1, 777, 4096)
# bf16 tile edges around the backward's tiles (64 query rows, 64 or 32
# keys), T = S and T about S / 2 (rows with no live key under a window)
FLASH_BWD_EDGE_S = (31, 32, 33, 63, 64, 65, 127, 129, 191)
FLASH_BWD_EDGE_MODES = ((True, 0), (True, 1), (True, 65), (False, 0))
FLASH_BWD_EDGE_HEADS = ((9, 3), (8, 4))
# the timed problems (B, H, KH, S, D, window), causal: smollm-135m's
# training step, the D = 128 problem of phase [19d] and gemma3-4b's
# sliding-window layers at D = 256
FLASH_BWD_SMOLLM = (8, 9, 3, 2048, 64, 0)
FLASH_BWD_D128 = (1, 16, 2, 4096, 128, 0)
FLASH_BWD_GEMMA3 = (1, 8, 4, 4096, 256, 1024)
# the bf16 forward timed with and without its log-sum-exp: phase [19d]'s
# D = 128 problem and the D = 256 prefill of the kernel table
# (B, H, KH, S, D, window)
FLASH_LSE_TIMED = (FLASH_BWD_D128, (1, 16, 1, 4096, 256, 2048))
# The backward's bound counts FlashAttention-2's five products a live
# pair: S, dK and dQ over D, dP and dV over DV, 6 D + 4 DV flops (2.5 x the
# forward's 4 D at D = DV); the kernels compute S and dP twice (14 D
# flops a live pair, 16 D where dK and dV take separate blocks)
# what the bf16 backward is, for the kernels line
FLASH_BWD_DESIGN = ("tensor cores: wgmma m64n64 S^T/dP^T and m64nD dV/dK "
                    "(P^T, dS^T as register A operands, each as two bf16 "
                    "terms), TMA rings of two 64-row stages, one warpgroup "
                    "a block, L and the float32 output kept by the "
                    "forward; delta pre-pass, dK/dV, dQ (no atomics); dK "
                    "and dV in separate blocks at D = 256")
# (b) card vs the JAX package's CPU outputs, float32 on both sides: the
# loss terms relative (absolute below 1), every gradient leaf as max
# |a - b| over max |b|, the parameters after the golden's AdamW steps
LM_LOSS_RTOL = 1e-5
LM_GRAD_RTOL = 1e-4
LM_PARAMS_ATOL = 1e-5
# The sLSTM's recurrent input-gate bias (``.../ri/b``) has an exact
# gradient of 0: its units' recurrences are elementwise, and a constant
# added to one unit's log_i at every step shifts that unit's stabilizer m
# alike and leaves c / n, and so h, unchanged. Both packages return
# rounding noise there (phase [24b] prints its share of the norm), so it
# is held under LM_ZERO_GRAD_RTOL of the global gradient norm instead and
# left out of the relative comparisons.
LM_ZERO_GRAD_LEAF = ("ri", "b")
LM_ZERO_GRAD_RTOL = 1e-6


def lm_zero_grad_leaf(key: str) -> bool:
    """Is the leaf at ``key`` (dots or slashes) one whose exact gradient
    is 0 (``LM_ZERO_GRAD_LEAF``)?"""
    return tuple(key.replace("/", ".").split(".")[-2:]) == LM_ZERO_GRAD_LEAF
# (c) smollm-135m at full width through launch/train.py::main: 30 steps
# of B 8 x S 2048, a failure of host-1 at step 12, a checkpoint every 10
LM_TRAIN_CKPT = ROOT / "build" / "chip_lm_ckpt"
LM_TRAIN_ARGV = ["--arch", "smollm-135m", "--scale", "full", "--steps", "30",
                 "--batch", "8", "--seq", "2048", "--fail-at", "12",
                 "--checkpoint-every", "10", "--ckpt-dir",
                 str(LM_TRAIN_CKPT)]
LM_TRAIN_LOSSES, LM_TRAIN_FAIL = 31, 12  # 30 steps, step 11 run twice
LM_TRAIN_LAYERS = 30  # smollm-135m's attention layers


def live_rows(S, T, causal, window, device="cuda"):
    """(S,) bool: the query rows with a live key. A row's nearest key is
    min(i, T - 1) under the causal mask and T - 1 without it; with a
    window it is live when i - that key < window."""
    import torch

    i = torch.arange(S, device=device)
    if window <= 0:
        return torch.ones(S, dtype=torch.bool, device=device)
    nearest = torch.clamp(i, max=T - 1) if causal else torch.full_like(
        i, T - 1)
    return i - nearest < window


def flash_bwd_errors(q, k, v, dout, causal, window):
    """The backward kernel's gradients (through ``flash_attention`` under
    autograd on the card) against the plain version's autograd with the
    cotangent zeroed at rows with no live key (the kernels give 0 there,
    the plain version the mean of v, whose gradient the kernels do not
    have): (max |a - b| / (1 + |b|), max |a - b|) over dq, dk and dv; the
    first is the reference's kernel check, ``atol = rtol = TOL``. A
    float32 kernel is held against the plain version evaluated in
    float64: at a GQA group of 16 a float32 dK or dV sums 16 x 4096
    terms, where the plain version's own float32 sums are no exact
    reference at TOL."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    live = live_rows(q.shape[1], k.shape[1], causal, window)
    mode = dict(causal=causal, window=window)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves, **mode),
                              leaves, dout)
    wide = torch.float64 if q.dtype == torch.float32 else q.dtype
    leaves = [t.detach().to(wide).requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        _plain_flash(*leaves, **mode), leaves,
        dout.to(wide) * live[None, :, None, None].to(wide))
    scaled = absolute = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == q.dtype,
              "flash backward shapes and type")
        diff = (a.double() - b.double()).abs()
        scaled = max(scaled, float((diff / (1 + b.double().abs())).max()))
        absolute = max(absolute, float(diff.max()))
    return scaled, absolute


def phase_lm_train_kernel():
    """(a) The backward kernel against the plain version on the card."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {}

    def case(dtype, B, H, KH, S, T, D, causal, W):
        q, k, v = _flash_inputs(g, B, H, KH, S, D, dtype, None, T)
        dout = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
        return flash_bwd_errors(q, k, v, dout, causal, W)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol, largest, n = TOL[name], 0.0, 0
        for (H, KH), D, (causal, W, T), S in itertools.product(
                FLASH_BWD_HEADS, fa_ops.HEAD_DIMS, FLASH_BWD_MODES, FLASH_BWD_S):
            T = S if T is None else T
            err, _ = case(dtype, 1, H, KH, S, T, D, causal, W)
            label = (f"H={H} KH={KH} D={D} S={S} T={T} "
                     f"{'causal' if causal else 'non-causal'} window={W} "
                     f"{name}")
            check(err <= tol, f"flash backward vs plain, {label}: {err}")
            largest, n = max(largest, err), n + 1
        worst[name] = largest
        print(f"  flash backward {name}: {n} cases ((H, KH) {FLASH_BWD_HEADS}, D "
              f"{fa_ops.HEAD_DIMS}, (causal, window, T) {FLASH_BWD_MODES}, S "
              f"{FLASH_BWD_S}), largest |a - b| / (1 + |b|) over dq, dk, dv "
              f"{largest:.3e} (tol {tol:g}) ok")
        torch.cuda.empty_cache()
    tol, largest, n, dead = TOL["bfloat16"], 0.0, 0, 0
    for S, half, (causal, W), (H, KH), D in itertools.product(
            FLASH_BWD_EDGE_S, (False, True), FLASH_BWD_EDGE_MODES, FLASH_BWD_EDGE_HEADS,
            fa_ops.HEAD_DIMS):
        T = (S + 1) // 2 if half else S
        err, _ = case(torch.bfloat16, 1, H, KH, S, T, D, causal, W)
        label = (f"S={S} T={T} window={W} H={H} KH={KH} D={D} "
                 f"{'causal' if causal else 'non-causal'} bfloat16")
        check(err <= tol, f"flash backward vs plain, {label}: {err}")
        largest, n = max(largest, err), n + 1
        dead += int((~live_rows(S, T, causal, W)).sum())
    worst["edges"] = largest
    print(f"  flash backward bfloat16 tile edges: {n} cases (S "
          f"{FLASH_BWD_EDGE_S}, T = S and (S + 1) // 2, (causal, window) "
          f"{FLASH_BWD_EDGE_MODES}, (H, KH) {FLASH_BWD_EDGE_HEADS}, D "
          f"{fa_ops.HEAD_DIMS}), largest {largest:.3e} (tol {tol:g}) ok; "
          f"{dead} rows with no live key give no gradient")
    B, H, KH, S, D, _ = FLASH_BWD_SMOLLM
    q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.bfloat16)
    dout = torch.randn(B, S, H, D, generator=g, device="cuda").to(
        torch.bfloat16)
    out, lse = fa_ops.flash_attention_with_lse(q, k, v)
    first = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse)
    for _ in range(4):
        again = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              "the flash backward is deterministic")
    worst["main"], worst["main_abs"] = flash_bwd_errors(q, k, v, dout, True,
                                                        0)
    print(f"  flash backward at smollm-135m's training problem (B={B} H={H}"
          f" KH={KH} S={S} D={D} causal bfloat16): 5 launches equal bit for "
          f"bit; vs plain {worst['main']:.3e} (max abs err "
          f"{worst['main_abs']:.3e})")
    del q, k, v, dout, out, lse, first, again
    torch.cuda.empty_cache()
    return worst


def flash_bwd_routes():
    """The backward's route at each head dim (bf16 on the tensor cores,
    float32 on the CUDA cores) and the resources of each tensor-core
    kernel: registers and local (spilled) bytes a thread, shared memory
    a block."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    found = {}
    for D in fa_ops.HEAD_DIMS:
        routes = {str(dt).split(".")[-1]: fa_ops.bwd_route(dt, D)
                  for dt in fa_ops.DTYPES}
        check(routes == {"float32": "cuda_core", "bfloat16": "tensor_core"},
              f"the backward's routes at D = {D}: {routes}")
        found[D] = fa_ops.backward_attributes(D)
        print(f"  flash backward D={D}: routes {routes}; tensor-core kernels "
              + ", ".join(f"{name} {a['registers']} registers, "
                          f"{a['local_bytes']} local bytes, "
                          f"{a['static_smem_bytes'] + a['dynamic_smem_bytes']}"
                          f" bytes of shared memory"
                          for name, a in found[D].items()))
    return found


def lm_train_golden_errors(golden, device="cuda", float64_anchor=False):
    """(b) One small decoder of ``lm_train_small_golden.npz`` on
    ``device``, over the golden's AdamW steps under ``cosine_schedule``:
    its pipeline's batches equal the golden's bit for bit (a golden of
    the "vlm" or "audio" family's batches, which holds embeddings and
    positions or frames, gives its batches whole); the loss terms
    on the first (LM_LOSS_RTOL); at each step every gradient leaf
    (LM_GRAD_RTOL of the leaf's largest); and the port's AdamW, fed the
    JAX gradients of each step, gives the golden's parameters at
    LM_PARAMS_ATOL. The gradients are taken along that trajectory, which
    stays within float32 rounding of the reference's: on its own
    gradients the port's parameters drift from the reference's where |g|
    is near 0 (Adam moves an element by about lr * m_hat / sqrt(v_hat),
    whose direction there turns on errors far below the gradient
    check's), and the later gradients with them. A leaf whose exact
    gradient is 0 (``lm_zero_grad_leaf``) is held under LM_ZERO_GRAD_RTOL
    of the step's global gradient norm. With ``float64_anchor`` (the small
    xLSTM's, whose float32 gradients in either package sit so near
    LM_GRAD_RTOL of a float64 evaluation that two evaluations as accurate
    as each other can differ past it) a leaf past
    LM_GRAD_RTOL of JAX's gradient passes when it and JAX's gradient are
    both within LM_GRAD_RTOL of the port's float64 evaluation (its plain
    versions, the same parameters and batch); ``anchored`` counts those
    leaves. Returns the errors and the flash, RG-LRU and mLSTM launches of
    the first step."""
    import numpy as np
    import torch

    from repro_torch.common.tree import flatten, tree_cast, unflatten_as
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import cast_params
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = golden.config
    model = build_model(cfg)
    params = cast_params(golden.params, cfg, device)
    a = golden.adamw
    opt = AdamW(lr=cosine_schedule(a["peak"], int(a["warmup"]),
                                   int(a["steps"])))
    st = opt.init(params)
    steps, B, S = golden.labels.shape
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=0, device=device)
    drawn = any(x is not None for x in (golden.embeddings, golden.positions,
                                        golden.frames))
    out = {"loss": 0.0, "grads": 0.0, "zero_grads": 0.0, "anchored": 0,
           "anchored_grads": 0.0}
    model64 = (build_model(dataclasses.replace(cfg, dtype="float64"))
               if float64_anchor else None)
    for i in range(steps):
        batch = golden.batch(i, device) if drawn else pipe.batch_at(i)
        for key in ("tokens", "labels"):
            check(drawn or np.array_equal(batch[key].cpu().numpy(),
                                          getattr(golden, key)[i]),
                  f"{cfg.name}: batch_at({i}) {key} equals the golden's")
        fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0
        lru_ops.LAUNCHES = lru_ops.BWD_LAUNCHES = 0
        mlstm_ops.LAUNCHES = mlstm_ops.BWD_LAUNCHES = 0
        (loss, met), grads = value_and_grad(model.loss, params, batch)
        if i == 0:
            out["launches"] = {"forward": fa_ops.LAUNCHES,
                               "backward": fa_ops.BWD_LAUNCHES}
            out["lru_launches"] = {"forward": lru_ops.LAUNCHES,
                                   "backward": lru_ops.BWD_LAUNCHES}
            out["mlstm_launches"] = {"forward": mlstm_ops.LAUNCHES,
                                     "backward": mlstm_ops.BWD_LAUNCHES}
            for name, got in (("loss", loss), ("ce", met["ce"]),
                              ("aux", met["aux"])):
                want = getattr(golden, name)
                err = abs(float(got) - want) / max(abs(want), 1.0)
                check(err <= LM_LOSS_RTOL, f"{cfg.name}: {name} {float(got)}"
                                           f" vs the golden's {want}")
                out["loss"] = max(out["loss"], err)
        want = {k: w.to(device) for k, w in flatten(golden.grads[i]).items()}
        got = flatten(grads)
        check(set(got) == set(want), f"{cfg.name}: the gradient tree")
        norm = math.sqrt(sum(float(torch.linalg.vector_norm(w)) ** 2
                             for w in want.values()))
        exact = None
        for key, w in want.items():
            if lm_zero_grad_leaf(key):
                err = float(got[key].abs().max()) / norm
                check(err <= LM_ZERO_GRAD_RTOL, f"{cfg.name}: step {i} grad "
                                                f"{key} (exactly 0) {err}")
                out["zero_grads"] = max(out["zero_grads"], err)
                continue
            err = _tensor_rel(got[key], w)
            out["grads"] = max(out["grads"], err)
            if err > LM_GRAD_RTOL and float64_anchor:
                if exact is None:
                    with plain_versions():
                        _, g64 = value_and_grad(
                            model64.loss, tree_cast(params, torch.float64),
                            batch)
                    exact = flatten(g64)
                e_k = _tensor_rel(got[key].double(), exact[key])
                e_j = _tensor_rel(w.double(), exact[key])
                check(e_k <= LM_GRAD_RTOL and e_j <= LM_GRAD_RTOL,
                      f"{cfg.name}: step {i} grad {key} {err} from JAX's; "
                      f"from float64 {e_k} (JAX's {e_j})")
                out["anchored"] += 1
                out["anchored_grads"] = max(out["anchored_grads"], e_k)
                continue
            check(err <= LM_GRAD_RTOL, f"{cfg.name}: step {i} grad {key} "
                                       f"{err}")
        params, st, _ = opt.update(unflatten_as(params, want), st, params)
    got = flatten(params)
    out["params"] = max(float((got[k] - w.to(device)).abs().max())
                        for k, w in flatten(golden.params_after).items())
    check(out["params"] <= LM_PARAMS_ATOL,
          f"{cfg.name}: parameters after {steps} AdamW steps on the JAX "
          f"gradients: {out['params']}")
    return out


def phase_lm_train_golden():
    from repro_torch.models.params import (load_lm_train_golden,
                                           load_pipeline_golden)

    out = {}
    for arch in ZOO_ARCHS:
        golden = load_lm_train_golden(arch)
        t0 = time.perf_counter()
        e = out[arch] = lm_train_golden_errors(golden)
        print(f"  small {arch}: loss terms {e['loss']:.2e} (rtol "
              f"{LM_LOSS_RTOL:g}), gradients {e['grads']:.2e} (rtol "
              f"{LM_GRAD_RTOL:g}, every step), parameters after "
              f"{golden.tokens.shape[0]} AdamW steps on the JAX gradients "
              f"{e['params']:.2e} (atol {LM_PARAMS_ATOL:g}); flash launches a "
              f"step: {e['launches']['forward']} forward, "
              f"{e['launches']['backward']} backward; "
              f"{time.perf_counter() - t0:.1f} s")
    import numpy as np

    from repro_torch.data.tokens import TokenPipeline

    g = load_pipeline_golden()
    pipe = TokenPipeline(g["vocab"], g["seq"], g["batch"], seed=0)
    for i, step in enumerate(g["steps"]):
        batch = pipe.batch_at(step)
        for key in ("tokens", "labels"):
            check(np.array_equal(batch[key].cpu().numpy(), g[key][i]),
                  f"batch_at({step}) {key} at vocab {g['vocab']} equals the "
                  f"JAX pipeline's")
    print(f"  TokenPipeline({g['vocab']}, {g['seq']}, {g['batch']}) on the "
          f"card: batch_at({g['steps']}) equal to the JAX pipeline's bit for "
          f"bit")
    return out


def _flat_grads(model, params, batch, plain=False):
    """(loss, {leaf: gradient}) through the kernels or their plain
    versions."""
    from repro_torch.common.tree import flatten
    from repro_torch.launch.steps import value_and_grad

    with plain_versions() if plain else contextlib.nullcontext():
        (loss, _), grads = value_and_grad(model.loss, params, batch)
    return float(loss), flatten(grads)


def _l2(a, b):
    import torch

    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _grad_distances(model, params, batch, tol, label):
    """Loss and gradients through the kernels and through the plain
    versions on one batch: relative distance of the losses and the
    largest relative L2 distance of a gradient leaf."""
    lk, gk = _flat_grads(model, params, batch)
    lp, gp = _flat_grads(model, params, batch, plain=True)
    dist = {key: _l2(gk[key], gp[key]) for key in gp}
    leaf = max(dist, key=dist.get)
    worst, loss = dist[leaf], abs(lk - lp) / abs(lp)
    print(f"  {label}: loss {lk:.5f} (kernels) vs {lp:.5f} (plain), "
          f"relative {loss:.2e}; largest gradient relative L2 {worst:.2e} "
          f"({leaf}) (tol {tol:g})")
    check(loss <= tol and worst <= tol, f"{label}: kernels vs plain")
    return {"loss": loss, "grads": worst, "leaf": leaf}


def phase_lm_train_full():
    """(c) smollm-135m at full width through ``launch.train.main``."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.common.tree import tree_cast
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    shutil.rmtree(LM_TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    es_ops.LAUNCHES = es_ops.BWD_LAUNCHES = 0  # the main path starts here
    fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    result = train.main(LM_TRAIN_ARGV)
    seconds = time.perf_counter() - t0
    launches = {"edge_softmax_fwd": es_ops.LAUNCHES,
                "edge_softmax_bwd": es_ops.BWD_LAUNCHES,
                "flash_fwd": fa_ops.LAUNCHES,
                "flash_bwd": fa_ops.BWD_LAUNCHES}  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    check(all(v > 0 for v in launches.values()),
          f"the training path launched every kernel of its path: {launches}")
    check(len(losses) == LM_TRAIN_LOSSES and result["restarts"] == 1,
          f"{len(losses)} losses, {result['restarts']} restarts")
    check(result["final_hosts"] == ["host-0", "host-2", "host-3"],
          f"hosts after the failure: {result['final_hosts']}")
    check([(e.step, e.kind, e.detail) for e in result["events"]]
          == [(LM_TRAIN_FAIL, "failure", "host-1")],
          f"events: {result['events']}")
    check(bool(np.all(np.isfinite(losses))), "every loss is finite")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"the loss falls: {losses[0]} -> {np.mean(losses[-5:])}")
    per_step = {k: launches[k] / len(losses)
                for k in ("flash_fwd", "flash_bwd")}
    # the forward once and again under remat, the backward once, a layer
    check(per_step == {"flash_fwd": 2 * LM_TRAIN_LAYERS,
                       "flash_bwd": LM_TRAIN_LAYERS},
          f"flash launches a step: {per_step}")
    step_ms = result["step_ms"]
    median = statistics.median(step_ms[3:])
    B, S = 8, 2048
    out = {"seconds": seconds, "losses": losses, "launches": launches,
           "launches_per_step": per_step, "step_ms": step_ms,
           "median_step_ms": median, "tokens_per_s": B * S / median * 1e3,
           "peak_memory_gb": peak / 1e9,
           "events": [(e.step, e.kind, e.detail) for e in result["events"]]}
    print(f"  launch.train.main({' '.join(LM_TRAIN_ARGV)}): {seconds:.1f} s;"
          f" {len(losses)} losses, {losses[0]:.4f} -> mean of the last five "
          f"{np.mean(losses[-5:]):.4f}; restarts {result['restarts']}; "
          f"events {out['events']}; hosts {result['final_hosts']}")
    print(f"  step time (CUDA events, median of the {len(step_ms) - 3} steps "
          f"after the first three) {median:.2f} ms, {out['tokens_per_s']:.0f}"
          f" tokens/s; peak memory {out['peak_memory_gb']:.2f} GB; launches "
          f"{launches}, flash a step {per_step}")
    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=0)
    times = []
    for step in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = pipe.batch_at(step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["batch_at_ms"] = statistics.median(times[2:])
    print(f"  TokenPipeline.batch_at at B={B} S={S} on the card: "
          f"{out['batch_at_ms']:.3f} ms (host clock ending in a "
          f"synchronize, median of 10 after 2)")

    state = result.pop("state")
    params = state["params"]
    step = train.make_step(model, AdamW(lr=cosine_schedule(3e-4, 10, 30)))
    step(params, state["opt"], batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        new = step(params, state["opt"], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    del new, state
    device_us, top = _top_device(prof)
    port = _port_device(prof)
    split = _device_by_name(prof, FLASH_BWD_KERNELS)
    out["profile"] = {
        "wall_s": wall, "device_s": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "top": [{"name": k[:90], "us": us, "count": c} for us, c, k in top],
        "port_kernels": {k: {"us": us, "count": c}
                         for k, (us, c) in port.items()},
        "flash_bwd_split": {k: {"us": us, "count": c}
                            for k, (us, c) in split.items()}}
    print(f"  profiled step: {wall * 1e3:.1f} ms wall, {device_us / 1e3:.1f} "
          f"ms of device activity, idle share "
          f"{out['profile']['device_idle_share']:.4f}; the port's kernels: "
          + ", ".join(f"{k} {us / 1e3:.3f} ms x{c} ({us / device_us:.2%})"
                      for k, (us, c) in port.items()) + "; top device "
          "entries:")
    for us, c, k in top:
        print(f"    {us:10.1f} us x{c:4d}  {k[:90]}")
    print("  the flash backward in the profiled step: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms x{c}" for k, (us, c) in split.items()))
    torch.cuda.empty_cache()
    out["vs_plain"] = {"bfloat16": _grad_distances(
        model, params, batch, FULL_BF16_REL_TOL,
        "full width bf16, kernels vs plain versions")}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_cast(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    out["vs_plain"]["float32"] = _grad_distances(
        build_model(cfg32), params32, batch, FULL_F32_REL_TOL,
        "full width float32 (the bf16 weights widened), kernels vs plain "
        "versions")
    del params32, batch
    torch.cuda.empty_cache()
    return out


def time_flash_bwd(g, B, H, KH, S, D, W, DV=None, causal=True, T=None):
    """(d) The backward kernel at one problem (window W, 0 for none; v
    head dim DV, default D; T keys, default S; causal, or without a mask)
    in bf16 and float32, with L from the forward, the plain version's
    autograd, SDPA's backward (the faster of k/v repeated to the query
    heads and ``enable_gqa=True``, and which of its backends ran; a
    window takes a boolean mask and the repeated heads), and the bounds:
    the backward's 6 D + 4 DV flops a live pair (2.5 x the forward's at
    D = DV) at the bf16 tensor-core rate (the float32 route at the
    float32 rate), or q, k, v, the output and its cotangent read once and
    the three gradients written once."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa_ops

    mode = dict(causal=causal, window=W)
    DV = D if DV is None else DV
    T = S if T is None else T
    q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.bfloat16, DV, T)
    dout = torch.randn(B, S, H, DV, generator=g, device="cuda").to(
        torch.bfloat16)
    out, lse = fa_ops.flash_attention_with_lse(q, k, v, **mode)
    ms = cuda_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                                    **mode), 10)
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    outf, lsef = fa_ops.flash_attention_with_lse(qf, kf, vf, **mode)
    f32_ms = cuda_ms(lambda: fa_ops.flash_attention_bwd(
        qf, kf, vf, outf, df, lsef, **mode), 3)
    del qf, kf, vf, df, outf, lsef
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = _plain_flash(*leaves, **mode)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        plain_out, leaves, dout, retain_graph=True), 3)
    del plain_out, leaves
    torch.cuda.empty_cache()
    if W > 0:
        pos = torch.arange(S, device="cuda")
        rel = pos[:, None] - pos[None, :]
        how = {"attn_mask": (rel >= 0) & (rel < W)}
    else:
        how = {"is_causal": causal}

    def sdpa_grads(gqa, backend=None):
        qs = q.transpose(1, 2).contiguous().requires_grad_()
        ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
        if not gqa:
            ks, vs = (t.repeat_interleave(H // KH, dim=1) for t in (ks, vs))
        ks, vs = ks.requires_grad_(), vs.requires_grad_()

        def ctx():
            return (sdpa_kernel(backend) if backend
                    else contextlib.nullcontext())

        with ctx():
            o = F.scaled_dot_product_attention(
                qs, ks, vs, **how,
                **({"enable_gqa": True} if gqa else {}))
        do = dout.transpose(1, 2).contiguous()

        def grads():
            with ctx():
                return torch.autograd.grad(o, (qs, ks, vs), do,
                                           retain_graph=True)
        return grads

    library_times = {"repeated": cuda_ms(sdpa_grads(False), 5)}
    if W == 0:
        library_times["enable_gqa"] = cuda_ms(sdpa_grads(True), 5)
    library_call = min(library_times, key=library_times.get)
    gqa = library_call == "enable_gqa"
    # which backend the default call ran: the one whose gradients lie
    # nearest the default call's (its backward is not bit-reproducible
    # from call to call, so no backend equals it bit for bit)
    default = sdpa_grads(gqa)()
    backends = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                fn = sdpa_grads(gqa, backend)
                dist = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(fn(), default))
                backends[backend.name] = (cuda_ms(fn, 3), dist)
            except RuntimeError:
                backends[backend.name] = (None, None)
    ran = min((name for name, (_, d) in backends.items() if d is not None),
              key=lambda name: backends[name][1])
    del default
    pairs = (sum(min(i + 1, W) if W > 0 else min(i + 1, T)
                 for i in range(S)) if causal else S * T)
    fwd_flops = 2 * (D + DV) * pairs * H * B
    # S, dK, dQ over D and dP, dV over DV: 2.5 x the forward's at D = DV
    flops = (6 * D + 4 * DV) * pairs * H * B
    # q, out, dout read and dq written; k, v read and dk, dv written
    nbytes = 2 * (q.nbytes + dout.nbytes + k.nbytes + v.nbytes)
    t_ops, t_bytes = (flops / BF16_FLOP_PER_S * 1e3,
                      nbytes / HBM_BYTES_PER_S * 1e3)
    dims = f"D={D}" if DV == D else f"(D, DV)=({D}, {DV})"
    keys = "" if T == S else f"T={T} "
    row = {"shape": f"B={B} H={H} KH={KH} S={S} {keys}{dims} window={W} "
                    f"{'causal' if causal else 'no mask'} bfloat16",
           "ms": ms, "plain_ms": plain_ms, "library_ms":
           library_times[library_call],
           "library_call": f"{next(iter(how))}, {library_call}",
           "library_times_ms": library_times, "sdpa_backends_ms": {
               k: t for k, (t, _) in backends.items()},
           "sdpa_backend_distance": {k: d for k, (_, d) in backends.items()},
           "sdpa_backend": ran, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "tflop_per_s": flops / ms / 1e9, "f32_ms": f32_ms,
           "f32_bound_ms": f32_bound_ms(flops, 2 * nbytes),
           "route": fa_ops.bwd_route(q.dtype, D, DV)}
    print(f"  flash backward {row['shape']}: kernel {ms:.4f} ms "
          f"({row['tflop_per_s']:.1f} TFLOP/s at {flops / fwd_flops:g} x the "
          f"forward's {fwd_flops / 1e9:.1f} GFLOP), plain {plain_ms:.4f} ms, "
          f"SDPA backward {row['library_ms']:.4f} ms ({row['library_call']}"
          f": {library_times}; nearest the default call's gradients: {ran}, "
          f"max |difference| by backend {row['sdpa_backend_distance']}; "
          f"each backend alone, ms: {row['sdpa_backends_ms']}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.1f} "
          f"GFLOP, {nbytes / 1e6:.1f} MB); the float32 route {f32_ms:.4f} "
          f"ms against its own bound {row['f32_bound_ms']:.4f} ms")
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
    return row


def time_flash_lse(g):
    """(d) The bf16 forward without L (serving's call) and with it (the
    autograd forward's) at FLASH_LSE_TIMED, in turns: without, with,
    with, without."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    rows = {}
    for B, H, KH, S, D, W in FLASH_LSE_TIMED:
        q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.bfloat16)
        calls = {"without": lambda: fa_ops.flash_attention(q, k, v, window=W),
                 "with": lambda: fa_ops.flash_attention_with_lse(
                     q, k, v, window=W)}
        with torch.no_grad():
            times = {name: [] for name in calls}
            for name in ("without", "with", "with", "without"):
                times[name].append(cuda_ms(calls[name], 20))
        shape = f"B={B} H={H} KH={KH} S={S} D={D} window={W} causal bfloat16"
        rows[shape] = {name: statistics.mean(ts) for name, ts in times.items()}
        print(f"  flash forward {shape}: without L {rows[shape]['without']:.4f}"
              f" ms, with L {rows[shape]['with']:.4f} ms (mean of two turns "
              f"each: {times})")
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def phase_lm_train():
    import torch

    print("[22] LM training: the flash backward kernel vs the plain "
          "version's autograd, the five small decoders' loss, gradients and "
          "AdamW steps vs the JAX package's (lm_train_small_golden.npz), "
          "smollm-135m at full width through launch.train.main (B 8 x S "
          "2048, 30 steps, a failure at step 12), and the backward's time")
    out = {}
    t0 = time.perf_counter()
    out["backward_attributes"] = flash_bwd_routes()
    out["kernel_errors"] = phase_lm_train_kernel()
    print(f"    -- (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["golden"] = phase_lm_train_golden()
    print(f"    -- (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["full"] = phase_lm_train_full()
    print(f"    -- (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(7)
    out["timing"] = {"smollm": time_flash_bwd(g, *FLASH_BWD_SMOLLM),
                     "d128": time_flash_bwd(g, *FLASH_BWD_D128),
                     "gemma3": time_flash_bwd(g, *FLASH_BWD_GEMMA3)}
    out["forward_lse"] = time_flash_lse(g)
    print(f"    -- (d) {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------ RecurrentGemma training (phase [23])
RG = "recurrentgemma-9b"
# (a) the RG-LRU backward kernel against ref.linear_scan_bwd at
# |a - b| <= TOL (1 + |b|): S around the 32-step chunks and long, C
# around the 128-channel tiles and the model's width
LRU_BWD_S = (1, 31, 32, 33, 63, 64, 65, 1000, 4096)
LRU_BWD_C = (1, 100, 128, 4096)
LRU_BWD_B = (1, 4)
# timed at the model's width, B 1 and the training cell's B 2
LRU_BWD_TIMED = ((1, 4096, 4096), (2, 4096, 4096))
LRU_BWD_DESIGN = ("single-pass chunked scan with a decoupled look-back, "
                  "walked from the last chunk: tiles of 32 steps x 128 "
                  "channels (one a thread, a, g and y in registers), tickets "
                  "chunk-major from the last chunk, aggregates of dh -> a' dh "
                  "+ g with a'_t = a_{t+1}, the prefix recursion in a fixed "
                  "order (bit-identical runs); da = dh * y_{t-1}, db = dh, "
                  "dh0 = a_0 dh_0")
# the flash backward at RecurrentGemma's local attention, B 2 (the cell's)
RG_FLASH_BWD = (2, 16, 1, 4096, 256, 2048)  # (B, H, KH, S, D, window)
# (c) the full-width cell: every published width, the body cut to 2 of its
# 12 periods (the card's 80 GB hold 2.64 B parameters' weights, gradients
# and two float32 moments, 31.7 GB, not 8.58 B's 103 GB), plus the tail
RG_PERIODS = 2
RG_B, RG_S, RG_STEPS = 2, 4096, 12
RG_LR = (3e-4, 10, 12)  # cosine_schedule(peak, warmup, steps), AdamW
RG_TIMED_FROM = 2  # steps after the first two
RG_CHECK_B, RG_CHECK_S = 1, 1024  # kernels vs plain, bounding the plain loop
# launches a step: the body's 4 RG-LRU and 2 attention layers run their
# forward twice (remat), the tail's 2 RG-LRU layers once
RG_LAUNCHES = {"rg_lru_fwd": 10, "rg_lru_bwd": 6, "flash_fwd": 4,
               "flash_bwd": 2}
RG_MAIN_CKPT = ROOT / "build" / "chip_rg_ckpt"
RG_MAIN_ARGV = ["--arch", RG, "--scale", "small", "--steps", "20",
                "--fail-at", "12", "--checkpoint-every", "10", "--device",
                "cuda", "--ckpt-dir", str(RG_MAIN_CKPT)]
RG_MAIN_LOSSES = 21  # 20 steps, step 11 run twice


def _lru_bwd_inputs(g, B, S, C):
    """The forward's a, b, h0 (``_lru_inputs``), its y from the kernel,
    and normal cotangents g_y, g_last."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops

    a, b, h0 = _lru_inputs(g, B, S, C)
    y, _ = lru_ops.linear_scan(a, b, h0)
    g_y = torch.randn(B, S, C, generator=g, device="cuda")
    g_last = torch.randn(B, C, generator=g, device="cuda")
    return a, y, h0, g_y, g_last


def lru_bwd_errors(a, y, h0, g_y, g_last):
    """The backward kernel against ``ref.linear_scan_bwd``: (max |a - b| /
    (1 + |b|), max |a - b|) over da, db and dh0, and the largest
    difference from its order in plain PyTorch
    (``ref.linear_scan_bwd_chunked``, measured)."""
    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    got = lru_ops.linear_scan_bwd(a, y, h0, g_y, g_last)
    want = lru_ref.linear_scan_bwd(a, y, h0, g_y, g_last)
    order = lru_ref.linear_scan_bwd_chunked(a, y, h0, g_y, g_last,
                                            chunk=lru_ops.TILE_STEPS)
    check((got[2] is None) == (h0 is None), "dh0 with h0 only")
    scaled = absolute = chunked = 0.0
    for x, w, c in zip(got, want, order):
        if w is None:
            continue
        diff = (x - w).abs()
        scaled = max(scaled, float((diff / (1 + w.abs())).max()))
        absolute = max(absolute, float(diff.max()))
        chunked = max(chunked, float((x - c).abs().max()))
    return scaled, absolute, chunked


def _lru_bwd_long_memory(g):
    """B=1 S=4096 C=4096 with the forward's long-memory inputs
    (``_lru_long_memory``), h0 and g_last given: the kernel's and the
    float32 plain version's relative L2 distances from the plain version
    in float64, over da, db and dh0 (the largest of each)."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    B, S, C = 1, 4096, 4096
    base = torch.rand(1, 1, C, generator=g, device="cuda") * 0.0999 + 0.9
    a = base ** torch.sigmoid(torch.randn(B, S, C, generator=g,
                                          device="cuda"))
    b = torch.randn(B, S, C, generator=g, device="cuda")
    h0 = torch.randn(B, C, generator=g, device="cuda")
    y, _ = lru_ops.linear_scan(a, b, h0)
    g_y = torch.randn(B, S, C, generator=g, device="cuda")
    g_last = torch.randn(B, C, generator=g, device="cuda")
    args = (a, y, h0, g_y, g_last)
    exact = lru_ref.linear_scan_bwd(*args, dtype=torch.float64)
    routes = {"e_k": lru_ops.linear_scan_bwd(*args),
              "e_p": lru_ref.linear_scan_bwd(*args)}
    out = {k: max(float((x.double() - w).norm() / w.norm())
                  for x, w in zip(got, exact))
           for k, got in routes.items()}
    out["max_da"] = float(exact[0].abs().max())
    limit = LRU_F64_MARGIN * out["e_p"]
    print(f"  rg_lru backward long memory (B=1 S=4096 C=4096, |da| up to "
          f"{out['max_da']:.1f}): vs float64 e_k {out['e_k']:.3e}, e_p "
          f"{out['e_p']:.3e}, e_k / e_p {out['e_k'] / out['e_p']:.3f}, "
          f"limit {limit:.3e}")
    check(out["e_k"] <= limit, f"rg_lru backward long memory: e_k "
                               f"{out['e_k']} <= {LRU_F64_MARGIN} e_p")
    return out


def phase_rg_train_kernels():
    """(a) The RG-LRU backward kernel against its plain version, bit for
    bit from launch to launch, against float64 with long memory, and
    through autograd; the flash backward at RecurrentGemma's training
    problem on both routes."""
    import torch

    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    g = torch.Generator(device="cuda").manual_seed(8)
    out = {"attributes": lru_ops.attributes(backward=True)}
    tol, n = TOL["float32"], 0
    worst = {"scaled": 0.0, "abs": 0.0, "chunked_order": 0.0}
    for S, C, B, with_h0, with_g_last in itertools.product(
            LRU_BWD_S, LRU_BWD_C, LRU_BWD_B, (True, False), (True, False)):
        a, y, h0, g_y, g_last = _lru_bwd_inputs(g, B, S, C)
        errs = lru_bwd_errors(a, y, h0 if with_h0 else None, g_y,
                              g_last if with_g_last else None)
        label = (f"B={B} S={S} C={C} h0={with_h0} g_last={with_g_last}")
        check(errs[0] <= tol, f"rg_lru backward vs plain, {label}: "
                              f"{errs[0]}")
        for key, e in zip(worst, errs):
            worst[key] = max(worst[key], e)
        n += 1
    out["errors"] = worst
    print(f"  rg_lru backward: {n} cases (S {LRU_BWD_S}, C {LRU_BWD_C}, B "
          f"{LRU_BWD_B}, h0 and g_last or not), largest |a - b| / (1 + |b|)"
          f" over da, db, dh0 {worst['scaled']:.3e} (tol {tol:g}), max abs "
          f"{worst['abs']:.3e}; vs its order in plain PyTorch "
          f"{worst['chunked_order']:.3e} (measured); registers "
          f"{out['attributes']['registers']}, local bytes "
          f"{out['attributes']['local_bytes']}")
    a, y, _, g_y, _ = _lru_bwd_inputs(g, 4, 4096, 4096)
    first = lru_ops.linear_scan_bwd(a, y, None, g_y)
    for i in range(1, LRU_REPEATS):
        again = lru_ops.linear_scan_bwd(a, y, None, g_y)
        check(all(torch.equal(x, z) for x, z in zip(first[:2], again[:2])),
              f"rg_lru backward launch {i} equals launch 0 bit for bit")
    print(f"  rg_lru backward determinism: {LRU_REPEATS} launches at B=4 "
          f"S=4096 C=4096 equal bit for bit ok")
    del a, y, g_y, first, again
    out["long_memory"] = _lru_bwd_long_memory(g)
    # through autograd, as the model reaches it: one backward launch
    a, b, h0 = (t.requires_grad_() for t in _lru_inputs(g, 2, 4096, 4096))
    before = lru_ops.BWD_LAUNCHES
    y, h_last = lru_ops.linear_scan(a, b, h0)
    g_y, g_last = torch.randn_like(y), torch.randn_like(h_last)
    got = torch.autograd.grad([y, h_last], [a, b, h0], [g_y, g_last])
    check(lru_ops.BWD_LAUNCHES == before + 1,
          "autograd launched the backward kernel once")
    want = lru_ref.linear_scan_bwd(a.detach(), y.detach(), h0.detach(), g_y,
                                   g_last)
    out["main"] = max(float(((x - w).abs() / (1 + w.abs())).max())
                      for x, w in zip(got, want))
    out["main_abs"] = max(float((x - w).abs().max())
                          for x, w in zip(got, want))
    check(out["main"] <= tol, f"rg_lru backward through autograd at B=2 "
                              f"S=4096 C=4096: {out['main']}")
    print(f"  rg_lru backward through autograd (B=2 S=4096 C=4096, h0 and "
          f"g_last): 1 launch, vs plain {out['main']:.3e} (max abs "
          f"{out['main_abs']:.3e})")
    del a, b, h0, y, h_last, g_y, g_last, got, want
    B, H, KH, S, D, W = RG_FLASH_BWD
    out["flash_bwd"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = _flash_inputs(g, B, H, KH, S, D, dtype)
        dout = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
        err, absolute = flash_bwd_errors(q, k, v, dout, True, W)
        check(err <= TOL[name], f"flash backward at RecurrentGemma's "
                                f"problem, {name}: {err}")
        out["flash_bwd"][name] = {"scaled": err, "abs": absolute}
        print(f"  flash backward at RecurrentGemma's training problem (B={B}"
              f" H={H} KH={KH} S={S} D={D} window={W} causal {name}): "
              f"{err:.3e} (tol {TOL[name]:g}), max abs {absolute:.3e}")
        del q, k, v, dout
        torch.cuda.empty_cache()
    return out


def phase_rg_train_golden():
    """(b) The small RecurrentGemma against
    ``lm_train_recurrentgemma_small_golden.npz``, through the kernels."""
    from repro_torch.models.params import load_lm_train_golden

    golden = load_lm_train_golden(RG)
    out = lm_train_golden_errors(golden)
    print(f"  small {RG}: loss terms {out['loss']:.2e} (rtol "
          f"{LM_LOSS_RTOL:g}), gradients {out['grads']:.2e} (rtol "
          f"{LM_GRAD_RTOL:g}, every step), parameters after "
          f"{golden.tokens.shape[0]} AdamW steps on the JAX gradients "
          f"{out['params']:.2e} (atol {LM_PARAMS_ATOL:g}); launches a step: "
          f"RG-LRU {out['lru_launches']}, flash {out['launches']}")
    check(out["lru_launches"]["forward"] > 0
          and out["lru_launches"]["backward"] > 0
          and out["launches"]["backward"] > 0,
          "the small RecurrentGemma launched the RG-LRU forward and backward "
          "and the flash backward")
    return out


def _rg_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops

    return {"rg_lru_fwd": lru_ops.LAUNCHES, "rg_lru_bwd": lru_ops.BWD_LAUNCHES,
            "flash_fwd": fa_ops.LAUNCHES, "flash_bwd": fa_ops.BWD_LAUNCHES}


def _zero_rg_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops

    lru_ops.LAUNCHES = lru_ops.BWD_LAUNCHES = 0
    fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0


def _train_vs_plain(model, model32, params, batch, label):
    """(c) The loss and every gradient leaf through the kernels against
    the plain versions on one batch, at the trained weights. In float32
    (the bf16 weights widened) at FULL_F32_REL_TOL, relative L2: the sharp
    check. In bf16 some leaves carry about one digit: at RecurrentGemma's
    trained weights (a loss of some 270) the first attention layer's wq
    gradient sits 0.11 from the float32 plain route through either route
    (measured on the card, NVIDIA H100 80GB HBM3, 700 W), so each bf16
    route is held by its distance from the float32 plain route, as the
    bf16 xLSTM's logits are: the kernels' at most max(FULL_BF16_REL_TOL,
    XLSTM_F32_MARGIN x) the plain versions', leaf by leaf and on the loss;
    the bf16 kernels-vs-plain distance is printed. A leaf whose exact
    gradient is 0 (``lm_zero_grad_leaf``) is measured by its norm over the
    global norm of the float32 plain route's gradients instead: in float32
    under LM_ZERO_GRAD_RTOL, in bf16 by the same margin rule."""
    import torch

    from repro_torch.common.tree import tree_cast

    params32 = tree_cast(params, torch.float32)
    l32, exact = _flat_grads(model32, params32, batch, plain=True)
    l32k, g = _flat_grads(model32, params32, batch)
    del params32
    zero = [k for k in exact if lm_zero_grad_leaf(k)]
    norm = math.sqrt(sum(float(torch.linalg.vector_norm(w)) ** 2
                         for w in exact.values())) if zero else 1.0

    def dist(x, k):
        if lm_zero_grad_leaf(k):
            return float(torch.linalg.vector_norm(x.double())) / norm
        return _l2(x, exact[k])

    f32 = {k: dist(g[k], k) for k in exact if k not in zero}
    f32_zero = max((dist(g[k], k) for k in zero), default=0.0)
    del g
    torch.cuda.empty_cache()
    out = {"float32": {"loss": abs(l32k - l32) / abs(l32),
                       "grads": max(f32.values()),
                       "leaf": max(f32, key=f32.get),
                       "zero_grad_leaves": zero, "zero_grads": f32_zero}}
    lk, gk = _flat_grads(model, params, batch)
    lp, gp = _flat_grads(model, params, batch, plain=True)
    d_k = {k: dist(gk[k], k) for k in exact}
    d_p = {k: dist(gp[k], k) for k in exact}
    kp = {k: _l2(gk[k], gp[k]) for k in exact if k not in zero}
    del gk, gp, exact
    torch.cuda.empty_cache()
    loss_k, loss_p = abs(lk - l32) / abs(l32), abs(lp - l32) / abs(l32)

    def limit(e_p):
        return max(FULL_BF16_REL_TOL, XLSTM_F32_MARGIN * e_p)

    worst = max(d_k, key=lambda k: d_k[k] / limit(d_p[k]))
    out["bfloat16"] = {
        "loss_k": loss_k, "loss_p": loss_p, "leaf": worst,
        "e_k": d_k[worst], "e_p": d_p[worst], "max_e_k": max(d_k.values()),
        "max_e_p": max(d_p.values()), "kernels_vs_plain": max(kp.values()),
        "kernels_vs_plain_leaf": max(kp, key=kp.get),
        "loss_kernels_vs_plain": abs(lk - lp) / abs(lp)}
    b = out["bfloat16"]
    print(f"  {label}, kernels vs plain "
          f"versions: float32 loss {out['float32']['loss']:.2e}, largest "
          f"gradient relative L2 {out['float32']['grads']:.2e} "
          f"({out['float32']['leaf']}) (tol {FULL_F32_REL_TOL:g})"
          + (f", the zero-gradient leaves {f32_zero:.2e} of the norm (tol "
             f"{LM_ZERO_GRAD_RTOL:g})" if zero else "")
          + f"; bf16 from "
          f"the float32 plain route: loss {loss_k:.2e} (kernels) vs "
          f"{loss_p:.2e} (plain), gradients up to {b['max_e_k']:.3e} vs "
          f"{b['max_e_p']:.3e}, nearest its limit {worst}: e_k "
          f"{b['e_k']:.3e}, e_p {b['e_p']:.3e}, limit max("
          f"{FULL_BF16_REL_TOL:g}, {XLSTM_F32_MARGIN:g} e_p); bf16 kernels "
          f"vs plain (measured) loss {b['loss_kernels_vs_plain']:.2e}, "
          f"gradients up to {b['kernels_vs_plain']:.3e} "
          f"({b['kernels_vs_plain_leaf']})")
    check(out["float32"]["loss"] <= FULL_F32_REL_TOL
          and out["float32"]["grads"] <= FULL_F32_REL_TOL,
          "full width float32, kernels vs plain")
    check(f32_zero <= LM_ZERO_GRAD_RTOL,
          f"full width float32, zero-gradient leaves: {f32_zero}")
    check(loss_k <= limit(loss_p),
          f"bf16 loss from float32: kernels {loss_k}, plain {loss_p}")
    for k in d_k:
        check(d_k[k] <= limit(d_p[k]), f"bf16 gradient {k} from float32: "
                                       f"kernels {d_k[k]}, plain {d_p[k]}")
    return out


def phase_rg_train_full():
    """(c) recurrentgemma-9b at every published width, its body cut to
    RG_PERIODS periods, trained by ``launch/train.py::make_step``; then
    ``launch.train.main`` on the small RecurrentGemma across a failure."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    full = get_config(RG)
    cfg = dataclasses.replace(
        full, n_periods=RG_PERIODS,
        n_layers=RG_PERIODS * len(full.body_pattern) + len(full.tail_pattern))
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {RG} at full width (d_model {cfg.d_model}, lru {cfg.lru_width}"
          f", {cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
          f"{cfg.local_window}, chunked_ce {cfg.chunked_ce}, remat "
          f"{cfg.remat}), {cfg.n_layers} of {full.n_layers} layers "
          f"({cfg.layer_kinds}): {n_params / 1e9:.3f} B parameters, "
          f"{cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    # in place: the functional update would hold two copies of the 21 GB
    # of float32 moments
    opt = AdamW(lr=cosine_schedule(*RG_LR), inplace=True)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step = train.make_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, RG_S, RG_B, seed=0)
    losses, step_ms = [], []
    _zero_rg_launches()  # the main path starts here
    t0 = time.perf_counter()
    for i in range(RG_STEPS):
        batch = pipe.batch_at(i)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state["params"], state["opt"], loss = step(state["params"],
                                                   state["opt"], batch)
        end.record()
        losses.append(float(loss))
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    seconds = time.perf_counter() - t0
    launches = _rg_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / RG_STEPS for k, v in launches.items()}
    check(per_step == RG_LAUNCHES, f"launches a step: {per_step}")
    check(bool(np.all(np.isfinite(losses))), f"finite losses: {losses}")
    check(float(np.mean(losses[-4:])) < losses[0],
          f"the loss falls: {losses[0]} -> {np.mean(losses[-4:])}")
    median = statistics.median(step_ms[RG_TIMED_FROM:])
    out = {"layers": cfg.n_layers, "params": n_params, "losses": losses,
           "step_ms": step_ms, "median_step_ms": median,
           "tokens_per_s": RG_B * RG_S / median * 1e3,
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "launches_per_step": per_step, "seconds": seconds}
    print(f"  {RG_STEPS} steps of B {RG_B} x S {RG_S} through make_step "
          f"(AdamW, cosine_schedule{RG_LR}) in {seconds:.1f} s: losses "
          f"{losses[0]:.4f} -> mean of the last four "
          f"{np.mean(losses[-4:]):.4f}; step (CUDA events, median after "
          f"{RG_TIMED_FROM}) {median:.2f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s; peak memory {out['peak_memory_gb']:.2f} GB; launches "
          f"a step {per_step}")

    batch = pipe.batch_at(RG_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device_us, top = _top_device(prof)
    port = _port_device(prof)
    split = _device_by_name(prof, FLASH_BWD_KERNELS)
    out["profile"] = {
        "wall_s": wall, "device_s": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "top": [{"name": k[:90], "us": us, "count": c} for us, c, k in top],
        "port_kernels": {k: {"us": us, "count": c}
                         for k, (us, c) in port.items()},
        "flash_bwd_split": {k: {"us": us, "count": c}
                            for k, (us, c) in split.items()}}
    print(f"  profiled step: {wall * 1e3:.1f} ms wall, {device_us / 1e3:.1f} "
          f"ms of device activity, idle share "
          f"{out['profile']['device_idle_share']:.4f}; the port's kernels: "
          + ", ".join(f"{k} {us / 1e3:.3f} ms x{c} ({us / device_us:.2%})"
                      for k, (us, c) in port.items()) + "; top device "
          "entries:")
    for us, c, k in top:
        print(f"    {us:10.1f} us x{c:4d}  {k[:90]}")
    params = state.pop("params")
    del state, batch
    torch.cuda.empty_cache()
    check_pipe = TokenPipeline(cfg.vocab_size, RG_CHECK_S, RG_CHECK_B,
                               seed=0)
    out["vs_plain"] = _train_vs_plain(
        model, build_model(dataclasses.replace(cfg, dtype="float32")),
        params, check_pipe.batch_at(0),
        f"full width at B {RG_CHECK_B} x S {RG_CHECK_S}")
    del params
    torch.cuda.empty_cache()

    shutil.rmtree(RG_MAIN_CKPT, ignore_errors=True)
    _zero_rg_launches()  # the entry point's run starts here
    t0 = time.perf_counter()
    result = train.main(RG_MAIN_ARGV)
    main_launches = _rg_launches()  # ... and ends here
    main_losses = result["losses"]
    check(len(main_losses) == RG_MAIN_LOSSES and result["restarts"] == 1,
          f"{len(main_losses)} losses, {result['restarts']} restarts")
    check(bool(np.all(np.isfinite(main_losses))), "every loss is finite")
    check(main_launches["rg_lru_bwd"] > 0 and main_launches["flash_bwd"] > 0,
          f"main launched the backward kernels: {main_launches}")
    out["main"] = {"seconds": time.perf_counter() - t0,
                   "losses": main_losses, "restarts": result["restarts"],
                   "launches": main_launches,
                   "events": [(e.step, e.kind, e.detail)
                              for e in result["events"]]}
    print(f"  launch.train.main({' '.join(RG_MAIN_ARGV)}): "
          f"{out['main']['seconds']:.1f} s; {len(main_losses)} losses, "
          f"{main_losses[0]:.4f} -> {main_losses[-1]:.4f}; restarts "
          f"{result['restarts']}; events {out['main']['events']}; launches "
          f"{main_launches}")
    torch.cuda.empty_cache()
    return out


def time_lru_bwd(g):
    """(d) The backward kernel at LRU_BWD_TIMED (the model passes no h0 and
    no g_last): back to back and in a CUDA graph, its byte bound (a, g, y
    read, da, db written: 20 bytes a (b, t, c)), TB/s, scratch, and the
    plain version's time."""
    from repro_torch.kernels.rg_lru import ops as lru_ops
    from repro_torch.kernels.rg_lru import ref as lru_ref

    rows = {}
    for B, S, C in LRU_BWD_TIMED:
        a, y, _, g_y, _ = _lru_bwd_inputs(g, B, S, C)

        def call():
            return lru_ops.linear_scan_bwd(a, y, None, g_y)

        ms = cuda_ms(call, 50)
        nbytes = 20 * B * S * C
        row = {"shape": f"B={B} S={S} C={C} float32", "ms": ms,
               "graph_ms": graph_ms(call),
               "plain_ms": cuda_ms(
                   lambda: lru_ref.linear_scan_bwd(a, y, None, g_y), 2),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": None, "bytes": nbytes,
               "tb_per_s": nbytes / ms / 1e9,
               "scratch_bytes": lru_ops.scratch_bytes(B, S, C)}
        rows[row["shape"]] = row
        print(f"  rg_lru backward {row['shape']}: kernel {ms:.4f} ms "
              f"({row['tb_per_s']:.2f} TB/s), in a CUDA graph "
              f"{row['graph_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / ms:.1%}; {nbytes / 1e6:.1f} MB), plain "
              f"{row['plain_ms']:.2f} ms, scratch "
              f"{row['scratch_bytes'] / 1e6:.2f} MB; no PyTorch call computes "
              f"a linear recurrence")
        del a, y, g_y
    return rows


def phase_rg_train():
    import torch

    print(f"[23] RecurrentGemma training: the RG-LRU backward kernel vs its "
          f"plain version, the small RecurrentGemma's loss, gradients and "
          f"AdamW steps vs the JAX package's "
          f"(lm_train_recurrentgemma_small_golden.npz), {RG} at full width "
          f"with {RG_PERIODS} body periods (B {RG_B} x S {RG_S}, "
          f"{RG_STEPS} steps), launch.train.main across a failure, and the "
          f"backwards' times")
    out = {}
    t0 = time.perf_counter()
    out["kernel_errors"] = phase_rg_train_kernels()
    print(f"    -- (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["golden"] = phase_rg_train_golden()
    print(f"    -- (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["full"] = phase_rg_train_full()
    print(f"    -- (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(9)
    out["timing"] = {"rg_lru_bwd": time_lru_bwd(g),
                     "flash_bwd": time_flash_bwd(g, *RG_FLASH_BWD)}
    print(f"    -- (d) {time.perf_counter() - t0:.1f} s")
    return out


# -------------------------------------------- xLSTM training (phase [24])
XL = "xlstm-1.3b"
# (a) the mLSTM backward kernel against ref.mlstm_chunkwise_bwd, per
# tensor as max |a - b| / max |b| (|dk| runs into the thousands, so
# |a - b| <= TOL (1 + |b|) cannot hold it): S around the 16-, 64- and
# 256-row chunks and long, head dims at and past the 32-column tiles and
# the model's 1024, B x H 1 and 8
MLSTM_BWD_S = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 256, 257,
               1000, 4096)
MLSTM_BWD_HD = (32, 96, 1024)
MLSTM_BWD_CHUNK = (64, 256)
MLSTM_BWD_BH = ((1, 1), (2, 4))
# the tensor-core route's tiles: 128 rows a score or product tile, 64 rows
# a chunk step and 64 columns a TMA box, 128 (d, e) a dC tile and 256
# columns a product tile; hd 160 ends a box, a dC tile and a product tile
# mid-way, at a few S only (the phase's time)
MLSTM_BWD_EDGE_HD, MLSTM_BWD_EDGE_S = 160, (65, 129, 257, 1000)
MLSTM_BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The float32 route against the plain version in float64: relative L2 at
# most MLSTM_BWD_F64_MARGIN times the float32 plain version's own, per
# tensor, or MLSTM_BWD_F64_FLOOR where the plain version sits closer than
# that to float64 (a single row's few terms can round to it exactly).
MLSTM_BWD_F64_MARGIN = 2.0
MLSTM_BWD_F64_FLOOR = 1e-6
MLSTM_BWD_REPEATS = 20
# timed at the table's shape (the forward's) and at the cell's
MLSTM_BWD_TIMED = ((1, 4096), (4, 2048))  # (B, S); H 4, hd 1024, chunk 256
MLSTM_BWD_DESIGN = ("two routes by input type, no atomics. bf16: wgmma + "
                    "TMA from q/k/v/g in place (no float32 copies), float32 "
                    "operands as three bf16 planes; the forward's gates, "
                    "states and scores recomputed, no h (<g_i, h_i> from "
                    "G = u v^T and C u), y = C u and dW (128-row tiles), "
                    "the dC walk as the states kernel mirrored (128 x 128 "
                    "tiles, m64n128), dq/dk/dv as 128 x 256 tiles of the "
                    "state and chunk products (m64n256), dn and the gates "
                    "on CUDA cores. float32: CUDA cores, the float32 "
                    "forward recomputed (h too), dC and dn walked from the "
                    "last chunk, dW, dq/dk/dv as 64 x 64 tiles, the gates' "
                    "sums in float64 and a reverse scan")
MLSTM_BWD_NAMES = ("dq", "dk", "dv", "dlog_i", "dlog_f")
# (c) the full-width cell: every published width and all 48 layers
# (1.918 B parameters: bf16 weights and gradients and float32 moments,
# 23 GB), B 4 x S 2048 (the context the xLSTM paper trains its 1.3B model
# at), bf16 seed-0 weights, through make_step with AdamW in place
XL_B, XL_S, XL_STEPS = 4, 2048, 6
XL_LR = (1e-3, 1, 6)  # cosine_schedule(peak, warmup, steps)
XL_TIMED_FROM = 2  # steps after the first two
# the profiled step's S: a full step's trace holds some 10^6 host events,
# most of them the sLSTM's loop
XL_PROFILE_S = 512
XL_CHECK_B, XL_CHECK_S = 1, 512  # kernels vs plain at the trained weights
# launches a step: the 42 mLSTM layers' forward twice (remat), backward
# once
XL_LAUNCHES = {"mlstm_fwd": 84, "mlstm_bwd": 42}
XL_MAIN_CKPT = ROOT / "build" / "chip_xlstm_ckpt"
XL_MAIN_ARGV = ["--arch", XL, "--scale", "small", "--seq", "300", "--steps",
                "20", "--fail-at", "12", "--checkpoint-every", "10",
                "--device", "cuda", "--ckpt-dir", str(XL_MAIN_CKPT)]
XL_MAIN_LOSSES = 21  # 20 steps, step 11 run twice


def _mlstm_bwd_inputs(g, B, S, H, hd, dtype):
    """``_mlstm_inputs`` and a normal cotangent of h. A single row gets
    log_i = -3, where the normaliser's floor exp(-m) wins and every input
    reaches h (where |den| wins, h_0 = sign(<q_0, k_0>) v_0 and only v has
    a gradient: the others are rounding noise)."""
    import torch

    q, k, v, li, lf = _mlstm_inputs(g, B, S, H, hd, dtype)
    if S == 1:
        li = torch.full_like(li, -3.0)
    g_h = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
    return q, k, v, li, lf, g_h


def _tensor_rel(a, b):
    """max |a - b| / max |b| of two tensors, in the wider of their types
    and at least float32 (0 where both are 0)."""
    import torch

    wide = (torch.float64 if torch.float64 in (a.dtype, b.dtype)
            else torch.float32)
    a, b = a.to(wide), b.to(wide)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def mlstm_bwd_errors(args, chunk, float64=False):
    """The backward kernel against ``ref.mlstm_chunkwise_bwd`` on the same
    inputs, per tensor (max |a - b| / max |b|; and the largest absolute
    difference); with ``float64``, each one's relative L2 distance from
    the plain version in float64 and the kernel's over the plain
    version's (or over MLSTM_BWD_F64_FLOOR)."""
    import torch

    from repro_torch.kernels.mlstm import ops

    got = ops.mlstm_chunkwise_bwd(*args, chunk=chunk)
    want = ops._plain_bwd(*args, chunk)
    out = {"rel": max(_tensor_rel(a, b) for a, b in zip(got, want)),
           "abs": max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))}
    if float64:
        exact = ops._plain_bwd(*(t.double() for t in args), chunk)
        out["f64_ratio"] = 0.0
        for name, a, b, e in zip(MLSTM_BWD_NAMES, got, want, exact):
            e_k, e_p = _l2(a.double(), e), _l2(b.double(), e)
            ratio = e_k / max(e_p, MLSTM_BWD_F64_FLOOR)
            if ratio >= out["f64_ratio"]:
                out.update(f64_ratio=ratio, f64_tensor=name, f64_e_k=e_k,
                           f64_e_p=e_p)
        del exact
    del got, want
    torch.cuda.empty_cache()
    return out


def phase_xlstm_train_kernels():
    """(a) The mLSTM backward kernel against its plain version over the
    sweep, bit for bit from launch to launch, on the reference's state
    overflow, and through autograd."""
    import torch

    from repro_torch.kernels.mlstm import ops

    g = torch.Generator(device="cuda").manual_seed(10)
    out = {"attributes": {
        route: {k: ops.backward_attributes(k, route) for k in names}
        for route, names in ops.BACKWARD_KERNELS.items()}}
    # as phase [9] holds the forward's: no wgmma kernel spills
    tc_attrs = out["attributes"]["tensor_core"]
    check(all(a["local_bytes"] == 0 for k, a in tc_attrs.items()
              if k not in ("dn", "dgates")),
          f"the mlstm backward's tensor-core kernels spill no registers: "
          f"{tc_attrs}")
    worst = {"float32": 0.0, "bfloat16": 0.0, "f64_ratio": 0.0,
             "float32_abs": 0.0, "bfloat16_abs": 0.0}
    n = 0
    cases = itertools.chain(
        itertools.product(MLSTM_BWD_S, MLSTM_BWD_HD, MLSTM_BWD_CHUNK,
                          MLSTM_BWD_BH, (torch.float32, torch.bfloat16)),
        itertools.product(MLSTM_BWD_EDGE_S, (MLSTM_BWD_EDGE_HD,),
                          MLSTM_BWD_CHUNK, MLSTM_BWD_BH,
                          (torch.float32, torch.bfloat16)))
    for S, hd, chunk, (B, H), dtype in cases:
        name = str(dtype).split(".")[-1]
        args = _mlstm_bwd_inputs(g, B, S, H, hd, dtype)
        e = mlstm_bwd_errors(args, chunk, float64=name == "float32")
        label = f"B={B} H={H} S={S} hd={hd} chunk={chunk} {name}"
        check(e["rel"] <= MLSTM_BWD_RTOL[name],
              f"mlstm backward vs plain, {label}: {e['rel']}")
        worst[name] = max(worst[name], e["rel"])
        worst[f"{name}_abs"] = max(worst[f"{name}_abs"], e["abs"])
        if name == "float32":
            check(e["f64_ratio"] <= MLSTM_BWD_F64_MARGIN,
                  f"mlstm backward vs float64, {label}: {e['f64_tensor']} "
                  f"e_k {e['f64_e_k']:.3e}, e_p {e['f64_e_p']:.3e}")
            if e["f64_ratio"] >= worst["f64_ratio"]:
                worst.update(f64_ratio=e["f64_ratio"], f64_case=label,
                             f64_tensor=e["f64_tensor"])
        n += 1
        del args
    out["errors"] = worst
    print(f"  mlstm backward: {n} cases (S {MLSTM_BWD_S}, hd {MLSTM_BWD_HD}, "
          f"chunk {MLSTM_BWD_CHUNK}, (B, H) {MLSTM_BWD_BH}; hd "
          f"{MLSTM_BWD_EDGE_HD} at S {MLSTM_BWD_EDGE_S}; float32 on "
          f"{ops.bwd_route(torch.float32)}, bf16 on "
          f"{ops.bwd_route(torch.bfloat16)}), largest max |a - b| / max |b| "
          f"over dq, dk, dv, dlog_i, dlog_f: float32 {worst['float32']:.3e} "
          f"(tol {MLSTM_BWD_RTOL['float32']:g}), bf16 "
          f"{worst['bfloat16']:.3e} (tol {MLSTM_BWD_RTOL['bfloat16']:g}); "
          f"float32 vs float64 e_k / e_p up to {worst['f64_ratio']:.3f} "
          f"({worst['f64_tensor']}, {worst['f64_case']}; limit "
          f"{MLSTM_BWD_F64_MARGIN:g})")
    for route, attrs in out["attributes"].items():
        print(f"  mlstm backward's {route} kernels (registers, local "
              f"bytes, shared memory bytes): " + ", ".join(
                  f"{k} {a['registers']}, {a['local_bytes']}, "
                  f"{a['static_smem_bytes'] + a['dynamic_smem_bytes']}"
                  for k, a in attrs.items()))
    # 20 launches at the table's shape, bit for bit
    args = _mlstm_bwd_inputs(g, 1, 4096, 4, 1024, torch.bfloat16)
    first = ops.mlstm_chunkwise_bwd(*args, chunk=MLSTM_CHUNK)
    for i in range(1, MLSTM_BWD_REPEATS):
        again = ops.mlstm_chunkwise_bwd(*args, chunk=MLSTM_CHUNK)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"mlstm backward launch {i} equals launch 0 bit for bit")
    print(f"  mlstm backward determinism: {MLSTM_BWD_REPEATS} launches at B=1 "
          f"H=4 S=4096 hd=1024 chunk=256 bf16 equal bit for bit ok")
    del args, first, again
    # the reference's state overflow (ROADMAP.md section 3): every key
    # decay is inf, so dk, dv and the gates' gradients are NaN in every
    # entry of both versions (as in the reference's, tests/
    # test_torch_xlstm_train.py), dq finite; through both routes
    q, k, v, _, _, g_h = _mlstm_bwd_inputs(g, 1, 4, 1, 32, torch.float32)
    li = torch.zeros(1, 4, 1, device="cuda")
    lf = torch.tensor([-100.0, -0.5, -0.5, -0.5], device="cuda").view(1, 4, 1)
    out["overflow"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x = [t.to(dtype) for t in (q, k, v)]
        got = ops.mlstm_chunkwise_bwd(*x, li, lf, g_h.to(dtype), chunk=4)
        want = ops._plain_bwd(*x, li, lf, g_h.to(dtype), 4)
        for tensor, a, b in zip(MLSTM_BWD_NAMES, got, want):
            check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
                  f"mlstm backward overflow ({name}): {tensor}'s non-finite "
                  f"entries are the plain version's")
        check(bool(torch.isfinite(got[0]).all())
              and _tensor_rel(got[0], want[0]) <= MLSTM_BWD_RTOL[name],
              f"mlstm backward overflow ({name}): dq finite and close")
        out["overflow"][name] = {tensor: int((~torch.isfinite(a)).sum())
                                 for tensor, a in zip(MLSTM_BWD_NAMES, got)}
    print(f"  mlstm backward on the reference's state overflow: non-finite "
          f"entries {out['overflow']} (of 128 / 4), as the plain version's "
          f"on both routes; dq within {MLSTM_BWD_RTOL['float32']:g} "
          f"(float32), {MLSTM_BWD_RTOL['bfloat16']:g} (bf16)")
    # through autograd at the cell's shape, as the model reaches it: one
    # backward launch
    q, k, v, li, lf, g_h = _mlstm_bwd_inputs(g, XL_B, XL_S, 4, 1024,
                                             torch.bfloat16)
    leaves = [t.requires_grad_() for t in (q, k, v, li, lf)]
    before = ops.BWD_LAUNCHES
    h, _ = ops.mlstm_chunkwise(*leaves, chunk=MLSTM_CHUNK)
    got = torch.autograd.grad(h, leaves, g_h)
    check(ops.BWD_LAUNCHES == before + 1,
          "autograd launched the mLSTM backward kernel once")
    want = ops._plain_bwd(*(t.detach() for t in leaves), g_h, MLSTM_CHUNK)
    out["main"] = max(_tensor_rel(a, b) for a, b in zip(got, want))
    out["main_abs"] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
    check(out["main"] <= MLSTM_BWD_RTOL["bfloat16"],
          f"mlstm backward through autograd: {out['main']}")
    print(f"  mlstm backward through autograd (B={XL_B} H=4 S={XL_S} hd=1024 "
          f"bf16): 1 launch, vs plain {out['main']:.3e} (max abs "
          f"{out['main_abs']:.3e})")
    del q, k, v, li, lf, g_h, leaves, h, got, want
    torch.cuda.empty_cache()
    return out


def phase_xlstm_train_golden():
    """(b) The small xLSTM against ``lm_train_xlstm_small_golden.npz``,
    through the kernels."""
    from repro_torch.models.params import load_lm_train_golden

    golden = load_lm_train_golden(XL)
    out = lm_train_golden_errors(golden, float64_anchor=True)
    print(f"  small {XL}: loss terms {out['loss']:.2e} (rtol "
          f"{LM_LOSS_RTOL:g}), gradients {out['grads']:.2e} (rtol "
          f"{LM_GRAD_RTOL:g}, every step; {out['anchored']} leaves past it "
          f"held within {out['anchored_grads']:.2e} of the float64 "
          f"evaluation, as JAX's; ri/b {out['zero_grads']:.2e} of the norm, "
          f"limit {LM_ZERO_GRAD_RTOL:g}), parameters after "
          f"{golden.tokens.shape[0]} AdamW steps on the JAX gradients "
          f"{out['params']:.2e} (atol {LM_PARAMS_ATOL:g}); mLSTM launches a "
          f"step {out['mlstm_launches']}")
    check(out["mlstm_launches"]["forward"] > 0
          and out["mlstm_launches"]["backward"] > 0,
          "the small xLSTM launched the mLSTM forward and backward")
    return out


def _xl_launches():
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    return {"mlstm_fwd": mlstm_ops.LAUNCHES,
            "mlstm_bwd": mlstm_ops.BWD_LAUNCHES}


def _zero_xl_launches():
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    mlstm_ops.LAUNCHES = mlstm_ops.BWD_LAUNCHES = 0


@contextlib.contextmanager
def slstm_host_time():
    """Wall time on the host of every ``slstm_block`` call (its forward,
    the first and the recompute; the block enqueues its steps and does
    not wait for the card), summed into the yielded dict."""
    from repro_torch.models import recurrent as rec

    total = {"seconds": 0.0, "calls": 0}
    inner = rec.slstm_block

    def timed_block(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            total["seconds"] += time.perf_counter() - t0
            total["calls"] += 1

    rec.slstm_block = timed_block
    try:
        yield total
    finally:
        rec.slstm_block = inner


def _slstm_layer_seconds(params, cfg, B, S):
    """The first sLSTM layer of ``params`` at (B, S): the host time of its
    forward under grad and the wall time of its backward (host-bound,
    some ten small launches a step), after a warm-up at S = 16."""
    import torch

    from repro_torch.common.tree import flatten, unflatten_as
    from repro_torch.models import recurrent as rec

    i = cfg.body_pattern.index("slstm")
    mix = params["body"][i]["mix"]  # leaves stacked over the periods
    p = unflatten_as(mix, {k: v[0] for k, v in flatten(mix).items()})
    out = {}
    for s in (16, S):  # the first warms up
        x = torch.randn(B, s, cfg.d_model, device="cuda",
                        dtype=getattr(torch, cfg.dtype)).requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = rec.slstm_block(p, cfg, x)
        out["forward_host_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.autograd.grad(y, [x], torch.ones_like(y))
        torch.cuda.synchronize()
        out["backward_s"] = time.perf_counter() - t0
        del x, y
    return out


def phase_xlstm_train_full():
    """(c) xlstm-1.3b at every published width and full depth, trained by
    ``launch/train.py::make_step``; then ``launch.train.main`` on the
    small xLSTM across a failure."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = get_config(XL)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == XLSTM_PARAMS, f"{n_params} parameters")
    print(f"  {XL} at every published width and full depth (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of hd "
          f"{2 * cfg.d_model // cfg.n_heads}, vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} layers: {cfg.layer_kinds.count('mlstm')} mLSTM, "
          f"{cfg.layer_kinds.count('slstm')} sLSTM; remat {cfg.remat}): "
          f"{n_params:,} parameters, {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    # in place: the functional update would hold two copies of the 15 GB
    # of float32 moments
    opt = AdamW(lr=cosine_schedule(*XL_LR), inplace=True)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step = train.make_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, XL_S, XL_B, seed=0)
    losses, step_ms = [], []
    _zero_xl_launches()  # the main path starts here
    t0 = time.perf_counter()
    with slstm_host_time() as slstm:
        for i in range(XL_STEPS):
            batch = pipe.batch_at(i)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state["params"], state["opt"], loss = step(state["params"],
                                                       state["opt"], batch)
            end.record()
            losses.append(float(loss))
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
    seconds = time.perf_counter() - t0
    launches = _xl_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / XL_STEPS for k, v in launches.items()}
    check(per_step == XL_LAUNCHES, f"launches a step: {per_step}")
    check(bool(np.all(np.isfinite(losses))), f"finite losses: {losses}")
    check(float(np.mean(losses[-4:])) < losses[0],
          f"the loss falls: {losses[0]} -> {np.mean(losses[-4:])}")
    median = statistics.median(step_ms[XL_TIMED_FROM:])
    out = {"layers": cfg.n_layers, "params": n_params, "losses": losses,
           "step_ms": step_ms, "median_step_ms": median,
           "tokens_per_s": XL_B * XL_S / median * 1e3,
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "launches_per_step": per_step, "seconds": seconds,
           "slstm_forward_host_s_per_step": slstm["seconds"] / XL_STEPS,
           "slstm_calls_per_step": slstm["calls"] / XL_STEPS}
    print(f"  {XL_STEPS} steps of B {XL_B} x S {XL_S} through make_step "
          f"(AdamW in place, cosine_schedule{XL_LR}) in {seconds:.1f} s: "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; step (CUDA "
          f"events, median after {XL_TIMED_FROM}) {median:.1f} ms, "
          f"{out['tokens_per_s']:.0f} tokens/s; peak memory "
          f"{out['peak_memory_gb']:.2f} GB; launches a step {per_step}; the "
          f"sLSTM blocks' forwards (both passes) "
          f"{out['slstm_forward_host_s_per_step']:.2f} s of host time a step "
          f"({out['slstm_calls_per_step']:.0f} calls)")
    sl = out["slstm_layer"] = _slstm_layer_seconds(state["params"], cfg,
                                                   XL_B, XL_S)
    print(f"  one sLSTM layer at B {XL_B} x S {XL_S}: forward "
          f"{sl['forward_host_s']:.2f} s of host time, backward "
          f"{sl['backward_s']:.2f} s of wall time")

    out["seconds_parts"] = {"steps": seconds}
    t0 = time.perf_counter()
    batch = TokenPipeline(cfg.vocab_size, XL_PROFILE_S, XL_B,
                          seed=0).batch_at(XL_STEPS)
    # the device's activity only: the host's some 10^5 ops a step would
    # cost more to record and to average than the step takes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    prof = _DeviceRows(prof)
    device_us, top = _top_device(prof)
    port = _port_device(prof)
    mlstm = _device_by_name(prof, ("mlstm_",))
    split = _mlstm_split(prof)
    out["profile"] = {
        "shape": f"B={XL_B} S={XL_PROFILE_S}", "wall_s": wall,
        "device_s": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "top": [{"name": k[:90], "us": us, "count": c} for us, c, k in top],
        "port_kernels": {k: {"us": us, "count": c}
                         for k, (us, c) in port.items()},
        "mlstm_us": mlstm.get("mlstm_", (0.0, 0))[0],
        "mlstm_split": {k: {"us": us, "count": c}
                        for k, (us, c) in split.items()}}
    print(f"  profiled step at B {XL_B} x S {XL_PROFILE_S}: {wall * 1e3:.1f} "
          f"ms wall, {device_us / 1e3:.1f} ms of device activity, idle share "
          f"{out['profile']['device_idle_share']:.4f}; the mLSTM kernels "
          f"{out['profile']['mlstm_us'] / 1e3:.3f} ms (" + ", ".join(
              f"{k} {us / 1e3:.3f} ms x{c}" for k, (us, c) in split.items())
          + "); top device entries:")
    for us, c, k in top:
        print(f"    {us:10.1f} us x{c:6d}  {k[:90]}")
    del prof
    out["seconds_parts"]["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = state.pop("params")
    del state, batch
    torch.cuda.empty_cache()
    check_pipe = TokenPipeline(cfg.vocab_size, XL_CHECK_S, XL_CHECK_B,
                               seed=0)
    out["vs_plain"] = _train_vs_plain(
        model, build_model(dataclasses.replace(cfg, dtype="float32")),
        params, check_pipe.batch_at(0),
        f"full width at B {XL_CHECK_B} x S {XL_CHECK_S}")
    del params
    torch.cuda.empty_cache()
    out["seconds_parts"]["vs_plain"] = time.perf_counter() - t0

    shutil.rmtree(XL_MAIN_CKPT, ignore_errors=True)
    _zero_xl_launches()  # the entry point's run starts here
    t0 = time.perf_counter()
    result = train.main(XL_MAIN_ARGV)
    main_launches = _xl_launches()  # ... and ends here
    main_losses = result["losses"]
    check(len(main_losses) == XL_MAIN_LOSSES and result["restarts"] == 1,
          f"{len(main_losses)} losses, {result['restarts']} restarts")
    check(bool(np.all(np.isfinite(main_losses))), "every loss is finite")
    check(main_launches["mlstm_bwd"] > 0,
          f"main launched the mLSTM backward kernel: {main_launches}")
    out["main"] = {"seconds": time.perf_counter() - t0,
                   "losses": main_losses, "restarts": result["restarts"],
                   "launches": main_launches,
                   "events": [(e.step, e.kind, e.detail)
                              for e in result["events"]]}
    print(f"  launch.train.main({' '.join(XL_MAIN_ARGV)}): "
          f"{out['main']['seconds']:.1f} s; {len(main_losses)} losses, "
          f"{main_losses[0]:.4f} -> {main_losses[-1]:.4f}; restarts "
          f"{result['restarts']}; events {out['main']['events']}; launches "
          f"{main_launches}")
    out["seconds_parts"]["main"] = out["main"]["seconds"]
    print("  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                    out["seconds_parts"].items()))
    torch.cuda.empty_cache()
    return out


def mlstm_bwd_flops(B, H, S, hd, chunk):
    """The backward's operations at these shapes, from what this call's
    data needs: per chunk of Lc rows, five products over its causal (i, j)
    pairs (q k^T, g v^T, dS k, dS^T q, W^T u: 2 hd flops a pair each) and
    five over hd x hd (C entering the chunk, C u, dC' v, dC'^T k and the
    dC carry: 2 Lc hd^2 flops each). The float32 route also recomputes q C
    and W v for h (a sixth of each), which the tensor-core route, deriving
    <g_i, h_i> from G = u v^T and C u, does not."""
    L = min(chunk, S)
    chunks = [min(L, S - s0) for s0 in range(0, S, L)]
    pairs = sum(n * (n + 1) // 2 for n in chunks)
    return B * H * 10 * (pairs * hd + S * hd * hd)


def time_mlstm_bwd(g):
    """(d) The backward kernel at MLSTM_BWD_TIMED on both routes, bf16
    (the tensor-core route, what training runs) and float32 (the CUDA-core
    route), back to back: TFLOP/s, its bound from its operations at each
    route's peak rate (the bf16 tensor cores', the float32 CUDA cores'),
    scratch and the plain version's time."""
    import torch

    from repro_torch.kernels.mlstm import ops

    rows = {}
    for (B, S), dtype in itertools.product(MLSTM_BWD_TIMED,
                                           (torch.bfloat16, torch.float32)):
        H, hd, L = 4, 1024, MLSTM_CHUNK
        name = str(dtype).split(".")[-1]
        args = _mlstm_bwd_inputs(g, B, S, H, hd, dtype)

        def call():
            return ops.mlstm_chunkwise_bwd(*args, chunk=L)

        ms = cuda_ms(call, 10)
        plain = cuda_ms(lambda: ops._plain_bwd(*args, L), 1)
        flops = mlstm_bwd_flops(B, H, S, hd, L)
        # q, k, v, g read and dq, dk, dv written in the input type; the
        # gates read and their gradients written in float32
        nbytes = 7 * args[0].nbytes + 4 * args[3].nbytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # the peak rate of the inputs' type: the tensor cores' for bf16
        rate = BF16_FLOP_PER_S if name == "bfloat16" else F32_FLOP_PER_S
        t_ops = flops / rate * 1e3
        row = {"shape": f"B={B} H={H} S={S} hd={hd} chunk={L} {name}",
               "route": ops.bwd_route(dtype),
               "ms": ms, "plain_ms": plain, "library_ms": None,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "cuda_core_bound_ms": f32_bound_ms(flops, nbytes),
               "tensor_core_bound_ms": max(flops / BF16_FLOP_PER_S * 1e3,
                                           t_bytes),
               "flops": flops, "bytes": nbytes,
               "tflop_per_s": flops / ms / 1e9,
               "scratch_bytes": ops.bwd_scratch_bytes(B, H, S, hd, L, dtype)}
        rows[row["shape"]] = row
        print(f"  mlstm backward {row['shape']} ({row['route']} route): "
              f"kernel {ms:.4f} ms ({row['tflop_per_s']:.2f} TFLOP/s of "
              f"{flops / 1e9:.1f} GFLOP), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']} at the route's rate, "
              f"{row['bound_ms'] / ms:.1%}; at the bf16 tensor-core rate "
              f"{row['tensor_core_bound_ms']:.4f} ms, at the float32 "
              f"CUDA-core rate {row['cuda_core_bound_ms']:.4f} ms), plain "
              f"{plain:.2f} ms, scratch {row['scratch_bytes'] / 1e6:.1f} MB; "
              f"no PyTorch call computes it")
        del args
        torch.cuda.empty_cache()
    return rows


def phase_xlstm_train():
    import torch

    print(f"[24] xLSTM training: the mLSTM backward kernel vs its plain "
          f"version, the small xLSTM's loss, gradients and AdamW steps vs "
          f"the JAX package's (lm_train_xlstm_small_golden.npz), {XL} at "
          f"every published width and full depth (B {XL_B} x S {XL_S}, "
          f"{XL_STEPS} steps), launch.train.main across a failure, and the "
          f"backward's time")
    out = {}
    t0 = time.perf_counter()
    out["kernel_errors"] = phase_xlstm_train_kernels()
    print(f"    -- (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["golden"] = phase_xlstm_train_golden()
    print(f"    -- (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["full"] = phase_xlstm_train_full()
    print(f"    -- (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["timing"] = time_mlstm_bwd(
        torch.Generator(device="cuda").manual_seed(11))
    print(f"    -- (d) {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------ DeepSeek-V2-Lite training (phase [25])
DS = "deepseek-v2-lite-16b"
# (a) the flash backward at the latent attention's head-dim pairs against
# the plain version's autograd: (192, 128) on both routes, the small
# DeepSeek's (24, 16) on the float32 route (bf16 refuses it); S around the
# 64-row tiles up to 4096, T = S and about S / 2, H = KH (MLA has no
# GQA), causal
DS_BWD_PAIRS = (((192, 128), ("float32", "bfloat16")), ((24, 16),
                                                        ("float32",)))
DS_BWD_S = (1, 63, 64, 65, 129, 777, 4096)
DS_BWD_HEADS = (4, 16)
# the timed problems (B, H, KH, S, D, window, DV), causal: DeepSeek's
# training attention, and the small DeepSeek's in (c)'s run of main (B 8
# x S 256, H = KH = 4), which only the float32 route takes
DS_FLASH_BWD = (2, 16, 16, 4096, 192, 0, 128)
DS_SMALL_FLASH_BWD = (8, 4, 4, 256, 24, 0, 16)
DS_FLASH_DESIGN = ("(192, 128): dV and dK in separate blocks (S^T over 192, "
                   "dP^T and dV over 128), dK += dS^T Q and dQ += dS K as "
                   "wgmma m64n128 + m64n64 on the same A; Q/K tiles 3 and "
                   "V/dO tiles 2 column blocks of 64; (24, 16) on the CUDA "
                   "cores only, a thread's last dQ/dK column guarded")
# (c) the full-width cell: every published width, the body cut from 26
# periods to DS_PERIODS (the dense layer 0 and DS_PERIODS MLA-MoE layers:
# 2.84 B parameters' weights, gradients and float32 moments are 34 GB;
# the full depth's 15.7 B, 188 GB, do not fit the card's 80 GB)
DS_PERIODS = 4
DS_B, DS_S, DS_STEPS = 2, 4096, 8
DS_LR = (1e-3, 1, 8)  # cosine_schedule(peak, warmup, steps), AdamW
DS_TIMED_FROM = 2  # steps after the first two
DS_CHECK_B, DS_CHECK_S = 1, 1024  # kernels vs plain at the trained weights
# launches a step: the five layers' attention forward, the body's again
# under remat, and five backwards
DS_LAUNCHES = {"flash_fwd": 1 + 2 * DS_PERIODS, "flash_bwd": 1 + DS_PERIODS}
DS_MAIN_CKPT = ROOT / "build" / "chip_ds_ckpt"
# the small DeepSeek's (24, 16) attention trains on the card in float32
# (the bf16 route refuses the pair)
DS_MAIN_ARGV = ["--arch", DS, "--scale", "small", "--dtype", "float32",
                "--steps", "20", "--fail-at", "12", "--checkpoint-every",
                "10", "--device", "cuda", "--ckpt-dir", str(DS_MAIN_CKPT)]
DS_MAIN_LOSSES = 21  # 20 steps, step 11 run twice


def phase_ds_train_kernels():
    """(a) The flash backward at (192, 128) and (24, 16) against the plain
    version's autograd, its routes and tensor-core resources at
    (192, 128), the bf16 (24, 16) refusal, and at DeepSeek's training
    problem 5 launches bit for bit and one call through autograd."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(10)
    out = {"attributes": fa_ops.backward_attributes(192, 128)}
    for (D, DV), types in DS_BWD_PAIRS:
        routes = {name: fa_ops.bwd_route(getattr(torch, name), D, DV)
                  for name in types}
        want = {name: "cuda_core" if name == "float32" else "tensor_core"
                for name in types}
        check(routes == want, f"the backward's routes at {(D, DV)}: "
                              f"{routes}")
    for name, a in out["attributes"].items():
        check(a["local_bytes"] == 0, f"the flash backward's {name} kernel "
                                     f"at (192, 128) spills: {a}")
    print("  flash backward (192, 128): tensor-core kernels "
          + ", ".join(f"{name} {a['registers']} registers, "
                      f"{a['local_bytes']} local bytes, "
                      f"{a['static_smem_bytes'] + a['dynamic_smem_bytes']} "
                      f"bytes of shared memory"
                      for name, a in out["attributes"].items()))
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn(1, 8, 4, 24, **bf16).requires_grad_()
    before = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
    try:
        fa_ops.flash_attention(q, torch.randn(1, 8, 4, 24, **bf16),
                               torch.randn(1, 8, 4, 16, **bf16))
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("(24, 16)" in refused
          and (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES) == before,
          f"a bf16 gradient at (24, 16) is refused before a launch: "
          f"{refused!r}")
    print(f"  a bf16 gradient at (24, 16) raises ValueError before a "
          f"launch: {refused}")
    for (D, DV), types in DS_BWD_PAIRS:
        for name in types:
            dtype, tol, largest, n = getattr(torch, name), TOL[name], 0.0, 0
            for S, half, H in itertools.product(DS_BWD_S, (False, True),
                                                DS_BWD_HEADS):
                T = (S + 1) // 2 if half else S
                q, k, v = _flash_inputs(g, 1, H, H, S, D, dtype, DV, T)
                dout = torch.randn(1, S, H, DV, generator=g,
                                   device="cuda").to(dtype)
                err, _ = flash_bwd_errors(q, k, v, dout, True, 0)
                check(err <= tol, f"flash backward vs plain, ({D}, {DV}) "
                                  f"H={H} S={S} T={T} {name}: {err}")
                largest, n = max(largest, err), n + 1
            out[f"{D}_{DV}_{name}"] = largest
            print(f"  flash backward ({D}, {DV}) {name}: {n} cases (S "
                  f"{DS_BWD_S}, T = S and (S + 1) // 2, H = KH "
                  f"{DS_BWD_HEADS}, causal), largest |a - b| / (1 + |b|) "
                  f"over dq, dk, dv {largest:.3e} (tol {tol:g}) ok")
            torch.cuda.empty_cache()
    B, H, KH, S, D, W, DV = DS_FLASH_BWD
    q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.bfloat16, DV)
    dout = torch.randn(B, S, H, DV, generator=g, device="cuda").to(
        torch.bfloat16)
    o, lse = fa_ops.flash_attention_with_lse(q, k, v)
    first = fa_ops.flash_attention_bwd(q, k, v, o, dout, lse)
    for _ in range(4):
        again = fa_ops.flash_attention_bwd(q, k, v, o, dout, lse)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              "the flash backward at (192, 128) is deterministic")
    before = fa_ops.BWD_LAUNCHES
    out["main"], out["main_abs"] = flash_bwd_errors(q, k, v, dout, True, W)
    check(fa_ops.BWD_LAUNCHES == before + 1,
          "one call through autograd launched the backward once")
    check(out["main"] <= TOL["bfloat16"],
          f"flash backward at DeepSeek's training problem: {out['main']}")
    print(f"  flash backward at DeepSeek's training problem (B={B} H={H} "
          f"KH={KH} S={S} (D, DV)=({D}, {DV}) causal bfloat16): 5 launches "
          f"equal bit for bit; through autograd (1 launch) vs plain "
          f"{out['main']:.3e} (max abs err {out['main_abs']:.3e})")
    del q, k, v, dout, o, lse, first, again
    torch.cuda.empty_cache()
    return out


def phase_ds_train_golden():
    """(b) The small DeepSeek (float32, flash at (24, 16) on the CUDA-core
    route) against ``lm_train_deepseek_small_golden.npz``, through the
    kernels."""
    from repro_torch.models.params import load_lm_train_golden

    golden = load_lm_train_golden(DS)
    out = lm_train_golden_errors(golden)
    print(f"  small {DS}: loss terms {out['loss']:.2e} (rtol "
          f"{LM_LOSS_RTOL:g}), gradients {out['grads']:.2e} (rtol "
          f"{LM_GRAD_RTOL:g}, every step), parameters after "
          f"{golden.tokens.shape[0]} AdamW steps on the JAX gradients "
          f"{out['params']:.2e} (atol {LM_PARAMS_ATOL:g}); flash launches a "
          f"step {out['launches']}")
    check(out["launches"]["forward"] > 0 and out["launches"]["backward"] > 0,
          "the small DeepSeek launched the flash forward and backward")
    return out


def _ds_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {"flash_fwd": fa_ops.LAUNCHES, "flash_bwd": fa_ops.BWD_LAUNCHES}


def _zero_ds_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0


def phase_ds_train_full():
    """(c) deepseek-v2-lite-16b at every published width, its body cut to
    DS_PERIODS periods, trained by ``launch/train.py::make_step``; then
    ``launch.train.main`` on the small DeepSeek across a failure."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    full = get_config(DS)
    cfg = dataclasses.replace(
        full, n_periods=DS_PERIODS,
        n_layers=len(full.head_pattern)
        + DS_PERIODS * len(full.body_pattern) + len(full.tail_pattern))
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the cut model alone: a full-depth bf16 init leaves the card's memory
    # fragmented (phase [20c])
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    m = cfg.mla
    print(f"  {DS} at full width (d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, MLA kv rank {m.kv_lora_rank}, (D, DV) = "
          f"({m.qk_nope_head_dim + m.qk_rope_head_dim}, {m.v_head_dim}), "
          f"dense d_ff {cfg.d_ff}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of d_ff {cfg.moe.expert_d_ff} and "
          f"{cfg.moe.n_shared_experts} shared of {cfg.moe.shared_d_ff} in "
          f"all, vocab {cfg.vocab_size}, remat {cfg.remat}), {cfg.n_layers} "
          f"of {full.n_layers} layers ({cfg.layer_kinds}): "
          f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    # in place: the functional update would hold two copies of the 22.7 GB
    # of float32 moments
    opt = AdamW(lr=cosine_schedule(*DS_LR), inplace=True)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step = train.make_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, DS_S, DS_B, seed=0)
    losses, step_ms = [], []
    _zero_ds_launches()  # the main path starts here
    t0 = time.perf_counter()
    for i in range(DS_STEPS):
        batch = pipe.batch_at(i)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state["params"], state["opt"], loss = step(state["params"],
                                                   state["opt"], batch)
        end.record()
        losses.append(float(loss))
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    seconds = time.perf_counter() - t0
    launches = _ds_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / DS_STEPS for k, v in launches.items()}
    check(per_step == DS_LAUNCHES, f"launches a step: {per_step}")
    check(bool(np.all(np.isfinite(losses))), f"finite losses: {losses}")
    check(float(np.mean(losses[-4:])) < losses[0],
          f"the loss falls: {losses[0]} -> {np.mean(losses[-4:])}")
    median = statistics.median(step_ms[DS_TIMED_FROM:])
    card = card_line()
    out = {"layers": cfg.n_layers, "params": n_params, "losses": losses,
           "step_ms": step_ms, "median_step_ms": median,
           "tokens_per_s": DS_B * DS_S / median * 1e3,
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "launches_per_step": per_step, "seconds": seconds, "card": card}
    print(f"  {DS_STEPS} steps of B {DS_B} x S {DS_S} through make_step "
          f"(AdamW, cosine_schedule{DS_LR}) in {seconds:.1f} s: losses "
          f"{losses[0]:.4f} -> mean of the last four "
          f"{np.mean(losses[-4:]):.4f}; step (CUDA events, median after "
          f"{DS_TIMED_FROM}) {median:.2f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s; peak memory {out['peak_memory_gb']:.2f} GB on {card};"
          f" launches a step {per_step}")

    batch = pipe.batch_at(DS_STEPS)
    with moe.record_keep() as keeps, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # the forward's calls: remat's recompute repeats them
    fwd = keeps[:DS_PERIODS]
    dropped = sum(int((~k).sum()) for k in fwd) / sum(k.numel() for k in fwd)
    device_us, top = _top_device(prof)
    port = _port_device(prof)
    split = _device_by_name(prof, FLASH_BWD_KERNELS)
    out["profile"] = {
        "wall_s": wall, "device_s": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "top": [{"name": k[:90], "us": us, "count": c} for us, c, k in top],
        "port_kernels": {k: {"us": us, "count": c}
                         for k, (us, c) in port.items()},
        "flash_bwd_split": {k: {"us": us, "count": c}
                            for k, (us, c) in split.items()},
        "dropped_share": dropped}
    print(f"  profiled step: {wall * 1e3:.1f} ms wall, {device_us / 1e3:.1f} "
          f"ms of device activity, idle share "
          f"{out['profile']['device_idle_share']:.4f}; routing choices "
          f"dropped past capacity {dropped:.2%}; the port's kernels: "
          + ", ".join(f"{k} {us / 1e3:.3f} ms x{c} ({us / device_us:.2%})"
                      for k, (us, c) in port.items()) + "; top device "
          "entries:")
    for us, c, k in top:
        print(f"    {us:10.1f} us x{c:4d}  {k[:90]}")
    params = state.pop("params")
    del state, batch
    torch.cuda.empty_cache()
    check_pipe = TokenPipeline(cfg.vocab_size, DS_CHECK_S, DS_CHECK_B,
                               seed=0)
    out["vs_plain"] = _train_vs_plain(
        model, build_model(dataclasses.replace(cfg, dtype="float32")),
        params, check_pipe.batch_at(0),
        f"full width at B {DS_CHECK_B} x S {DS_CHECK_S}")
    del params
    torch.cuda.empty_cache()

    shutil.rmtree(DS_MAIN_CKPT, ignore_errors=True)
    _zero_ds_launches()  # the entry point's run starts here
    t0 = time.perf_counter()
    result = train.main(DS_MAIN_ARGV)
    main_launches = _ds_launches()  # ... and ends here
    main_losses = result["losses"]
    check(len(main_losses) == DS_MAIN_LOSSES and result["restarts"] == 1,
          f"{len(main_losses)} losses, {result['restarts']} restarts")
    check(bool(np.all(np.isfinite(main_losses))), "every loss is finite")
    check(main_launches["flash_bwd"] > 0,
          f"main launched the backward kernels: {main_launches}")
    out["main"] = {"seconds": time.perf_counter() - t0,
                   "losses": main_losses, "restarts": result["restarts"],
                   "launches": main_launches,
                   "events": [(e.step, e.kind, e.detail)
                              for e in result["events"]]}
    print(f"  launch.train.main({' '.join(DS_MAIN_ARGV)}): "
          f"{out['main']['seconds']:.1f} s; {len(main_losses)} losses, "
          f"{main_losses[0]:.4f} -> {main_losses[-1]:.4f}; restarts "
          f"{result['restarts']}; events {out['main']['events']}; launches "
          f"{main_launches}")
    torch.cuda.empty_cache()
    return out


def time_flash_bwd_f32(g, B, H, KH, S, D, W, DV):
    """(d) The float32 route alone, at a pair the tensor cores do not
    take: the kernel with L from the forward, the plain version's
    autograd, SDPA's backward on the same float32 inputs (``is_causal``;
    no window), and the bound at the float32 rate (6 D + 4 DV flops a
    live pair) or of the bytes read and written once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = _flash_inputs(g, B, H, KH, S, D, torch.float32, DV)
    dout = torch.randn(B, S, H, DV, generator=g, device="cuda")
    out, lse = fa_ops.flash_attention_with_lse(q, k, v, window=W)
    ms = cuda_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                                    window=W), 20)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = _plain_flash(*leaves, window=W)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        plain_out, leaves, dout, retain_graph=True), 5)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    check(W == 0 and H == KH, "SDPA's backward timed causal, no GQA")
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    do = dout.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qs, ks, vs), do, retain_graph=True), 5)
    pairs = sum(min(i + 1, W) if W > 0 else i + 1 for i in range(S))
    flops = (6 * D + 4 * DV) * pairs * H * B
    nbytes = 2 * (q.nbytes + dout.nbytes + k.nbytes + v.nbytes)
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": f"B={B} H={H} KH={KH} S={S} (D, DV)=({D}, {DV}) "
                    f"window={W} causal float32",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "is_causal", "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "route": fa_ops.bwd_route(q.dtype, D, DV)}
    print(f"  flash backward {row['shape']}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']} at the float32 "
          f"rate: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    del q, k, v, dout, out, lse, leaves, plain_out, qs, ks, vs, o, do
    torch.cuda.empty_cache()
    return row


def phase_ds_train():
    import torch

    print(f"[25] DeepSeek-V2-Lite training: the flash backward at (D, DV) = "
          f"(192, 128) and (24, 16) vs the plain version's autograd, the "
          f"small DeepSeek's loss, gradients and AdamW steps vs the JAX "
          f"package's (lm_train_deepseek_small_golden.npz), {DS} at full "
          f"width with {DS_PERIODS} body periods (B {DS_B} x S {DS_S}, "
          f"{DS_STEPS} steps), launch.train.main across a failure, and the "
          f"backward's time")
    out = {}
    t0 = time.perf_counter()
    out["kernel_errors"] = phase_ds_train_kernels()
    print(f"    -- (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["golden"] = phase_ds_train_golden()
    print(f"    -- (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["full"] = phase_ds_train_full()
    print(f"    -- (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(11)
    out["timing"] = {"flash_bwd": time_flash_bwd(g, *DS_FLASH_BWD),
                     "flash_bwd_small": time_flash_bwd_f32(
                         g, *DS_SMALL_FLASH_BWD)}
    print(f"    -- (d) {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------- Qwen2-VL and whisper training (phase [26])
VL = "qwen2-vl-7b"
# (a) the flash backward at the two models' head layouts against the
# plain version's autograd, both routes, B 1: (label, H, KH, D, causal,
# T (None: T = S), S). Qwen2-VL's GQA group of 7 at D 128, causal, S
# around the 64-row tiles up to 4096; whisper's (12, 12) at D 64 causal
# (the decoder's self-attention), without a mask over T = S (the
# encoder) and over the encoder's 1500 keys (the cross-attention)
VW_BWD_S = (1, 63, 64, 65, 129, 448, 1500, 4096)
VW_BWD_SWEEPS = (("Qwen2-VL", 28, 4, 128, True, None, VW_BWD_S),
                 ("whisper decoder", 12, 12, 64, True, None, VW_BWD_S),
                 ("whisper encoder", 12, 12, 64, False, None, VW_BWD_S),
                 ("whisper cross", 12, 12, 64, False, 1500, (1, 448, 1500)))
# whisper's cross-attention where its keys and values nearly agree, as in
# its first decoder layer at (c)'s trained weights (keys 3.3 % and values
# 2.2 % from their mean, rms 1.0 and 1.4): (B, H, KH, S, T, D, key spread,
# value spread). The float32 route's dq, dk, dv and wk's gradient's
# stand-in E^T dk (E the keys themselves, which agree as closely) against
# the plain version in float64, by relative L2. On NVIDIA H100 80GB HBM3,
# 700 W: 2.01e-4 at most (the plain version's autograd 1.67e-4; F7,
# ROADMAP.md section 3)
VW_AGREE = (2, 12, 12, 448, 1500, 64, 0.03, 0.02)
VW_AGREE_RTOL = 5e-4
# the timed problems of (c)'s steps, bf16, (B, H, KH, S, D, window, DV,
# causal, T): Qwen2-VL's training attention; whisper's encoder, its
# cross-attention and its decoder's self-attention
VW_FLASH_BWD = {
    "qwen2_vl": (2, 28, 4, 4096, 128, 0, 128, True, 4096),
    "whisper_encoder": (16, 12, 12, 1500, 64, 0, 64, False, 1500),
    "whisper_cross": (16, 12, 12, 448, 64, 0, 64, False, 1500),
    "whisper_decoder": (16, 12, 12, 448, 64, 0, 64, True, 448)}
# (c) Qwen2-VL-7B at every published width, the body cut from 28 layers
# to VL_LAYERS: 2.954 B parameters' bf16 weights, gradients and float32
# moments are 35.5 GB; the full depth's 7.62 B, 91 GB, do not fit the
# card's 80 GB. B 2 x S 4096 of seeded embeddings, each row an image of
# 64 x 64 patches merged 2 x 2 after 32 (35) text tokens
VL_LAYERS = 8
VL_B, VL_S, VL_STEPS = 2, 4096, 8
VL_LR = (1e-3, 1, 8)  # cosine_schedule(peak, warmup, steps), AdamW
# kernels vs plain at the trained weights: one row of 1024 with an image
# of 32 x 32 patches merged 2 x 2
VL_CHECK_B, VL_CHECK_S, VL_CHECK_IMAGE = 1, 1024, (32, 32, 2)
# whisper-small at full width and depth: B 16 x S 448 decoder tokens
# (whisper's own context), 30 s of audio a row (1500 frames) from the
# stub frontend
WT_B, WT_S, WT_STEPS = 16, 448, 8
WT_LR = (1e-3, 1, 8)
WT_CHECK_B, WT_CHECK_S = 2, 448
VW_TIMED_FROM = 2  # steps after the first two


def vw_launches(cfg):
    """The flash launches a training step of ``cfg`` makes under remat:
    each attention forward twice (the forward, then the recompute in the
    backward) and its backward once; an encoder layer has one attention,
    a decoder layer with cross-attention two."""
    per_layer = 2 if "xattn" in cfg.layer_kinds else 1
    n = cfg.n_encoder_layers + per_layer * cfg.n_layers
    return {"flash_fwd": 2 * n, "flash_bwd": n}


def phase_vw_train_kernels():
    """(a) The flash backward at Qwen2-VL's (28, 4) at D 128 and
    whisper's (12, 12) at D 64, causal and without a mask over T = S and
    T = 1500, on both routes against the plain version's autograd; the
    tensor-core kernels' registers and spills at D 64 and 128."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device="cuda").manual_seed(12)
    out = {"attributes": {}}
    for D in (64, 128):
        routes = {name: fa_ops.bwd_route(getattr(torch, name), D)
                  for name in TOL}
        check(routes == {"float32": "cuda_core", "bfloat16": "tensor_core"},
              f"the backward's routes at D = {D}: {routes}")
        found = out["attributes"][D] = fa_ops.backward_attributes(D)
        for name, a in found.items():
            check(a["local_bytes"] == 0, f"the flash backward's {name} "
                                         f"kernel at D = {D} spills: {a}")
        print(f"  flash backward D={D}: tensor-core kernels "
              + ", ".join(f"{name} {a['registers']} registers, "
                          f"{a['local_bytes']} local bytes" for name, a in
                          found.items()))
    for label, H, KH, D, causal, T_fixed, sizes in VW_BWD_SWEEPS:
        for name, tol in TOL.items():
            largest, n = 0.0, 0
            for S in sizes:
                T = S if T_fixed is None else T_fixed
                q, k, v = _flash_inputs(g, 1, H, KH, S, D,
                                        getattr(torch, name), None, T)
                dout = torch.randn(1, S, H, D, generator=g,
                                   device="cuda").to(q.dtype)
                err, _ = flash_bwd_errors(q, k, v, dout, causal, 0)
                check(err <= tol, f"flash backward vs plain, {label} H={H} "
                                  f"KH={KH} D={D} S={S} T={T} {name}: {err}")
                largest, n = max(largest, err), n + 1
            out[f"{label} {name}"] = largest
            print(f"  flash backward {label} (H, KH) ({H}, {KH}) D={D} "
                  f"{'causal' if causal else 'no mask'} "
                  f"{name}: {n} cases (S {sizes}, T "
                  f"{'= S' if T_fixed is None else T_fixed}), largest "
                  f"|a - b| / (1 + |b|) over dq, dk, dv {largest:.3e} (tol "
                  f"{tol:g}) ok")
        torch.cuda.empty_cache()
    out["agree"] = _agreeing_keys_case(g)
    return out


def _agreeing_keys_case(g):
    """(a) The float32 route at VW_AGREE, a cross-attention whose keys
    and values nearly agree: dq, dk, dv and E^T dk (E = k, per batch row
    and kv head) through the kernels and through the plain version's
    autograd in float32, each by relative L2 from the plain version in
    float64; the kernels' within VW_AGREE_RTOL."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, H, KH, S, T, D, k_spread, v_spread = VW_AGREE

    def near(scale, spread):
        return (scale * torch.randn(B, 1, KH, D, generator=g, device="cuda")
                + spread * torch.randn(B, T, KH, D, generator=g,
                                       device="cuda"))

    q = torch.randn(B, S, H, D, generator=g, device="cuda")
    k, v = near(1.0, k_spread), near(1.4, v_spread)
    dout = torch.randn(B, S, H, D, generator=g, device="cuda")
    grads = {}
    for name, fn, dtype in (("kernels", fa_ops.flash_attention,
                             torch.float32),
                            ("plain", _plain_flash, torch.float32),
                            ("float64", _plain_flash, torch.float64)):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        dq, dk, dv = torch.autograd.grad(fn(*leaves, causal=False), leaves,
                                         dout.to(dtype))
        grads[name] = (dq, dk, dv, torch.einsum(
            "btkd,btke->bkde", k.double(), dk.double()))
    out = {route: {n: _l2(a, b) for n, a, b in zip(
        ("dq", "dk", "dv", "E^T dk"), grads[route], grads["float64"])}
        for route in ("kernels", "plain")}
    worst = max(out["kernels"].values())
    print(f"  flash backward float32, keys and values nearly agreeing "
          f"(B={B} H={H} S={S} T={T} D={D} no mask, spreads {k_spread} and "
          f"{v_spread}), relative L2 from float64: kernels "
          + ", ".join(f"{n} {e:.2e}" for n, e in out["kernels"].items())
          + "; plain " + ", ".join(f"{n} {e:.2e}" for n, e in
                                   out["plain"].items())
          + f" (tol {VW_AGREE_RTOL:g})")
    check(worst <= VW_AGREE_RTOL, f"float32 backward where keys nearly "
                                  f"agree: {out}")
    return out


def phase_vw_train_golden():
    """(b) The small Qwen2-VL (from embeddings with an image's M-RoPE
    positions) and the small whisper (with frames) against their
    training golden files, float32, through the kernels."""
    from repro_torch.models.params import load_lm_train_golden

    out = {}
    for arch in (VL, WHISPER):
        golden = load_lm_train_golden(arch)
        e = out[arch] = lm_train_golden_errors(golden)
        print(f"  small {arch}: loss terms {e['loss']:.2e} (rtol "
              f"{LM_LOSS_RTOL:g}), gradients {e['grads']:.2e} (rtol "
              f"{LM_GRAD_RTOL:g}, every step), parameters after "
              f"{golden.labels.shape[0]} AdamW steps on the JAX gradients "
              f"{e['params']:.2e} (atol {LM_PARAMS_ATOL:g}); flash launches "
              f"a step {e['launches']}")
        check(e["launches"]["forward"] > 0 and e["launches"]["backward"] > 0,
              f"the small {arch} launched the flash forward and backward")
    return out


def _vw_cell(cfg, full_layers, steps, lr, make_batch, check_batch, tokens,
             label):
    """(c) One full-width training cell: seed-0 bf16 weights, ``steps``
    steps through ``launch/train.py::make_step`` with the in-place AdamW
    on ``make_batch(i)``, the flash launches a step against
    :func:`vw_launches`, step time, tokens/s (``tokens`` a step), peak
    memory, a profiled step, and kernels vs plain at the trained weights
    on ``check_batch``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.rope_style} positions, tied {cfg.tie_embeddings}, remat "
          f"{cfg.remat}), {cfg.n_layers} of {full_layers} decoder layers"
          + (f" and {cfg.n_encoder_layers} encoder layers over "
             f"{cfg.n_audio_frames} frames" if cfg.n_encoder_layers else "")
          + f": {n_params / 1e9:.3f} B parameters, {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    opt = AdamW(lr=cosine_schedule(*lr), inplace=True)
    state = {"params": params, "opt": opt.init(params)}
    del params
    step = train.make_step(model, opt)
    batches = [make_batch(i) for i in range(steps + 1)]  # set-up
    losses, step_ms = [], []
    _zero_ds_launches()  # the main path starts here
    t0 = time.perf_counter()
    for batch in batches[:steps]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state["params"], state["opt"], loss = step(state["params"],
                                                   state["opt"], batch)
        end.record()
        losses.append(float(loss))
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    seconds = time.perf_counter() - t0
    launches = _ds_launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / steps for k, v in launches.items()}
    want = vw_launches(cfg)
    check(per_step == want, f"{cfg.name}: launches a step {per_step}, "
                            f"expected {want}")
    check(bool(np.all(np.isfinite(losses))), f"finite losses: {losses}")
    check(float(np.mean(losses[-4:])) < losses[0],
          f"the loss falls: {losses[0]} -> {np.mean(losses[-4:])}")
    median = statistics.median(step_ms[VW_TIMED_FROM:])
    card = card_line()
    out = {"layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
           "params": n_params, "losses": losses, "step_ms": step_ms,
           "median_step_ms": median, "tokens_per_s": tokens / median * 1e3,
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "launches_per_step": per_step, "seconds": seconds, "card": card}
    print(f"  {steps} steps of {label} through make_step (AdamW in place, "
          f"cosine_schedule{lr}) in {seconds:.1f} s: losses "
          f"{losses[0]:.4f} -> mean of the last four "
          f"{np.mean(losses[-4:]):.4f}; step (CUDA events, median after "
          f"{VW_TIMED_FROM}) {median:.2f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s; peak memory {out['peak_memory_gb']:.2f} GB on {card};"
          f" flash launches a step {per_step} (expected {want})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batches[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    device_us, top = _top_device(prof)
    port = _port_device(prof)
    flash_us = sum(us for k, (us, _) in port.items() if k.startswith("flash"))
    out["profile"] = {
        "wall_s": wall, "device_s": device_us / 1e6,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "flash_share": flash_us / device_us,
        "top": [{"name": k[:90], "us": us, "count": c} for us, c, k in top],
        "port_kernels": {k: {"us": us, "count": c}
                         for k, (us, c) in port.items()},
        "flash_bwd_split": {k: {"us": us, "count": c} for k, (us, c) in
                            _device_by_name(prof, FLASH_BWD_KERNELS).items()}}
    print(f"  profiled step: {wall * 1e3:.1f} ms wall, {device_us / 1e3:.1f} "
          f"ms of device activity, idle share "
          f"{out['profile']['device_idle_share']:.4f}, flash's share of the "
          f"device time {out['profile']['flash_share']:.2%}; the port's "
          f"kernels: " + ", ".join(f"{k} {us / 1e3:.3f} ms x{c}"
                                   for k, (us, c) in port.items())
          + "; top device entries:")
    for us, c, k in top:
        print(f"    {us:10.1f} us x{c:4d}  {k[:90]}")
    params = state.pop("params")
    del state, batches
    torch.cuda.empty_cache()
    out["vs_plain"] = _train_vs_plain(
        model, build_model(dataclasses.replace(cfg, dtype="float32")),
        params, check_batch, f"{cfg.name} at full width")
    del params
    torch.cuda.empty_cache()
    return out


def phase_vw_train_full():
    """(c) Qwen2-VL-7B at every published width with VL_LAYERS of its 28
    layers, and whisper-small at full width and depth, each trained by
    ``launch/train.py::make_step`` on its family's batch."""
    from repro_torch.configs import get_config

    full = get_config(VL)
    vl = dataclasses.replace(full, n_layers=VL_LAYERS, n_periods=VL_LAYERS)
    out = {VL: _vw_cell(
        vl, full.n_layers, VL_STEPS, VL_LR,
        lambda i: lm_train_batch(vl, VL_B, VL_S, seed=i),
        lm_train_batch(vl, VL_CHECK_B, VL_CHECK_S, seed=100,
                       image=VL_CHECK_IMAGE), VL_B * VL_S,
        f"B {VL_B} x S {VL_S} from embeddings with an image's M-RoPE "
        f"positions")}
    wt = get_config(WHISPER)
    out[WHISPER] = _vw_cell(
        wt, wt.n_layers, WT_STEPS, WT_LR,
        lambda i: lm_train_batch(wt, WT_B, WT_S, seed=i),
        lm_train_batch(wt, WT_CHECK_B, WT_CHECK_S, seed=100), WT_B * WT_S,
        f"B {WT_B} x S {WT_S} tokens with {wt.n_audio_frames} frames a row")
    check(out[WHISPER]["params"] == WHISPER_PARAMS,
          f"whisper-small has {WHISPER_PARAMS} parameters")
    return out


def phase_vw_train():
    import torch

    print(f"[26] Qwen2-VL and whisper training: the flash backward at "
          f"(H, KH) (28, 4) D 128 and (12, 12) D 64 (causal, and without a "
          f"mask over T = S and T = 1500) vs the plain version's autograd, "
          f"the small Qwen2-VL's and whisper's loss, gradients and AdamW "
          f"steps vs the JAX package's (lm_train_qwen2_vl_small_golden.npz, "
          f"lm_train_whisper_small_golden.npz), {VL} at full width with "
          f"{VL_LAYERS} layers (B {VL_B} x S {VL_S}, {VL_STEPS} steps) and "
          f"{WHISPER} at full width and depth (B {WT_B} x S {WT_S}, 1500 "
          f"frames, {WT_STEPS} steps), and the backward's time at their "
          f"attention problems")
    out = {}
    t0 = time.perf_counter()
    out["kernel_errors"] = phase_vw_train_kernels()
    print(f"    -- (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["golden"] = phase_vw_train_golden()
    print(f"    -- (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["full"] = phase_vw_train_full()
    print(f"    -- (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(13)
    out["timing"] = {}
    for label, (B, H, KH, S, D, W, DV, causal, T) in VW_FLASH_BWD.items():
        out["timing"][label] = time_flash_bwd(g, B, H, KH, S, D, W, DV,
                                              causal=causal, T=T)
    print(f"    -- (d) {time.perf_counter() - t0:.1f} s")
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
    from repro_torch.kernels.flash_attention import ops as fa_ops

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

    ops.LAUNCHES = ops.BWD_LAUNCHES = 0  # the operations layer starts here
    model_plane = timed("model plane", seconds, phase_model_plane, golden,
                        pre)
    plane_launches = {"forward": ops.LAUNCHES,
                      "backward": ops.BWD_LAUNCHES}  # ... and ends here
    check(plane_launches["forward"] > 0 and plane_launches["backward"] > 0,
          "the operations layer launched both edge-softmax kernels")

    ops.LAUNCHES = ops.BWD_LAUNCHES = 0  # the configuration search starts
    search = timed("configuration search", seconds, phase_search,
                   graph_ranking["machines"]["scores"])
    search_launches = {"forward": ops.LAUNCHES,
                       "backward": ops.BWD_LAUNCHES}  # ... and ends here
    check(search_launches["forward"] > 0 and search_launches["backward"] > 0,
          "the configuration search's machine scores launched both "
          "edge-softmax kernels")

    # the LM zoo: each arch's serving run sets the flash count to 0 before
    # it and reads it after
    zoo = timed("LM zoo", seconds, phase_zoo)
    d128 = zoo["d128"]
    # the MLA and M-RoPE decoders: likewise, each arch's serving run
    mla = timed("MLA and M-RoPE decoders", seconds, phase_mla)
    mla_timing = mla["kernel_errors"]["timing"]
    # whisper-small: its main path sets the flash count to 0 before it
    # and reads it after
    whisper = timed("whisper-small", seconds, phase_whisper)
    wk = whisper["kernel_errors"]
    # LM training: its main path, launch.train.main at full width, sets
    # the counts of its kernels to 0 before it and reads them after
    lm_train = timed("LM training", seconds, phase_lm_train)
    bwd = lm_train["timing"]["smollm"]
    # RecurrentGemma's training: its full-width steps and its entry point's
    # run each set the counts of their kernels to 0 before and read them
    # after
    rg_train = timed("RecurrentGemma training", seconds, phase_rg_train)
    lru_bwd = rg_train["timing"]["rg_lru_bwd"]["B=1 S=4096 C=4096 float32"]
    # xLSTM's training: its full-width steps and its entry point's run each
    # set the mLSTM's counts to 0 before and read them after
    xl_train = timed("xLSTM training", seconds, phase_xlstm_train)
    xl_timing = xl_train["timing"]
    mlstm_bwd = xl_timing["B=1 H=4 S=4096 hd=1024 chunk=256 bfloat16"]
    mlstm_bwd_f32 = xl_timing["B=1 H=4 S=4096 hd=1024 chunk=256 float32"]
    mlstm_bwd_cell = xl_timing["B=4 H=4 S=2048 hd=1024 chunk=256 bfloat16"]
    # DeepSeek-V2-Lite's training: its full-width steps and its entry
    # point's run each set the flash counts to 0 before and read them after
    ds_train = timed("DeepSeek-V2-Lite training", seconds, phase_ds_train)
    ds_bwd = ds_train["timing"]["flash_bwd"]
    # Qwen2-VL's and whisper's training: each full-width cell sets the
    # flash counts to 0 before its steps and reads them after
    vw_train = timed("Qwen2-VL and whisper training", seconds,
                     phase_vw_train)
    vw_full = vw_train["full"]

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
        "launches_model_plane": plane_launches["forward"],
        "launches_search": search_launches["forward"],
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
        "head_dims": list(fa_ops.HEAD_DIMS),
        "head_dim_pairs": {k: [list(p) for p in v]
                           for k, v in fa_ops.PAIRS.items()},
        "launches_zoo": zoo["launches"],
        "zoo_max_abs_err": {k: zoo["kernel_errors"][k]
                            for k in ("float32", "bfloat16")},
        "d128": {"shape": d128["shape"],
                 "max_abs_err": zoo["kernel_errors"]["d128_main"],
                 **{k: d128[k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "library_call", "library_times_ms", "tflop_per_s", "f32_ms", "f32_bound_ms",
                     "f32_library_ms", "attributes")}},
        "mla_192_128": {
            "shape": mla_timing["shape"],
            "max_abs_err": mla["kernel_errors"]["bfloat16_main"],
            "f32_max_abs_err": mla["kernel_errors"]["float32_main"],
            "launches_mla": mla["launches"],
            **{k: mla_timing[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_call", "library_times_ms", "tflop_per_s", "f32_ms",
                "f32_bound_ms", "f32_library_ms", "attributes")},
            "sdpa_backend": mla["kernel_errors"]["sdpa_backend"]},
        "mla_max_abs_err": {k: mla["kernel_errors"][k]
                            for k in ("float32", "bfloat16", "edges")},
        "non_causal": {
            "launches_whisper": whisper["full"]["launches"],
            "launches_per_prefill": whisper["full"]["launches_per_prefill"],
            "max_abs_err": {k: wk[k] for k in (
                "float32", "bfloat16", "edges", "bfloat16_encoder",
                "bfloat16_cross", "float32_encoder", "float32_cross")},
            **{label: {
                "shape": wk[f"timing_{label}"]["shape"],
                **{k: wk[f"timing_{label}"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_call", "library_times_ms", "tflop_per_s",
                    "f32_ms", "f32_bound_ms", "f32_library_ms",
                    "attributes")},
                "sdpa_backend": wk[f"sdpa_backend_{label}"]}
               for label in ("encoder", "cross")}},
        "training_qwen2_vl_whisper": {
            arch: {k: vw_full[arch][k]["flash_fwd"]
                   for k in ("launches", "launches_per_step")}
            for arch in (VL, WHISPER)},
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
        "launches_model_plane": plane_launches["backward"],
        "launches_search": search_launches["backward"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/ops.py:42",
        "launches": lm_train["full"]["launches"]["flash_bwd"],
        "max_abs_err": lm_train["kernel_errors"]["main_abs"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "shape": bwd["shape"],
        "routes": {"bfloat16": bwd["route"], "float32": "cuda_core"},
        "design": FLASH_BWD_DESIGN,
        "library_call": bwd["library_call"],
        "sdpa_backend": bwd["sdpa_backend"],
        "f32_ms": bwd["f32_ms"],
        "f32_bound_ms": bwd["f32_bound_ms"],
        "d128": lm_train["timing"]["d128"],
        "gemma3_d256": lm_train["timing"]["gemma3"],
        "step_split_us": lm_train["full"]["profile"]["flash_bwd_split"],
        "attributes": lm_train["backward_attributes"],
        "forward_with_lse_ms": lm_train["forward_lse"],
        "errors": lm_train["kernel_errors"],
        "launches_per_step": lm_train["full"]["launches_per_step"],
        "recurrentgemma": {
            **rg_train["timing"]["flash_bwd"],
            "launches": rg_train["full"]["launches"]["flash_bwd"],
            "launches_per_step":
                rg_train["full"]["launches_per_step"]["flash_bwd"],
            "errors": rg_train["kernel_errors"]["flash_bwd"]},
        "head_dim_pairs": {k: [list(p) for p in v]
                           for k, v in fa_ops.BWD_PAIRS.items()},
        "deepseek_192_128": {
            **ds_bwd, "design": DS_FLASH_DESIGN,
            "launches": ds_train["full"]["launches"]["flash_bwd"],
            "launches_per_step":
                ds_train["full"]["launches_per_step"]["flash_bwd"],
            "launches_main": ds_train["full"]["main"]["launches"][
                "flash_bwd"],
            "errors": ds_train["kernel_errors"]},
        "deepseek_small_24_16": {
            **ds_train["timing"]["flash_bwd_small"],
            "launches_per_step_small":
                ds_train["golden"]["launches"]["backward"]},
        "qwen2_vl_whisper": {
            "problems": vw_train["timing"],
            "launches": {arch: vw_full[arch]["launches"]["flash_bwd"]
                         for arch in (VL, WHISPER)},
            "launches_per_step": {
                arch: vw_full[arch]["launches_per_step"]["flash_bwd"]
                for arch in (VL, WHISPER)},
            "errors": {k: v for k, v in vw_train["kernel_errors"].items()
                       if k != "attributes"},
            "attributes": vw_train["kernel_errors"]["attributes"]},
    }, {
        "name": "rg_lru_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rg_lru.cu",
        "replaces": "src/repro/kernels/rg_lru/ops.py:31",
        "launches": rg_train["full"]["launches"]["rg_lru_bwd"],
        "max_abs_err": rg_train["kernel_errors"]["main_abs"],
        "ms": lru_bwd["ms"],
        "plain_ms": lru_bwd["plain_ms"],
        "bound_ms": lru_bwd["bound_ms"],
        "bound_by": lru_bwd["bound_by"],
        "library_ms": lru_bwd["library_ms"],
        "shape": lru_bwd["shape"],
        "design": LRU_BWD_DESIGN,
        "graph_ms": lru_bwd["graph_ms"],
        "scratch_bytes": lru_bwd["scratch_bytes"],
        "by_shape": rg_train["timing"]["rg_lru_bwd"],
        "attributes": rg_train["kernel_errors"]["attributes"],
        "launches_per_step": rg_train["full"]["launches_per_step"][
            "rg_lru_bwd"],
        "launches_main": rg_train["full"]["main"]["launches"]["rg_lru_bwd"],
    }, {
        "name": "mlstm_chunkwise_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm/ops.py:38",
        "launches": xl_train["full"]["launches"]["mlstm_bwd"],
        "max_abs_err": xl_train["kernel_errors"]["main_abs"],
        "ms": mlstm_bwd["ms"],
        "plain_ms": mlstm_bwd["plain_ms"],
        "bound_ms": mlstm_bwd["bound_ms"],
        "bound_by": mlstm_bwd["bound_by"],
        "library_ms": mlstm_bwd["library_ms"],
        "shape": mlstm_bwd["shape"],
        "design": MLSTM_BWD_DESIGN,
        "cuda_core_bound_ms": mlstm_bwd["cuda_core_bound_ms"],
        "f32_ms": mlstm_bwd_f32["ms"],
        "cell_ms": mlstm_bwd_cell["ms"],
        "cell_bound_ms": mlstm_bwd_cell["bound_ms"],
        "cell_plain_ms": mlstm_bwd_cell["plain_ms"],
        "f32_bound_ms": mlstm_bwd_f32["bound_ms"],
        "scratch_bytes": mlstm_bwd["scratch_bytes"],
        "by_shape": xl_timing,
        "attributes": xl_train["kernel_errors"]["attributes"],
        "errors": xl_train["kernel_errors"]["errors"],
        "launches_per_step": xl_train["full"]["launches_per_step"][
            "mlstm_bwd"],
        "launches_main": xl_train["full"]["main"]["launches"]["mlstm_bwd"],
        "forward_launches_training": xl_train["full"]["launches"][
            "mlstm_fwd"],
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
        "fleet_tier": {**fleet_tier, "launches": fleet_launches},
        "model_plane": {**model_plane, "launches": plane_launches},
        "search": {**search, "launches": search_launches},
        "lm_zoo": zoo, "mla_mrope": mla, "whisper": whisper,
        "lm_training": lm_train, "recurrentgemma_training": rg_train,
        "xlstm_training": xl_train, "deepseek_training": ds_train,
        "qwen2_vl_whisper_training": vw_train},
        indent=1, default=str))
    print(f"[27] done in {time.perf_counter() - t_start:.1f} s; report in "
          f"{REPORT.relative_to(ROOT)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
