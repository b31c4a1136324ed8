#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases print on their own lines; any failure raises and exits non-zero, and
no phase is caught.

1. device: torch and CUDA versions, the card's name and power limit.
2. build: ``nvcc`` builds the kernels (``csrc/*.cu``), one process
   each, all started together; the build time; each K2b, K3b and K4
   kernel's ``ptxas`` registers and spills (any of K3b's eight kernels or
   K4's, or a K2b tensor-core kernel, that spills fails the run).
3. K1 ``matmul_h100`` against its plain version: in bf16 at every matmul
   triple of the full llama3-8b serve path at M = 4 and 32 through the leaf
   the dispatch picks; through the pick at N = 25 in f32 and N = 32001 in
   bf16 at M = 1 and 4, and with both operands one element past a 16-byte
   boundary, all of which take the masked loads; five launches of one
   split-K pick compared bit for bit; and at the six signatures of
   ``MM_SIGNATURES``, twelve feasible leaves of different (bm, bn, bk, s,
   kb, stages, cached) each (the pick, the leaves one step from it, the
   napkin's two worst and its best others), each held against the plain
   version (the paper's code soundness, Def. 2 ii) and timed, eagerly and
   as device time, with the napkin's rank beside the card's.  Then K1's
   batched entry (one launch for every expert of a MoE layer) through the
   pick of the per-expert key at the experts' signatures of llama4-scout
   (E = 16, M = 4, N = 8192, K = 5120 up; N = 5120, K = 8192 down) and
   kimi-k2 (E = 384, M = 4, N = 2048, K = 7168 up; N = 7168, K = 2048
   down): held against the plain version (K1's, expert by expert) and
   timed eagerly and as device time beside ``torch.bmm`` (a yardstick)
   and the bound, every expert's weights read once (1.34 and 11.3 GB a
   launch, too large to cycle through copies).
4. K2 ``flash_attention_h100`` against its plain version in bf16, through
   the leaf the dispatch picks: with one KV head a query head, a prefill
   chunk, decode over a ragged cache, non-causal sk = 200, window 128; GQA
   at the llama3-8b (32/8) and hymba-1.5b (25/5, window 1024) groupings;
   and at sk 4096 a llama decode, a 256-row causal llama prefill chunk and
   a hymba decode (its window reads 1024 of the 4096 keys).  A pick with
   more than one key split is launched three times, bit for bit.  Each
   row is timed eagerly and as device time beside SDPA (``enable_gqa`` where
   the installed PyTorch takes it), and under ``torch.profiler`` each
   kernel's device time a call (K2's attention and split combine, SDPA's
   own).  Then at four llama3-8b signatures and the hymba decode at sk
   4096 (``K2_LEAF_ROWS``) ten feasible leaves of different (bq, bkv,
   kv_chunk, stages) each, held against the plain version and timed, with
   the napkin's rank beside the card's.  Then the paged entry (one launch
   for every row, through the block tables, lengths on the device) against
   its plain version on a bf16 pool (``K2_PAGED_ROWS``): decode over 4 rows
   of ragged lengths, one of them 0 (all zeros), at the llama and hymba
   groupings over a 4096-key pool, launched three times bit for bit over
   its several splits; a prefill chunk at each grouping; f32 q on the bf16
   pool.  Each row timed eagerly and as device time beside SDPA over the
   K/V gathered out of the pool beforehand (SDPA's time leaves out the
   gather).
5. K3 ``ssd_scan_h100`` against its plain version in bf16 with an f32
   state, updated in place as the serve path does, at the mamba2-130m (24
   heads of 64, state 128) and hymba-1.5b (25 heads of 64, state 16)
   signatures: a decode step of 4 rows at seq 1 with a mask of every row,
   and again with row 2 masked out (its state must stay bit for bit),
   every chunk length 1..256 with the state in, seq 200 (no multiple of
   any chunk) with and without a state, and a prefill chunk's launch (the
   whole 4-slot state, ``state_rows`` picking slot 3 on the device; the
   other slots' states bit for bit) in the step body (4 steps) and the
   chunk body (256 steps for mamba, 32 for hymba), through the leaf the
   dispatch picks; each row also held by relative error (``SSD_REL``)
   against a planted fault; and every feasible leaf (chunk, bd) at a one-row
   256-step mamba chunk, timed eagerly and as device time, with the
   napkin's rank beside the card's and the pick's time as a multiple of
   the fastest leaf's.
6. case studies, the paper's own evaluation through the port's ``ops``
   (``DispatchCache.warm_callable`` -> the family's tree under ``H100_SXM``
   -> memoized ``instantiate`` -> the kernel), at the paper's sizes: the
   four dispatch triples are frozen, every launch counter is set to 0, then
   ``ops.matadd`` at 8192 x 8192 f32 (Fig. 2), ``ops.transpose`` at 16384
   x 16384 f32 (Table 3), ``ops.jacobi1d`` at n = 2^15 + 2 (Table 2) and
   at n = 2^21 + 2 (the largest Jacobi bucket of the JAX artifacts), 4
   sweeps each.  Each call moves its counter by 1, 1 and 4; no dispatch
   leaves the frozen lane; each result agrees with the plain version.
   Then matadd and transpose in bf16 at 8192 x 8192, each family at a
   ragged shape (300 x 700; n = 1026), and matadd at 1 x 2^25 and
   2^22 x 8 and transpose at 4 x 2^25, the last two with more than 65,535
   blocks on the grid's y; matadd's pick timed at 8192² in bf16 and in f32 one element off
   the 16-byte boundary; and at each of the four sizes up to eight leaves
   of different
   formats, each held against the plain version and timed, with the
   napkin's rank beside the card's (a Jacobi sweep also as device time):
   the leaves live under ``H100_SXM``
   (matadd: grain 2; transpose and Jacobi: cached, case 1, grains 1-8) and
   the leaves the tree keeps for a smaller machine (matadd's grain-1 case
   C2 at G = 12; the uncached case 3 of transpose and Jacobi at V = 0),
   which ``H100_SXM`` never picks.
7. serve parity: the SMOKE configs of all nine served configs in f32
   (llama3, mamba2, hymba, granite, yi, qwen with its q/k/v biases
   planted non-zero, chameleon, and the MoE llama4-scout, top-1 of 4
   experts, and kimi-k2, top-2 of 8), each served on ``cuda`` (the
   kernels, the decode tick and every prefill chunk replayed from their
   CUDA graphs, at ``async_depth`` 1 and 2) and
   on ``cpu`` (their plain versions) from the same weights; the greedy
   tokens are equal, the decode graph replays once a decode tick, the
   prefill graphs once a chunk, and no prefill body runs eagerly.
8. serve, the main paths, each through ``init_model`` (bf16, random weights
   from a seeded ``torch.Generator`` on the card) and
   ``ServeEngine(warm_kernels=True)``, 4 requests of 8 new tokens, every
   launch counter set to 0 just before and read just after each path:
   mamba2-130m at full width (24 layers; prompts of 200-500 tokens,
   ``prefill_chunk`` 256, ``max_len`` 1024), hymba-1.5b at full width (32
   layers) and llama3-8b at full width (32 layers), the last two with
   prompts of 16-64 tokens, ``prefill_chunk`` 32, ``max_len`` 256.  Then
   the six paths of the dense and MoE configs at those settings, each at
   full width, its model freed before the next: granite-3-8b (40 of 40
   layers, 16.7 GB of bf16 weights), yi-6b (32 of 32, 12.1 GB), qwen1.5-4b
   (40 of 40, 7.9 GB, q/k/v biases, one query head a KV head),
   chameleon-34b (48 of 48, 68.6 GB), llama4-scout-17b-a16e (12 of 48
   layers, 54.0 GB: 48 would be 203.5 GB) and kimi-k2-1t-a32b (1 of 61
   layers, 38.8 GB: every width, 384 experts and top-8 kept); the depth
   cuts are one 80 GB card's, and each path prints its peak device memory.
   The MoE paths launch K1's batched entry once a projection (wi, wg, wo)
   a layer a step, and the router on K1.  Each
   engine captures its decode tick and one prefill graph for each
   quantized chunk length (nine for mamba2's 256: 256 down to 1; six for
   32) at construction, all sharing one memory pool (each graph's capture
   time printed).  Every request returns ``max_new`` tokens, each kernel
   of the path launched (K1 and K3; K1, K2 and K3; K1 and K2), the decode
   graph replayed once a decode tick and the prefill graphs once a chunk
   with no eager prefill body, the launch counts (a replay counting its
   captured launches) match the steps run — K1 per projection and router,
   the batched entry per expert projection, K2 and K3 one a layer, for
   every prefill chunk and decode step — no dispatch
   resolved cold after warm-up, and a full-width forward gives finite
   logits.  The host time of a decode tick (over the ticks that ran no
   prefill chunk) and of a prefill chunk (by its length), from
   ``step()`` to the replay's return, is printed beside its device time
   (CUDA events around the replay), medians.  llama3-8b then serves the
   same prompts at ``async_depth`` 2: its tokens equal those at depth 1.
   Then it serves them four times more on its engine, untraced, under
   ``obs.tracing()`` twice, untraced (the walls with and without the
   trace; a ``TickSpan`` each tick, nothing but tick spans and admission
   decisions after warm-up), and once traced under ``torch.profiler``:
   the device's idle share, 1 − (the device time of every kernel and copy
   the profiler lists) / the run's wall.
9. main-path shapes: every launch signature of phase 8 is run again on
   fresh inputs of its shape, held against the plain version, and timed:
   kernel, plain version, the library call, and the bound (a batched
   signature phase 3 timed keeps its row).  A paged K2
   signature runs through the paged entry over a pool and tables at the
   served lengths: a decode step's rows each halfway through its request's
   new tokens, a prefill chunk at the mean prompt length (the lengths on
   the device during the run are not read back).  Then the host
   cost a launch: the host clock over 1000 launches with no synchronise
   inside the loop, of K1 at M = 1, N = 32, K = 32 through the wrapper,
   ``ops.matmul`` and, beside them, ``torch.matmul``, and of K3 at
   mamba2-130m's decode signature (4, 1, 24, 64, 128), in place with a
   mask as the decode step calls it, through the wrapper, ``ops.ssd_scan``
   and the C entry alone.
10. the engine options: (b) the port's dispatch tables for ``h100_sxm``
   (``--quick``) and a llama3-8b serve plan at phase 8's settings, built
   into a temporary directory by ``python -m
   repro_torch.launch.compile_artifacts`` and ``plan_artifacts`` (called
   in-process); an online-warmed and a plan-backed llama3-8b engine
   (full width, bf16), each start's warm and capture seconds; the
   plan-backed start makes 0 cold builds and 0 online enumerations
   (``core.select.STATS``), every pick equals the online pick, and both
   engines give the same tokens bit for bit on phase 8's prompts; then
   one table rewritten: the start warns (``StalePlanWarning``) and warms
   online, and ``strict_plans`` raises ``StalePlanError``.  (a) prefix
   sharing at full width: eight requests of 8 new tokens whose prompts
   share a 48-token prefix (three full blocks) and have 8-24 tokens of
   their own, two of them diverging mid-block (so CoW copies run), served
   with the leader first, sharing on and off, on the same weights, every
   launch counter set to 0 just before each run and read just after:
   prefix hits, tokens saved, CoW copies, prefill chunks, launches and
   walls; every request returns 8 tokens, the pool's invariants hold, the
   prefill tokens computed equal the prompt tokens less the tokens saved,
   a prefill graph replays once a chunk, and the launches match the steps
   run; bf16 tokens with and without sharing are printed as an agreement
   count, not held (a tail chunk has another M).  (c) the plan-backed
   llama3-8b engine, given ``degrade``, takes a ``serve.decode`` fault
   mid-run: one K1 triple demoted, the steps that launch it captured
   again (seconds printed), every request finishes, tokens printed as an
   agreement count.  Then the degrade drill on phase 7's f32 smoke
   configs at ``async_depth`` 1 and 2, each engine warmed and with
   ``degrade``: schedule A (a ``serve.prefill`` error at tick 1, a
   ``serve.decode`` error at tick 6) demotes and recaptures exactly the
   steps whose recorded triples hold the demoted one (printed by key with
   seconds), the KV pool, SSM state and ``last_tok`` bit for bit across
   each recapture, tokens equal to the fault-free run; schedule B (two
   ``serve.decode`` errors at one tick) poisons and recomputes with equal
   tokens; schedule C (a fatal fault) propagates, then the engine drains.
   The pool's invariants are proved every tick.
11. tuning and the kernel monitor, in a temporary artifact root, each
   part's seconds printed: (a) the port's tables for ``h100_sxm`` compiled
   over every K1, K2 and K3 signature phase 8 launched and every triple the
   nine paths' engines resolve, K4-K6 at the case-study sizes, then
   measure -> calibrate -> compact on the card (``DeviceTimer``: ten
   launches a CUDA graph, replays between CUDA events; every candidate of
   a bucket, no dim clamped); a line a family: buckets, samples timed and
   failed, the fit, ``top1_agreement``, the compaction, and in how many
   buckets the measured first pick is another than the symbolic one or
   the table's last.  (b) At every phase-8 K1, K1b, K2 and K3 signature
   whose pick the tuned tables change, the measured pick held against the
   plain version and timed as phase 9 times a pick (the kernel alone), and
   the sums over phase 8's launches beside the symbolic picks' (phase 9)
   and the library's, K1 and K1b also by the symbolic pick's kb; then
   llama3-8b at phase 8's settings from the tuned tables: every warm pick
   ``measured``, 0 cold builds, its bf16 tokens against phase 8's
   (reported, with the first difference).  (c) llama3-8b at phase 8's
   settings without and with the monitor at its defaults (the CUDA timer),
   at ``async_depth`` 1 and 2: the stats line and any swap, host time and
   CUDA-event span of a probe tick against a tick without one and an
   unmonitored tick, each probe's host time (a triple's first probe builds
   its challenger pool), the walls, the tokens.  (d) a forced swap: one K1
   triple's frozen incumbent skewed slow by a deterministic timer (window
   2, patience 2, a probe a tick), at full width in bf16 and on the f32
   llama3-8b smoke config: the swap fires at tick 3 and the engine
   captures again exactly the steps that launch the triple (seconds
   printed); f32 tokens equal the unmonitored run's, bf16 reported.
12. whisper-large-v3 and the non-paged serve steps (``build_serve_steps``:
   ``prefill`` then ``decode_step``, whisper's only serve path, as in the
   JAX package).  (a) K2's four new kinds of call at whisper's shapes (20
   query heads over 20 KV heads of 64, bf16) through the paged entry, a
   row's K/V one block of the pool: the encoder's self-attention (4 rows,
   sq = sk = 1500, non-causal), cross-attention at prefill (16 queries)
   and at decode (1) over 1500 frames, and decoder self-attention at
   decode over a 64-key cache (ragged lengths, one of them 0); each held
   against the plain version and ``kernels.ref``, a split launch three
   times bit for bit, timed eagerly and as device time beside SDPA and the
   bound; then ten leaves of the encoder's signature with the napkin's
   rank beside the card's.  (b) whisper-large-v3 at full width and depth
   (32 + 32 layers, bf16, seeded weights made on the card): the warm set
   of the steps frozen (``warm_steps_dispatch``), 4 requests of 1500
   seeded frames and 16-token prompts, ``max_len`` 64, greedy 8 new
   tokens: the prefill (encode included) eager, the 7 decode steps one
   CUDA graph replay each; every launch counter set to 0 just before and
   read just after; the launches match the steps (K1 a projection, K2 one
   a layer for the encoder and two, self and cross, a decoder layer a
   step), 0 cold builds, the replayed tokens equal an eager decode's;
   encode, prefill and decode-tick host and device times, peak memory,
   the decode tick by kernel under ``torch.profiler``, and reckonings from
   the config (parameters, the cross cache a row, a tick's bytes, the
   encoder's flops) printed as such.  Its launch signatures not timed in
   phase 9 are timed as phase 9 times them.  (c) the f32 smoke config of
   each of the ten archs through the non-paged steps (default bf16 cache,
   a (B,) index; prompts of 28 tokens, so hymba's ring of 32 wraps) on
   the card and on the CPU from the same weights: equal greedy tokens.
13. training (``runtime/steps.py`` ``build_train_step``: K1 forward and
   backward over K4's transposes, K2 forward, K2b backward), on split
   workspaces of its own after every engine is closed.  (a) K2b
   (``flash_attention_bwd_h100``) through the pick of each key of
   ``BWD_SIGNATURES`` (llama3-8b's training key, whisper's encoder,
   cross-attention of 64 queries over 1500 keys, ragged lengths with a 0
   row, window 256), bf16 and f32: held against its plain version and
   against ``torch.autograd`` of K2's paged plain version, a 0 row all
   zeros, two launches bit for bit; timed eagerly and as device time
   beside the plain version and SDPA's backward (a yardstick) and its
   bound (2.5 times the forward's flops of the visible pairs at the
   peak of the inputs' type, or the bytes); the f32 rows time the FMA
   body, the bf16 rows the tensor-core body.  Then, in a process of its
   own, every leaf of K2b's tree at llama3-8b's training key and whisper's
   encoder key in bf16: held against the plain version, two launches bit
   for bit, CUDA-graph device time and each kernel's under
   ``torch.profiler`` (the lse recompute's share of the dQ kernel's
   time), the napkin's rank beside the card's.  The build prints each K2b kernel's ``ptxas`` registers and
   spills and fails if a tensor-core kernel spills.  (b) llama3-8b at full
   width, 4 of 32 layers (reduced: depth only), bf16 compute, f32 masters
   and AdamW state: 6 steps of 8 x 1024 ``SyntheticLM`` tokens in 2
   microbatches after ``warm_train_dispatch``; each step's loss and
   grad_norm (finite), host and CUDA-event time, its launches against the
   step's products and cores (K1 3·(7L+1)·mb, K4 2·(7L+1)·mb, K2 L·mb,
   K2b 3·L·mb in bf16), 0 cold builds; tokens/s, model flops against the
   bf16 peak, peak memory; a checkpoint of step 3 (``CheckpointManager``,
   async) restored and steps 3-4 replayed with losses equal bit for bit,
   then step 5 replayed under ``torch.profiler`` (device time by kernel,
   its loss equal too).  (c) whisper-large-v3 at full width, 4 + 4 layers,
   2 rows of 1500 frames and 64 tokens, two steps: finite losses, times,
   launches.  (d) One f32 train step of the five dense smoke configs,
   whisper's, mamba2's and hymba's (40 tokens: past their chunk of 16
   and hymba's window of 32) and the two MoE configs' on the card against
   the CPU, and one of kimi-k2's smoke config with its own Adafactor and
   bf16 accumulators (tolerances at ``phase_train_parity``).  (f) K3b
   (``ssd_scan_bwd_h100``) through the pick of each key of
   ``SSD_BWD_SIGNATURES`` (mamba2-130m's and hymba-1.5b's training
   microbatches, a ragged seq of 1000 and seq 1 with
   a state0 and a final state's gradient), bf16 (the tensor-core body) and
   f32 (the FMA body): held against its plain version and against
   ``torch.autograd`` of K3's plain version, two launches bit for bit,
   timed eagerly and as device time on copies of its inputs cold to the L2
   beside the plain version and its bound (the chunk formulas' flops at
   the inputs' peak, ``bound_f32_ms`` at the f32 rate, or the bytes), the
   bf16 body's device time over the f32 body's at each key; then, in a
   process of its own, every leaf of its tree, and chunk 128 outside it,
   at (g)'s and (h)'s keys and the three of ``K3B_HELD_OUT`` in bf16, each
   held, bit for bit twice, timed as cold device time and each of its
   three kernels under ``torch.profiler``, the napkin's rank beside the
   card's; the build prints its eight kernels' ``ptxas`` registers and
   spills and fails if one spills.  (g) mamba2-130m at full width and
   depth (24 layers): 4 steps of 8 x 1024 tokens in 2 microbatches, a
   checkpoint of
   step 2 restored and step 2 replayed bit for bit, step 3 under the
   profiler; (h) hymba-1.5b at full width, 4 of 32 layers (reduced: depth
   only), 2 steps of 4 x 2048 tokens in 2 microbatches (the window of 1024
   binds in K2 and K2b), a third under the profiler; both with (b)'s
   records (launches against the step's products, cores and scans: K1
   3·(pL+1)·mb, K4 2·(pL+1)·mb with p = 5 for mamba and 12 for hymba, K2
   L·mb, K2b 3·L·mb, K3 L·mb, K3b 3·L·mb) and the share of the profiled
   step K3 and K3b take.  (i) K1's and K4's batched entries (K1b, K4b)
   at the MoE experts' training keys of one routing group of 1024 tokens
   (``moe_bwd_keys``): llama4-scout's (E 16, C 80: the forward and dA
   products (80, 8192, 5120) and (80, 5120, 8192), dB (5120, 8192, 80)
   and (8192, 5120, 80), transposes (5120, 8192), (80, 5120), (8192,
   5120), (80, 8192)) and kimi-k2's held out (E 384, C 27; dB's f32
   output 22.5 GB): two launches bit for bit, K1b held expert by expert
   against K1's plain version, K4b bit for bit against its own, each
   timed eagerly and as device time on inputs cold to the L2 beside its
   bound and ``torch.bmm`` or ``a.transpose(1, 2).contiguous()``.  (j)
   llama4-scout at full width, 1 of 48 layers (reduced: depth only; 4.1 B
   parameters, 66.3 GB of state), ``remat="full"``: the router's K1
   launched twice bit for bit, then (b)'s records over 4 steps of 2 x
   1024 tokens in 2 microbatches (launches a microbatch: K1 (2+2)·5 + 3,
   K4 2·6, K1b (2+2)·3, K4b 6, K2 2, K2b 3: a block's forward runs twice
   under remat), a fifth under the profiler, peak memory beside the
   reckoned state; no checkpoint (the state has no second copy on the
   card).  Every launch counter is set to 0 just before (b), (c), (g), (h)
   and (j) and read just after.  (e) K4 at each launch signature of (b),
   (c), (g), (h) and (j), bf16 and f32: launches a step, the
   pick eagerly and as device
   time beside its byte bound, ``a.t().contiguous()`` (both ways) and
   ``a.clone()`` (the same bytes untransposed, device time), and
   the pick with the leaves of ``K4_TRAIN_LEAVES``, each bit for bit and
   as device time, the napkin's rank beside the card's.  The launch
   signatures of (b), (c), (g), (h) and (j) are then timed as phase 9
   times a pick (K2b's of (a), K3b's of (f), K1b's and K4b's of (i) and
   K4's of phase 6 and (e) keep their rows), and the five are main paths
   of K1, K1b, K2, K2b, K3, K3b, K4 and K4b in the kernels' line
   (``by_paths`` "training").
14. multi-device at world size 1 (one card: NCCL refuses two ranks on one
   GPU; 2-8 ranks are the CPU tests' business), on split workspaces of
   its own: (a) NCCL started on a ``file://`` store in a temporary
   directory (``launch.mesh.init_distributed``) and the mesh (1, 1) over
   ("data", "model"); one ``all_to_all_single`` and one ``all_reduce``
   over the a2a group bit for bit; NCCL's version.  (b) llama4-smoke and
   kimi-smoke (its Adafactor) under ``moe_a2a``, ten f32 steps of the
   mesh's step on the card over NCCL against the same on the CPU over a
   gloo mesh of the same process, at 13 (d)'s tolerances.  (c) (j) again
   through ``moe_a2a`` and the launcher's step over the NCCL mesh (the
   communicator started in (a), before the state): step 0's loss and
   grad_norm against (j)'s (rtol 1e-5 and 1e-4, and whether bit for bit),
   the step's CUDA-event time, peak memory and launches beside (j)'s, 0
   cold builds, NCCL's device time in the profiled step and one
   all-to-all's CUDA-event time.  (d) kimi-k2, 1 of 61 layers, served as
   phase 8 serves it from the same init with its experts zero-padded to
   the 512 it stores under ``moe_a2a``: the tokens equal phase 8's,
   request for request.  (e) 13 (b)'s llama3-8b run through the mesh
   step and (f) (c) held to 13 (j): step 0 bit for bit, the launches a
   step, 0 cold builds, the peak within 0.1 GB.  (g) the keys a rank of
   (1, 4) and (1, 8) launches for llama3-8b, warmed on abstract meshes
   and each held against its plain version and timed, and the four-card
   cells' ``Layout.rank_bytes()``.  (h) 13 (g)'s mamba2-130m, (h)'s
   hymba-1.5b and (c)'s whisper-large-v3 runs through the mesh step, two
   steps each, and (i) 13 (j)'s llama4-scout run without ``moe_a2a`` (the
   dense MoE layer's expert-parallel code at one rank), each held to its
   phase 13 run as (e) is (every training path, phase 13's too, starts
   with the split workspaces dropped, so each peak counts the workspaces
   it grows).  (j) the keys a four-card rank of those blocks launches,
   warmed on abstract meshes: K3 and K3b at mamba2-130m's 6 and 3 SSD
   heads a rank of (1, 4) and (1, 8) and hymba-1.5b's cut 7 and 4, K2
   and K2b at whisper-large-v3's encoder heads (non-causal 1500 x 1500)
   and cross-attention heads (64 queries over 1500 frames), K1b and K4b
   at llama4-scout's 4 of 16 experts and K1b at kimi-k2's 96 of 384 on
   (4, 1), the routing groups sharded over ``data``; each launch
   signature held against its plain version and timed beside its
   library call; then the rank bytes of hymba-1.5b and whisper-large-v3
   on (1, 4) and kimi-k2 (1 of 61 layers, dense) on (4, 1).  (c), (e),
   (h) and (i) are training paths and (d) an engine path in the kernels'
   line (``by_paths`` "training" and "padded kimi").
15. dry run (``src/repro_torch/launch/dryrun.py``, its count of a launch's
   work ``launch/roofline.py``'s, which this script's bounds read too):
   (a) 13 (b), (c), (g), (h) and (j)'s training paths through the dry run
   on the mesh (1, 1): ``argument_bytes`` equal to the bytes of the state
   and batch the card held and each family's launches a step equal to
   phase 13's counters, exactly (a failure raises); the roofline's bound
   beside the measured median step and the measured peak
   (``torch.cuda.max_memory_allocated``) beside ``argument_bytes``.  (b)
   the four-card cells of 14 (g) and (j) through the dry run at their
   phase 14 runs: rank bytes (``Layout.rank_bytes()``, as 14 prints
   them), collective bytes a step by op (ring model) and the roofline's
   compute, memory and collective terms on the H100's datasheet rates.
   (c) the keys a rank of (pod, data, model) = (2, 2, 1) launches for
   llama4-scout (1 of 48 layers) under ``moe_a2a``, warmed and launched
   on the abstract mesh as 14 (j) does: 0 cold builds, every K1b launch
   signature held against its plain version and timed.  (d) llama3-8b at
   full width (32 layers, bf16 weights) through the non-paged steps on
   one card and through the mesh serve steps (``build_serve_steps(cfg,
   mesh)``) over an NCCL mesh (1, 1) of its own: prefill and 8 decode
   steps' logits bit for bit, the same launches, 0 cold builds.

Times are medians over 5 CUDA-event batches of repeated launches after one
warm-up launch, printed with their spread (the slowest batch less the
fastest): one mean over one batch let a single slow batch set a row.  A
launch whose host cost exceeds its device time reads its host cost this
way, so K1-K6, ``torch.matmul``, SDPA and ``a.t().contiguous()`` also
print ``device_ms`` (``library_device_ms`` for the library call): 20
launches (K4's 5 at 64 MB or more, up to 1 GB each) captured in one CUDA
graph, replayed in 5 batches, the median over them.  A
matmul cycles through copies of its weight operand so that each launch
reads it from device memory, as the serve path does (attention reads K/V
and the SSD scan reads x, b, c that the serve path has just written, so
repeated launches on the same inputs stand for it).  A Jacobi sweep is
timed alone (one launch of ``jacobi1d.sweep``) and cycles through copies of
its two buffers, 2^15 + 2 and 2^21 + 2 alike, so that each launch reads and
writes memory the L2 does not hold; a transpose likewise cycles through
copies of its input and keeps as many of its outputs alive (the training
signatures move 0.5 MB to 1 GB a launch); matadd moves 0.8 GB a launch,
far past the L2.  The bound of a launch
is max(bytes / 3.35 TB/s, flops / peak), with each input read once and each
output written once, the flops of the keys the masks leave visible, the
recurrence's 5·state·hd flops a step and head for the SSD scan, and the
peak of the H100 SXM data sheet for the unit that does the arithmetic (989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32: a bf16 SSD chunk of more
than one step runs its products on the tensor cores, a step or f32 on the
CUDA cores, and ``bound_f32_ms`` gives a chunk's bound with every flop at
the f32 rate beside it), a sum or a Jacobi point in f32, a transpose
none.  The
library call is a yardstick timed only here: ``torch.matmul`` (its output
is bf16, the kernel's f32), ``scaled_dot_product_attention``, ``torch.add``
for matadd and ``a.t().contiguous()`` for transpose (the plain versions of
K5 and K4 are those very calls), and for a Jacobi sweep ``avg_pool1d(x, 3,
stride=1)``, the sweep's interior as a new vector (its largest difference
from the plain sweep is printed, not held); no single PyTorch call computes
the SSD scan, so K3 has none.

The line before the last is the kernels' JSON record (its ``ms`` are the
eager times above, as in every earlier run).  For K1, K1's batched entry,
K2 and K3 ``launches`` is the count over the main paths: phase 8's nine
engine paths, phase 12 (b)'s whisper path and phase 14 (d)'s padded
kimi-k2; ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are sums over those launches, each timed
at its own signature in phase 9 (or 12), and ``by_paths`` gives the same
sums (with ``device_ms``) over the three engine paths of earlier runs
(mamba2, hymba, llama3), the six of PR 20 and whisper apart.  Phase 11
tunes at the nine engine paths' signatures only.  For K4-K6
the same numbers come from phase 6's case-study path (1, 1 and 8
launches), each signature timed in phase 6.  The training paths of phase
13 ((b), (c), (g), (h), (j)) and 14 (c) are main paths too: their
launches and sums are added to those of K1, K1b, K2, K2b, K3, K3b, K4 and
K4b (K4's batched entry, which only training launches), and ``by_paths``
"training" gives them apart.  ``max_abs_err`` is the largest error against the plain
version over phases 3-6, 9, 12 and 13.  The last line is the device
record.

Tolerances, kernel against plain version on the same inputs:

- matmul (bf16 or f32 in, f32 out; the batched entry alike, expert by
  expert), rtol 1e-4 / atol 1e-3: a bf16 product
  is exact in f32, so the two differ only in the order of K f32 additions
  inside a k tile (tensor cores or FMA against cuBLAS); both add the tiles
  of a split in order and the split-K partials in split order 0..kb-1, so
  split-K changes only which sums are grouped; with B scaled by
  1/sqrt(K), as the model's weights are, outputs are O(1) and K <= 14336
  additions drift by at most K * 2^-24 ~ 1e-3.
- attention in bf16, rtol = atol = 1e-2 (the paged entry alike): both
  compute in f32 and round the
  output to bf16 once; the two may round apart by one bf16 step (2^-7);
  the kernel also rounds P to bf16 for the tensor cores (2^-9 relative,
  averaged over the keys), and combines the key splits in the same order.
  At sk 4096 an output element is about 0.02, so 1e-2 barely tells a
  dropped split from rounding: a launch over more than one split is also
  held to ||got - want|| / ||want|| <= 2^-6 (rounding gives a few 2^-9),
  and the same check must refuse a planted fault, the reference computed
  without the first split some query sees.
- SSD scan: rtol = atol = 1e-3 on the f32 state, which both compute in f32
  by the same recurrence in another order of sums (at most 256 + state
  terms of O(1)) and with ``expf``/``logf`` against ``torch.exp``/``log``;
  rtol = atol = 1e-2 on the bf16 y, one bf16 step as for attention.  The
  bf16 chunk body feeds G, the state and w⊙b to the tensor cores as a high
  and a low bf16 part (~16 bits; one rounding of G would break the 1e-2),
  and every bf16 launch is also held to ||got - want|| / ||want|| <= 2^-9
  (sound launches read at most 1.3e-4), a check that must refuse a planted
  fault: the plain version with one step's decay set to 1 (its least
  reading, 1.1e-2, is at a 2048-step hymba row, whose state of 16 forgets
  the fault within a few steps; 2^-6 passed it).
- matadd and transpose (K4's batched entry alike): bit for bit
  (``torch.equal``): a transpose moves
  raw bits, and a sum is one f32 add rounded once to the element type on
  both sides.
- Jacobi, rtol = atol = 1e-5 (the JAX test's): both add the left pair
  first and divide by 3 as IEEE says, so the error printed should be 0;
  the tolerance allows the one-bit roundings of a reciprocal multiply.
- attention backward (K2b), against its plain version and autograd: each
  gradient within 2e-2 (bf16) or 1e-4 (f32) of its largest element, and
  of itself.  All sum in f32; in bf16 each gradient is rounded once
  (2^-8 of an element), the tensor-core body also rounds P and dS to bf16
  before their products (as K2 rounds P), and autograd of the plain
  forward rounds its intermediate casts too; in f32 only the order of sums
  differs (FMA over tiles of keys and queries against whole-row products,
  ``expf`` against ``torch.exp``).
- SSD scan backward (K3b), against its plain version and autograd: each
  gradient within 2e-2 (bf16 dx, db, dc) or 1e-4 (f32, and the f32 da and
  d(state0) whatever the inputs' type) of its largest element, and of
  itself.  All sum in f32 from the same inputs (the same chunk formulas
  in another order, or autograd's step recurrence through the chunked
  forward) and round dx, db and dc once to bf16 (2^-8 of an element);
  ``expf``/``logf`` against ``torch.exp``/``log``.  The bf16 body on the
  tensor cores also rounds M, P⊙L and dS_out (in dX) once to bf16 before
  their products, and feeds S_in, dS_out (in U and V) and the walks'
  weighted b and c as a high and a low part, which keeps da at 1e-4
  (``csrc/ssd_scan_bwd.cu``'s header gives the error one rounding makes).

TF32 is off for the plain versions (``allow_tf32 = False``), so their f32
products on the card are full f32.
"""
from __future__ import annotations

import collections
import functools
import gc
import importlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

DEV = "cuda"
L2_FLUSH_BYTES = 128 * 2**20          # more than twice the H100's 50 MB L2
#: Outputs of this many bytes or more get two launches a CUDA graph (a
#: 22.5 GB dB of kimi-k2 fits the card twice, not twenty times).
BIG_OUTPUT = 1 << 30
MM_TOL = dict(rtol=1e-4, atol=1e-3)
FA_TOL = dict(rtol=1e-2, atol=1e-2)
FA_REL = 2.0 ** -6                    # relative Frobenius error, split rows
SSD_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
SSD_Y_TOL = dict(rtol=1e-2, atol=1e-2)
SSD_REL = 2.0 ** -9                   # relative Frobenius error, bf16 y
JACOBI_TOL = dict(rtol=1e-5, atol=1e-5)
JACOBI_STEPS = 4
BATCHES = 5
MAX_NEW = 8
# (arch, engine sizes, prompt lengths [lo, hi)) of the main paths
PATHS = (
    ("mamba2_130m", dict(max_batch=4, max_len=1024, page_size=16,
                         prefill_chunk=256), (200, 501)),
    ("hymba_1p5b", dict(max_batch=4, max_len=256, page_size=16,
                        prefill_chunk=32), (16, 65)),
    ("llama3_8b", dict(max_batch=4, max_len=256, page_size=16,
                       prefill_chunk=32), (16, 65)),
)
#: The six paths of the dense and MoE configs (arch, layers served, None
#: for all), at llama3-8b's engine settings and prompt lengths.  Full width
#: every one; the MoE paths' depth is cut to what one 80 GB card holds
#: beside the pool and the graphs (bf16 weights: llama4-scout 4.15 GB a
#: layer and 4.1 GB of embeddings, 12 of 48 layers 54.0 GB; kimi-k2 34.1
#: GB a layer and 4.7 GB of embeddings, 1 of 61 layers 38.8 GB).
NEW_PATHS = (
    ("granite_3_8b", None),
    ("yi_6b", None),
    ("qwen1p5_4b", None),
    ("chameleon_34b", None),
    ("llama4_scout_17b_a16e", 12),
    ("kimi_k2_1t_a32b", 1),
)
NEW_KW = dict(PATHS[2][1])
NEW_LENS = PATHS[2][2]
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "matmul_h100": ("src/repro_torch/csrc/matmul.cu",
                    "src/repro/kernels/matmul.py:73"),
    "matmul_h100_batched": ("src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:73"),
    "flash_attention_h100": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:75"),
    "ssd_scan_h100": ("src/repro_torch/csrc/ssd_scan.cu",
                      "src/repro/kernels/ssd_scan.py:70"),
    "transpose_h100": ("src/repro_torch/csrc/transpose.cu",
                       "src/repro/kernels/transpose.py:46"),
    # K4b: K4's batched entry (the experts' transposes of the MoE backward)
    "transpose_h100_batched": ("src/repro_torch/csrc/transpose.cu",
                               "src/repro/kernels/transpose.py:46"),
    "matadd_h100": ("src/repro_torch/csrc/matadd.cu",
                    "src/repro/kernels/matadd.py:37"),
    "jacobi1d_h100": ("src/repro_torch/csrc/jacobi1d.cu",
                      "src/repro/kernels/jacobi1d.py:51"),
    # K2b: the JAX package has no kernel backward (it differentiates einsum
    # attention); this is the backward of K2's function
    "flash_attention_bwd_h100": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                 "src/repro/kernels/flash_attention.py:75"),
    # K3b: the JAX package has no kernel backward (it differentiates
    # ssd_chunk's einsum math); this is the backward of K3's function
    "ssd_scan_bwd_h100": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                          "src/repro/kernels/ssd_scan.py:70"),
}
SERVE_KERNELS = ("matmul_h100", "matmul_h100_batched", "flash_attention_h100",
                 "ssd_scan_h100")
CASE_KERNELS = ("transpose_h100", "matadd_h100", "jacobi1d_h100")
#: The case-study path (phase 6): (family, data) at the paper's sizes.
CASE_PATH = (
    ("matadd_h100", {"M": 8192, "N": 8192}),             # Fig. 2
    ("transpose_h100", {"M": 16384, "N": 16384}),        # Table 3
    ("jacobi1d_h100", {"N": (1 << 15) + 2}),             # Table 2
    ("jacobi1d_h100", {"N": (1 << 21) + 2}),             # largest bucket
)
#: {paged K2 signature: the rows' lengths it is timed and bound at}: phase
#: 4's own, and for phase 9 the lengths phase 8 served at it.
PAGED_LENS = {}


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int) -> tuple:
    """(median, spread) in ms a launch over ``BATCHES`` CUDA-event batches
    of ``reps`` launches each, after one warm-up launch; the spread is the
    slowest batch less the fastest."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2], per[-1] - per[0]


def time_into(row: dict, key: str, fn, reps: int) -> None:
    row[key], row[key + "_spread"] = time_ms(fn, reps)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time a launch: ``reps`` launches captured in one CUDA graph,
    replayed in ``BATCHES`` CUDA-event batches, the median over ``reps``.
    The host enqueues one graph, so a launch's host cost drops out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ms = time_ms(g.replay, 1)[0] / reps
    del g
    return ms


def held(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict
         ) -> float:
    """Max |got - want|; raises unless every element is within tol."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{name}: max_abs_err {err:.3e} outside "
                             f"rtol {tol['rtol']} / atol {tol['atol']}")
    return err


def _roofline():
    """The port's one count of a launch's work and the H100's datasheet
    rates (``src/repro_torch/launch/roofline.py``), which the dry run
    reads too."""
    from repro_torch.launch import roofline
    return roofline


def work(name: str, sig) -> tuple:
    """(bytes, flops, peak flop/s) of one launch of ``name`` at ``sig``
    (``roofline.work``); a paged K2 launch counts each row at its length
    in ``PAGED_LENS``, a K2b call in ``BWD_LENS``."""
    lens = (BWD_LENS.get(sig) if name == "flash_attention_bwd_h100"
            else PAGED_LENS.get(sig) if sig[0] == "paged" else None)
    return _roofline().work(name, sig, lens)


def bound_terms_ms(name: str, sig) -> tuple:
    nbytes, flops, peak = work(name, sig)
    return (1e3 * nbytes / _roofline().HBM_BYTES_PER_S, 1e3 * flops / peak)


def ssd_bwd_f32_bound_ms(sig) -> float:
    return _roofline().ssd_bwd_f32_bound_ms(sig)


def ssd_f32_bound_ms(sig) -> float:
    return _roofline().ssd_f32_bound_ms(sig)


# ---------------------------------------------------------------------------
# K1, K2 and K3 at one signature: check against plain, time, bound
# ---------------------------------------------------------------------------

def matmul_case(sig, gen, *, timed: bool, leaf_only: bool = False,
                a=None, b=None):
    """K1 at (M, N, K, bm, bn, bk, s, kb, stages, cached, dtype), the
    wrapper's ``shapes`` key, on fresh inputs (or ``a``, ``b``): held
    against the plain version; timed when ``timed`` (the kernel alone when
    ``leaf_only``)."""
    from repro_torch.kernels.matmul import matmul_h100, matmul_plain
    M, N, K, bm, bn, bk, s, kb, stages, cached, dtype = sig
    if a is None:
        a = torch.randn((M, K), generator=gen, device=DEV).to(dtype)
        b = (torch.randn((K, N), generator=gen, device=DEV)
             / math.sqrt(K)).to(dtype)
    kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages, cached=cached)
    got = matmul_h100(a, b, **kw)
    torch.cuda.synchronize()
    want = matmul_plain(a, b, **kw)
    row = {"err": held(f"matmul {sig}", got, want, MM_TOL)}
    if timed:
        # the serve path reads each weight matrix cold: cycle through enough
        # copies of B that none is still in the 50 MB L2 when it comes back
        bs = itertools.cycle([b] + [b.clone() for _ in range(
            math.ceil(L2_FLUSH_BYTES / (b.numel() * b.element_size())) - 1)])
        time_into(row, "ms", lambda: matmul_h100(a, next(bs), **kw), 10)
        row["device_ms"] = graph_ms(lambda: matmul_h100(a, next(bs), **kw))
        if not leaf_only:
            time_into(row, "plain_ms",
                      lambda: matmul_plain(a, next(bs), **kw), 2)
            time_into(row, "library_ms",
                      lambda: torch.matmul(a, next(bs)), 10)
            row["library_device_ms"] = graph_ms(
                lambda: torch.matmul(a, next(bs)))
        row["bound_ms"] = max(bound_terms_ms("matmul_h100", sig))
    return row


def batched_case(sig, gen, *, timed: bool, leaf_only: bool = False,
                 plain_timed: bool = True):
    """K1's batched entry at (E, M, N, K, bm, bn, bk, s, kb, stages, cached,
    dtype), the wrapper's ``shapes`` key, on fresh inputs (B over
    1/sqrt(K)): two launches bit for bit, each expert held against K1's
    plain version one at a time (a 22.5 GB output of kimi-k2's training
    needs no second copy beside it); timed when ``timed``, the kernel
    eagerly and as device time on copies of the inputs cold to the L2 (an
    operand past the flush size, both MoE paths' experts at 1.34 and 11.3
    GB, alone: it cannot stay in the L2) beside the byte and flop bound,
    and unless ``leaf_only`` ``torch.bmm`` as a yardstick (bf16 out) and,
    when ``plain_timed``, the plain version.  Outputs of ``BIG_OUTPUT``
    bytes or more get two launches a graph."""
    from repro_torch.kernels.matmul import (matmul_batched_plain,
                                            matmul_h100_batched, matmul_plain)
    E, M, N, K, bm, bn, bk, s, kb, stages, cached, dtype = sig
    a = torch.randn((E, M, K), generator=gen, device=DEV, dtype=dtype)
    b = torch.randn((E, K, N), generator=gen, device=DEV, dtype=dtype)
    b.div_(math.sqrt(K))
    kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages, cached=cached)
    got = matmul_h100_batched(a, b, **kw)
    again = matmul_h100_batched(a, b, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"matmul batched {sig}: two launches differ")
    del again
    row = {"err": max(held(f"matmul batched {sig} expert {e}", got[e],
                           matmul_plain(a[e], b[e], **kw), MM_TOL)
                      for e in range(E))}
    del got
    torch.cuda.empty_cache()
    if not timed:
        return row
    ins = _cold_copies((a, b), (a.numel() + b.numel()) * a.element_size())
    reps = 2 if E * M * N * 4 >= BIG_OUTPUT else 20
    kernel = lambda: matmul_h100_batched(*next(ins), **kw)  # noqa: E731
    time_into(row, "ms", kernel, min(reps, 10))
    row["device_ms"] = graph_ms(kernel, reps)
    row["bound_ms"] = max(bound_terms_ms("matmul_h100_batched", sig))
    if leaf_only:
        return row
    if plain_timed:
        time_into(row, "plain_ms",
                  lambda: matmul_batched_plain(*next(ins), **kw), 1)
    library = lambda: torch.bmm(*next(ins))  # noqa: E731
    time_into(row, "library_ms", library, min(reps, 10))
    row["library_device_ms"] = graph_ms(library, reps)
    torch.cuda.empty_cache()
    return row


def _visible(sq: int, sk: int, causal: bool, window) -> torch.Tensor:
    return _roofline().visible(sq, sk, causal, window, device=DEV)


_SDPA_GQA = []


def sdpa_gqa() -> bool:
    """Whether the installed ``scaled_dot_product_attention`` takes
    ``enable_gqa`` (K/V with fewer heads than q); else phase 4 and 9 time it
    on K/V broadcast outside the timed loop."""
    if not _SDPA_GQA:
        q = torch.zeros((1, 2, 1, 8), device=DEV)
        try:
            F.scaled_dot_product_attention(q, q[:, :1], q[:, :1],
                                           enable_gqa=True)
            _SDPA_GQA.append(True)
        except TypeError:
            _SDPA_GQA.append(False)
    return _SDPA_GQA[0]


def _masked_attention(q, k, v, mask) -> torch.Tensor:
    """f32 attention of q [h, sq, d] over the keys ``mask`` [sq, sk] leaves,
    K/V broadcast to q's heads; a row that sees no key gives 0."""
    group = q.shape[0] // k.shape[0]
    s = (q.float() @ k.float().repeat_interleave(group, 0).transpose(1, 2)
         / math.sqrt(q.shape[-1])).masked_fill(~mask, -math.inf)
    p = torch.softmax(s, -1).nan_to_num(0.0)
    return p @ v.float().repeat_interleave(group, 0)


def split_held(name, q, k, v, got, want, kv_chunk, causal, window) -> tuple:
    """(relative error, planted fault's relative error) of a launch over
    more than one key split: ||got - want|| / ||want|| within ``FA_REL``,
    and the same check refusing the reference computed without the first
    split some query sees."""
    def rel(x):
        return float((x.float() - want.float()).norm()
                     / want.float().norm())
    err = rel(got)
    if err > FA_REL:
        raise AssertionError(f"{name}: relative error {err:.3e} > {FA_REL}")
    sq, sk = q.shape[1], k.shape[1]
    mask = _visible(sq, sk, causal, window)
    z0 = int(mask.any(0).nonzero()[0]) // kv_chunk * kv_chunk
    keys = torch.arange(sk, device=DEV)
    fault = rel(_masked_attention(
        q, k, v, mask & ((keys < z0) | (keys >= z0 + kv_chunk))).to(q.dtype))
    if fault <= FA_REL:
        raise AssertionError(f"{name}: the relative check passes a launch "
                             f"without split {z0 // kv_chunk} ({fault:.3e})")
    return err, fault


def kernel_us(fn, calls: int = 20) -> dict:
    """{kernel name: device µs a call} of ``fn`` under ``torch.profiler``,
    over ``calls`` calls after 3 warm-up calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if e.count and t:
            out[e.key] = out.get(e.key, 0.0) + t / calls
    return out


def flash_case(sig, gen, *, timed: bool, launches: int = 1,
               leaf_only: bool = False, profiled: bool = False):
    """K2 at (h, hk, sq, sk, d, bq, bkv, kv_chunk, stages, causal, window,
    dtype), the wrapper's ``shapes`` key, on fresh inputs: held against the
    plain version (and ``launches`` launches equal bit for bit; over more
    than one split also by ``split_held``); timed eagerly and as device
    time beside SDPA when ``timed`` (the kernel alone when ``leaf_only``),
    each kernel's device time under the profiler when ``profiled``."""
    from repro_torch.kernels.flash_attention import (flash_attention_h100,
                                                     flash_attention_plain)
    if sig[0] == "paged":
        return paged_case(sig, gen, timed=timed, launches=launches,
                          leaf_only=leaf_only)
    h, hk, sq, sk, d, bq, bkv, kv_chunk, stages, causal, window, dtype = sig
    q = torch.randn((h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((hk, sk, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((hk, sk, d), generator=gen, device=DEV).to(dtype)
    kw = dict(bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
              causal=causal, window=window)
    got = flash_attention_h100(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    row = {"err": held(f"flash {sig}", got, want, FA_TOL)}
    if sk > kv_chunk:
        row["rel"], row["fault_rel"] = split_held(
            f"flash {sig}", q, k, v, got, want, kv_chunk, causal, window)
    for _ in range(launches - 1):
        if not torch.equal(got, flash_attention_h100(q, k, v, **kw)):
            raise AssertionError(f"flash {sig}: two launches differ")
    if timed:
        mask = _visible(sq, sk, causal, window)
        sdpa_mask = None if bool(mask.all()) else mask
        if sdpa_gqa():
            ks, vs, extra = k[None], v[None], {"enable_gqa": h != hk}
        else:
            ks = k.repeat_interleave(h // hk, 0)[None]
            vs = v.repeat_interleave(h // hk, 0)[None]
            extra = {}
        def sdpa():
            return F.scaled_dot_product_attention(
                q[None], ks, vs, attn_mask=sdpa_mask, **extra)
        time_into(row, "ms",
                  lambda: flash_attention_h100(q, k, v, **kw), 10)
        row["device_ms"] = graph_ms(
            lambda: flash_attention_h100(q, k, v, **kw))
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
        if leaf_only:
            return row
        time_into(row, "plain_ms",
                  lambda: flash_attention_plain(q, k, v, **kw), 2)
        time_into(row, "library_ms", sdpa, 10)
        row["library_device_ms"] = graph_ms(sdpa)
    if profiled:
        row["k2_us"] = kernel_us(lambda: flash_attention_h100(q, k, v, **kw))
        row["sdpa_us"] = kernel_us(sdpa)
    return row


def paged_case(sig, gen, *, timed: bool, launches: int = 1,
               leaf_only: bool = False, against_ref: bool = False):
    """K2's paged entry at ("paged", rows, h, hk, sq, nblk·page, d, page,
    bq, bkv, kv_chunk, stages, causal, window, dtype, pool dtype), its
    ``shapes`` key, each row at its length in ``PAGED_LENS``: a pool of
    rows · nblk + 1 blocks, each row's table a random draw of them.  Held
    against the paged plain version (a row of length 0 all zeros; each row
    over more than one split also by ``split_held`` on its gathered keys;
    ``launches`` launches bit for bit); timed eagerly and as device time
    beside SDPA over the gathered K/V with each row's mask (SDPA's time
    leaves out the gather) when ``timed`` (the kernel alone when
    ``leaf_only``).  With ``against_ref`` each row is also held against
    ``kernels.ref.flash_attention`` over its gathered keys (one query head
    a KV head)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_h100_paged, flash_attention_paged_plain)
    (_, rows, h, hk, sq, keys, d, page, bq, bkv, kv_chunk, stages, causal,
     window, dtype, kv_dtype) = sig
    lens = PAGED_LENS[sig]
    nblk = keys // page
    nb = rows * nblk + 1
    q = torch.randn((rows, h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((nb, page, hk, d), generator=gen, device=DEV).to(kv_dtype)
    v = torch.randn((nb, page, hk, d), generator=gen, device=DEV).to(kv_dtype)
    tables = (torch.randperm(nb - 1, generator=gen, device=DEV) + 1).view(
        rows, nblk).to(torch.int32)
    tl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    kw = dict(bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
              causal=causal, window=window)

    def launch():
        return flash_attention_h100_paged(q, k, v, tables, tl, **kw)

    got = launch()
    torch.cuda.synchronize()
    want = flash_attention_paged_plain(q, k, v, tables, tl, **kw)
    row = {"err": held(f"paged flash {sig[:-2]} lens {lens}", got, want,
                       FA_TOL)}

    def gathered(pool, b, n):
        return pool[tables[b].long()].reshape(-1, hk, d)[:n].permute(
            1, 0, 2).contiguous()

    rels = []
    for b, n in enumerate(lens):
        if against_ref and n:
            row["ref_err"] = max(row.get("ref_err", 0.0), held(
                f"paged flash {sig[:-2]} row {b} against ref", got[b],
                ref.flash_attention(q[b], gathered(k, b, n),
                                    gathered(v, b, n), causal=causal,
                                    window=window), FA_TOL))
        if n == 0:
            exact(f"paged flash {sig[:-2]} row {b} of length 0", got[b],
                  torch.zeros_like(got[b]))
        elif n > kv_chunk:
            rels.append(split_held(
                f"paged flash {sig[:-2]} row {b}", q[b], gathered(k, b, n),
                gathered(v, b, n), got[b], want[b], kv_chunk, causal,
                window))
    if rels:
        row["rel"] = max(r[0] for r in rels)
        row["fault_rel"] = min(r[1] for r in rels)
    for _ in range(launches - 1):
        if not torch.equal(got, launch()):
            raise AssertionError(f"paged flash {sig[:-2]}: two launches "
                                 "differ")
    if timed and leaf_only:
        time_into(row, "ms", launch, 10)
        row["device_ms"] = graph_ms(launch)
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
    elif timed:
        kpos = torch.arange(keys, device=DEV)
        qpos = (torch.arange(sq, device=DEV)[None, :, None]
                + tl[:, None, None] - sq)                 # [rows, sq, 1]
        mask = kpos < tl[:, None, None]
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        kg = k[tables.long()].reshape(rows, keys, hk, d).permute(0, 2, 1, 3)
        vg = v[tables.long()].reshape(rows, keys, hk, d).permute(0, 2, 1, 3)
        kg, vg = kg.to(dtype).contiguous(), vg.to(dtype).contiguous()
        if sdpa_gqa():
            extra = {"enable_gqa": h != hk}
        else:
            kg = kg.repeat_interleave(h // hk, 1)
            vg = vg.repeat_interleave(h // hk, 1)
            extra = {}

        def sdpa():
            return F.scaled_dot_product_attention(q, kg, vg,
                                                  attn_mask=mask[:, None],
                                                  **extra)
        time_into(row, "ms", launch, 10)
        row["device_ms"] = graph_ms(launch)
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
        time_into(row, "plain_ms", lambda: flash_attention_paged_plain(
            q, k, v, tables, tl, **kw), 2)
        time_into(row, "library_ms", sdpa, 10)
        row["library_device_ms"] = graph_ms(sdpa)
    return row


def ssd_rel_held(name, y, want, fault) -> tuple:
    """(relative error, planted fault's relative error) of a bf16 launch:
    ||y - want|| / ||want|| within ``SSD_REL``, and the same check refusing
    ``fault``, the plain version's y with one step's decay set to 1."""
    def rel(t):
        return float((t.float() - want.float()).norm()
                     / want.float().norm())
    err, bad = rel(y), rel(fault)
    if err > SSD_REL:
        raise AssertionError(f"{name}: relative error {err:.3e} > {SSD_REL}")
    if bad <= SSD_REL:
        raise AssertionError(f"{name}: the relative check passes a launch "
                             f"with one step's decay set to 1 ({bad:.3e})")
    return err, bad


def ssd_case(sig, gen, *, timed: bool, leaf_only: bool = False,
             drop: int = -1):
    """K3 at (rows, seq, heads, hd, state, chunk, bd, state given, masked,
    state rows, dtype), the wrapper's ``shapes`` key, on inputs shaped as
    the model makes them: x, b, c in the compute type, b and c one [rows,
    seq, state] projection shared across heads, the decay in (0.05, 0.95)
    and the state in f32, updated in place as the serve path does, with a
    mask of every row but ``drop`` (none when -1) when masked.  With state
    rows > 0 the state has that many rows and ``state_rows`` sends row r to
    state row (state rows − 1 − r), as a prefill chunk of slot 3 of 4 is
    sent; the state rows no index names must stay bit for bit.  Held
    against the plain version (a row left out bit for bit; a bf16 launch
    also by relative error, against a planted fault); timed eagerly and as
    device time when ``timed`` (the kernel alone when ``leaf_only``)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_h100, ssd_scan_plain
    R, S, H, hd, n, chunk, bd, with_state, masked, srows, dtype = sig
    x = torch.randn((R, S, H, hd), generator=gen, device=DEV).to(dtype)
    a = torch.sigmoid(torch.randn((R, S, H), generator=gen,
                                  device=DEV)) * 0.9 + 0.05
    b = torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
    c = torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
    s0 = (torch.randn((srows or R, H, n, hd), generator=gen, device=DEV)
          if with_state or srows else None)
    mask = (torch.arange(R, device=DEV) != drop) if masked else None
    rows = (srows - 1 - torch.arange(R, device=DEV)).int() if srows else None
    kw = dict(chunk=chunk, bd=bd, mask=mask, state_rows=rows)

    def state():                             # a copy to update in place
        return s0.clone() if s0 is not None else None

    def start(st):                           # state0 is None: no state in
        return st if with_state else None

    st = state()
    y, s1 = ssd_scan_h100(x, a, b, c, start(st), out_state=st, **kw)
    torch.cuda.synchronize()
    ws = state()
    wy, ws = ssd_scan_plain(x, a, b, c, start(ws), out_state=ws, **kw)
    row = {"err": max(held(f"ssd state {sig}", s1, ws, SSD_STATE_TOL),
                      held(f"ssd y {sig}", y, wy, SSD_Y_TOL))}
    if drop >= 0:
        kept = int(rows[drop]) if srows else drop
        exact(f"ssd state of masked row {drop} {sig}", s1[kept], s0[kept])
    if srows:
        named = set(rows.tolist())
        for r in range(srows):
            if r not in named:
                exact(f"ssd state row {r} no index names {sig}", s1[r],
                      s0[r])
    if dtype == torch.bfloat16:
        af = a.clone()
        af[:, S // 2] = 1.0                  # step S // 2 forgets no state
        fs = state()
        fault, _ = ssd_scan_plain(x, af, b, c, start(fs), out_state=fs, **kw)
        row["rel"], row["fault_rel"] = ssd_rel_held(f"ssd {sig}", y, wy,
                                                    fault)
        row["fault"] = "one decay set to 1"
    if timed:
        def launch():
            return ssd_scan_h100(x, a, b, c, start(st), out_state=st, **kw)
        time_into(row, "ms", launch, 10)
        row["device_ms"] = graph_ms(launch)
        row["bound_ms"] = max(bound_terms_ms("ssd_scan_h100", sig))
        row["bound_f32_ms"] = ssd_f32_bound_ms(sig)
        if not leaf_only:
            ps = state()
            time_into(row, "plain_ms", lambda: ssd_scan_plain(
                x, a, b, c, start(ps), out_state=ps, **kw), 2)
            row["library_ms"] = None
    return row


def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0; raises unless ``got`` equals ``want`` bit for bit."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(
            got, want):
        raise AssertionError(f"{name}: not equal to the plain version")
    return 0.0


def _cold_copies(tensors, nbytes: int):
    """A cycle over copies of ``tensors`` (the originals first), enough
    that ``L2_FLUSH_BYTES`` lie between two uses of one copy."""
    n = max(1, math.ceil(L2_FLUSH_BYTES / nbytes))
    return itertools.cycle([tensors] + [tuple(t.clone() for t in tensors)
                                        for _ in range(n - 1)])


def matadd_case(sig, gen, *, timed: bool, shift: int = 0):
    """K5 at (M, N, bm, bn, s, dtype); ``shift`` 1 puts A and B one element
    into their buffers, off the 16-byte boundary the vector loads need."""
    from repro_torch.kernels.matadd import matadd_h100, matadd_plain
    M, N, bm, bn, s, dtype = sig
    a, b = (torch.randn((M * N + shift,), generator=gen, device=DEV).to(
        dtype)[shift:].view(M, N) for _ in range(2))
    kw = dict(bm=bm, bn=bn, s=s)
    got = matadd_h100(a, b, **kw)
    torch.cuda.synchronize()
    row = {"err": exact(f"matadd {sig}", got, matadd_plain(a, b, **kw))}
    if timed:
        time_into(row, "ms", lambda: matadd_h100(a, b, **kw), 10)
        row["device_ms"] = graph_ms(lambda: matadd_h100(a, b, **kw))
        time_into(row, "plain_ms", lambda: matadd_plain(a, b, **kw), 10)
        time_into(row, "library_ms", lambda: torch.add(a, b), 10)
        row["bound_ms"] = max(bound_terms_ms("matadd_h100", sig))
    return row


def _k4_graph_reps(a: torch.Tensor) -> int:
    """Launches a K4 graph holds: 5 of 64 MB or more (up to 1 GB each),
    else 20, which a launch of a few microseconds needs to average out."""
    return 5 if a.numel() * a.element_size() >= 1 << 26 else 20


def _cold_launches(a: torch.Tensor):
    """Wraps a transpose ``fn(x)`` into a launch on the next of enough
    copies of ``a`` that ``L2_FLUSH_BYTES`` lie between two uses of one,
    with as many of its outputs kept alive: each launch reads its input
    from device memory and writes lines the L2 does not hold, as the byte
    bound counts (an 8 or 13 MB transpose repeated on one input and output
    reads 98-105 % of its bound)."""
    nbytes = a.numel() * a.element_size()
    ins = _cold_copies((a,), nbytes)
    keep = max(1, math.ceil(L2_FLUSH_BYTES / nbytes))

    def cold(fn):
        outs = collections.deque(maxlen=keep)
        return lambda: outs.append(fn(next(ins)[0]))
    return cold


def transpose_case(sig, gen, *, timed: bool):
    from repro_torch.kernels.transpose import transpose_h100, transpose_plain
    M, N, bm, bn, s, cached, dtype = sig
    a = torch.randn((M, N), generator=gen, device=DEV).to(dtype)
    kw = dict(bm=bm, bn=bn, s=s, cached=cached)
    got = transpose_h100(a, **kw)
    torch.cuda.synchronize()
    row = {"err": exact(f"transpose {sig}", got, transpose_plain(a, **kw))}
    if timed:
        reps, cold = _k4_graph_reps(a), _cold_launches(a)
        kernel = cold(lambda x: transpose_h100(x, **kw))
        library = cold(lambda x: x.t().contiguous())
        time_into(row, "ms", kernel, 10)
        row["device_ms"] = graph_ms(kernel, reps)
        time_into(row, "plain_ms",
                  cold(lambda x: transpose_plain(x, **kw)), 10)
        time_into(row, "library_ms", library, 10)
        row["library_device_ms"] = graph_ms(library, reps)
        # the same bytes moved without the transpose: what the card gives
        # a launch of this size
        row["copy_device_ms"] = graph_ms(cold(lambda x: x.clone()), reps)
        row["bound_ms"] = max(bound_terms_ms("transpose_h100", sig))
    return row


def jacobi_case(sig, gen, *, timed: bool):
    """K6 at (n, B, s, cached, dtype): ``JACOBI_STEPS`` sweeps against the
    plain version; timed a sweep (one launch) at a time."""
    from repro_torch.kernels.jacobi1d import (jacobi1d_h100, jacobi1d_plain,
                                              sweep)
    n, B, s, cached, _ = sig
    x = torch.randn((n,), generator=gen, device=DEV)
    kw = dict(B=B, s=s, cached=cached)
    got = jacobi1d_h100(x, JACOBI_STEPS, **kw)
    torch.cuda.synchronize()
    row = {"err": held(f"jacobi {sig}", got,
                       jacobi1d_plain(x, JACOBI_STEPS, **kw), JACOBI_TOL)}
    if timed:
        bufs = _cold_copies((x, x.clone()), 8 * n)
        time_into(row, "ms", lambda: sweep(*next(bufs), **kw), 10)
        row["device_ms"] = graph_ms(lambda: sweep(*next(bufs), **kw))
        time_into(row, "plain_ms",
                  lambda: jacobi1d_plain(next(bufs)[0], 1, **kw), 10)
        time_into(row, "library_ms", lambda: F.avg_pool1d(
            next(bufs)[0].view(1, 1, -1), 3, 1), 10)
        one = jacobi1d_plain(x, 1, **kw)[1:-1]
        row["library_err"] = float(
            (F.avg_pool1d(x.view(1, 1, -1), 3, 1).view(-1) - one).abs().max())
        row["bound_ms"] = max(bound_terms_ms("jacobi1d_h100", sig))
    return row


CASES = {"matmul_h100": matmul_case, "matmul_h100_batched": batched_case,
         "flash_attention_h100": flash_case,
         "ssd_scan_h100": ssd_case, "transpose_h100": transpose_case,
         "matadd_h100": matadd_case, "jacobi1d_h100": jacobi_case}


def fmt(row) -> str:
    out = f"max_abs_err {row['err']:.3e}"
    for key in ("ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_f32_ms"):
        if row.get(key) is not None:
            out += f" {key} {row[key]:.4f}"
            if key + "_spread" in row:
                out += f" (spread {row[key + '_spread']:.4f})"
    if "ref_err" in row:
        out += f" ref_err {row['ref_err']:.3e}"
    if "library_err" in row:
        out += f" library_err {row['library_err']:.3e}"
    if "rel" in row:
        fault = row.get("fault", "without a split")
        out += f" rel_err {row['rel']:.3e} ({fault} {row['fault_rel']:.3e})"
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0])
    say(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")


def ptxas_lines(log: str, prefix: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel whose name holds ``prefix`` in an ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if prefix in m.group(1) else None
            spill = None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and spill is not None:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    secs = build.build_all()
    say(f"[build] nvcc sm_90a, {len(build.SOURCES)} sources in parallel: "
        f"{secs:.1f} s")
    # K2b's kernels: registers and spills, none allowed in the tensor-core
    # body (lse, dq_tc, dkdv_tc; the f32 FMA body is printed as it is)
    lines = ptxas_lines(build.build_log("flash_attention_bwd"), "fa_bwd")
    if len(lines) != 10:
        raise AssertionError(f"K2b: ptxas reported {len(lines)} of its 10 "
                             f"kernels")
    for name, regs, st, ld in lines:
        short = re.search(r"fa_bwd_\w+?kernelI\w*?Li(\d+)", name)
        label = (re.search(r"fa_bwd_\w+?kernel", name).group(0) +
                 f"<{'f32, ' if 'kernelIf' in name else ''}D "
                 f"{short.group(1)}>")
        say(f"[build] K2b {label}: ptxas {regs} registers, spill stores "
            f"{st} bytes, spill loads {ld} bytes")
        if ("_tc_" in name or "_lse_" in name) and (st or ld):
            raise AssertionError(f"K2b {label} spills registers")
    # K4's sixteen kernels (cached and uncached, two element sizes, four
    # grains): registers and spills, none allowed
    lines = ptxas_lines(build.build_log("transpose"), "transpose_")
    if len(lines) != 16:
        raise AssertionError(f"K4: ptxas reported {len(lines)} of its 16 "
                             f"kernels")
    for name, regs, st, ld in lines:
        kind, elem, s = re.search(r"(transpose_(?:un)?cached)I([tj])Li(\d)",
                                  name).groups()
        label = f"{kind}<{'bf16' if elem == 't' else 'f32'}, s {s}>"
        say(f"[build] K4 {label}: ptxas {regs} registers, spill stores "
            f"{st} bytes, spill loads {ld} bytes")
        if st or ld:
            raise AssertionError(f"K4 {label} spills registers")
    # K3b's eight kernels (the bf16 body's walk and chunk kernels, each for
    # at most 4 and 8 tiles or items a warp; the f32 body's states and
    # chunks; heads in both types): registers and spills, none allowed
    lines = ptxas_lines(build.build_log("ssd_scan_bwd"), "ssd_bwd_")
    if len(lines) != 8:
        raise AssertionError(f"K3b: ptxas reported {len(lines)} of its 8 "
                             f"kernels")
    for name, regs, st, ld in lines:
        kind = re.search(r"ssd_bwd_\w+?_kernel", name).group(0)
        items = re.search(r"kernelILi(\d+)E", name)
        label = (f"{kind}<{items.group(1)} a warp>" if items else
                 f"{kind}<{'f32' if 'kernelIf' in name else 'bf16'}>")
        say(f"[build] K3b {label}: ptxas {regs} registers, spill stores "
            f"{st} bytes, spill loads {ld} bytes")
        if st or ld:
            raise AssertionError(f"K3b {label} spills registers")


#: The K1 signatures PERF.md follows (M, N, K), bf16: decode and prefill
#: projections of the three models, each timed at the pick and eleven
#: other leaves.
MM_SIGNATURES = (
    ("llama decode q/o proj", (4, 4096, 4096)),
    ("llama decode lm_head", (4, 128256, 4096)),
    ("llama prefill MLP down", (1, 4096, 14336)),
    ("hymba decode B/C proj", (4, 16, 1600)),
    ("hymba decode MLP up", (4, 5504, 1600)),
    ("mamba prefill x proj", (256, 1536, 768)),
)
MM_PARAMS = ("bm", "bn", "bk", "s", "kb", "stages")


def _mm_sig(data, cand, dtype) -> tuple:
    """The launch signature of candidate ``cand`` (an uncached leaf runs
    one stage)."""
    from repro_torch.kernels.matmul import FAMILY
    fn = FAMILY.instantiate(cand.plan, cand.assignment, "cuda",
                            leaf_index=cand.leaf_index)
    return (data["M"], data["N"], data["K"],
            *(fn.keywords[n] for n in MM_PARAMS), fn.keywords["cached"],
            dtype)


def _mm_leaves(data, want: int = 12) -> list:
    """The pick, then the feasible leaves one step from it (kb, stages, bn,
    bm, s or bk changed), then the napkin's two worst, then its best others:
    ``want`` candidates of different (bm, bn, bk, s, kb, stages, cached)."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels.matmul import FAMILY
    ranked = rank_candidates(FAMILY, H100_SXM, data)
    key = lambda c: (*(c.assignment[n] for n in MM_PARAMS),
                     c.plan.flags["smem_cache"])
    by_key = {}
    for c in ranked:
        by_key.setdefault(key(c), c)
    pick = ranked[0]
    order = [pick]
    p = dict(pick.assignment)
    steps = [("kb", 2), ("kb", 0.5), ("stages", None), ("bn", 2),
             ("bn", 0.5), ("bm", 2), ("s", None), ("bk", None)]
    for name, f in steps:
        near = dict(p)
        if f is None:
            dom = sorted({c.assignment[name] for c in ranked})
            others = [x for x in dom if x != p[name]]
            if not others:
                continue
            near[name] = others[0]
        else:
            near[name] = int(p[name] * f)
        c = by_key.get((*(near[n] for n in MM_PARAMS), True))
        if c is not None:
            order.append(c)
    order += ranked[:-3:-1] + ranked[1:]
    out, seen = [], set()
    for c in order:
        if key(c) not in seen:
            seen.add(key(c))
            out.append(c)
        if len(out) == want:
            break
    return out


def phase_k1(gen) -> float:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config("llama3_8b")
    d, hd = cfg.d_model, cfg.hd
    err = 0.0
    for M in (4, 32):
        triples = [(cfg.heads * hd, d), (cfg.kv_heads * hd, d),
                   (cfg.d_ff, d), (d, cfg.d_ff), (cfg.vocab, d)]
        for N, K in triples:                  # q and out proj are 4096²
            m = 1 if (N == cfg.vocab and M == 32) else M  # prefill lm_head
            data = {"M": m, "N": N, "K": K}
            cand = ops.select("matmul_h100", data)
            row = matmul_case(_mm_sig(data, cand, torch.bfloat16), gen,
                              timed=False)
            err = max(err, row["err"])
            say(f"[K1] M{m} N{N} K{K} leaf {dict(cand.assignment)} cached "
                f"{cand.plan.flags['smem_cache']}: {fmt(row)}")

    # ragged and misaligned: N = 25 (f32, the decay projection) and N =
    # 32001 (bf16, hymba's lm_head) take the masked load of B; M = 1; a
    # storage offset of one element takes the masked load of A and B
    for (M, N, K), dtype in [((4, 25, 1600), torch.float32),
                             ((1, 25, 1600), torch.float32),
                             ((4, 32001, 1600), torch.bfloat16),
                             ((1, 32001, 1600), torch.bfloat16)]:
        data = {"M": M, "N": N, "K": K}
        cand = ops.select("matmul_h100", data)
        row = matmul_case(_mm_sig(data, cand, dtype), gen, timed=False)
        err = max(err, row["err"])
        say(f"[K1] ragged {dtype} M{M} N{N} K{K} leaf "
            f"{dict(cand.assignment)}: {fmt(row)}")
    for dtype in (torch.float32, torch.bfloat16):
        M, N, K = 5, 4096, 1000
        a = torch.randn((M * K + 1,), generator=gen, device=DEV).to(dtype)
        b = (torch.randn((K * N + 1,), generator=gen, device=DEV)
             / math.sqrt(K)).to(dtype)
        a, b = a[1:].view(M, K), b[1:].view(K, N)
        sig = (M, N, K, 16, 128, 32, 1, 8, 4, True, dtype)
        row = matmul_case(sig, gen, timed=False, a=a, b=b)
        err = max(err, row["err"])
        say(f"[K1] misaligned {dtype} (storage offset 1) {sig[:-1]}: "
            f"{fmt(row)}")

    # two launches bit for bit, through the split-K combine
    data = dict(zip("MNK", MM_SIGNATURES[0][1]))
    cand = ops.select("matmul_h100", data)
    a = torch.randn((data["M"], data["K"]), generator=gen, device=DEV
                    ).bfloat16()
    b = torch.randn((data["K"], data["N"]), generator=gen, device=DEV
                    ).bfloat16()
    fn = ops.FAMILIES["matmul_h100"].instantiate(cand.plan, cand.assignment,
                                                 "cuda")
    first = fn(a, b)
    same = all(torch.equal(first, fn(a, b)) for _ in range(4))
    say(f"[K1] five launches of {dict(cand.assignment)} at {data}: bit for "
        f"bit equal {same}")
    if not same:
        raise AssertionError("K1: two launches on the same inputs differ")

    # leaves of the tree at each signature: napkin rank, card rank
    for name, (M, N, K) in MM_SIGNATURES:
        data = {"M": M, "N": N, "K": K}
        leaves = _mm_leaves(data)
        if len(leaves) < 8:
            raise AssertionError(f"{name}: only {len(leaves)} leaves")
        a = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        b = (torch.randn((K, N), generator=gen, device=DEV)
             / math.sqrt(K)).bfloat16()
        rows = {}
        for cand in leaves:
            sig = _mm_sig(data, cand, torch.bfloat16)
            rows[sig] = dict(matmul_case(sig, gen, timed=True,
                                         leaf_only=True, a=a, b=b),
                             score=cand.score)
            err = max(err, rows[sig]["err"])
        del a, b
        torch.cuda.empty_cache()
        rank = {key: sorted(rows, key=lambda k: rows[k][key])
                for key in ("ms", "device_ms")}
        by_score = sorted(rows, key=lambda k: -rows[k]["score"])
        for i, (sig, row) in enumerate(rows.items()):
            leaf = dict(zip(MM_PARAMS + ("cached",), sig[3:10]))
            say(f"[K1] leaf {name} M{M} N{N} K{K} {leaf}"
                f"{' (pick)' if i == 0 else ''}: {fmt(row)}; napkin score "
                f"{row['score']:.4g} rank {by_score.index(sig) + 1}, card "
                f"rank {rank['ms'].index(sig) + 1} (device "
                f"{rank['device_ms'].index(sig) + 1}) of {len(rows)}")
        pick = rows[next(iter(rows))]
        for key in ("ms", "device_ms"):
            best = rows[rank[key][0]][key]
            say(f"[K1] {name}: {key} pick {pick[key]:.4f}, fastest of "
                f"{len(rows)} leaves {best:.4f} ({pick[key] / best:.2f}x)")
    return err


#: K1's batched entry at the experts' signatures of the two MoE paths,
#: (E, M, N, K) for up (wi, wg) and down (wo): M = 4 is the capacity of a
#: decode step's 4 rows and of every chunk up to 32 tokens at both configs.
BATCHED_SIGNATURES = (
    ("llama4-scout expert up", (16, 4, 8192, 5120)),
    ("llama4-scout expert down", (16, 4, 5120, 8192)),
    ("kimi-k2 expert up", (384, 4, 2048, 7168)),
    ("kimi-k2 expert down", (384, 4, 7168, 2048)),
)


def phase_k1_batched(gen) -> tuple:
    """K1's batched entry through the pick of the per-expert key, at
    ``BATCHED_SIGNATURES``: held against the plain version and timed
    beside ``torch.bmm`` and the bound (every expert's weights read once);
    returns (largest error, {sig: row}), the rows phase 9 reuses."""
    from repro_torch.kernels import ops
    err, rows = 0.0, {}
    for name, (E, M, N, K) in BATCHED_SIGNATURES:
        data = {"M": M, "N": N, "K": K}
        cand = ops.select("matmul_h100", data)
        sig = (E,) + _mm_sig(data, cand, torch.bfloat16)
        row = rows[sig] = batched_case(sig, gen, timed=True)
        err = max(err, row["err"])
        say(f"[K1 batched] {name} E{E} M{M} N{N} K{K} leaf "
            f"{dict(cand.assignment)} cached {cand.plan.flags['smem_cache']}"
            f": {fmt(row)} (library: torch.bmm)")
        torch.cuda.empty_cache()
    return err, rows


#: Phase 4's rows: (name, h, hk, sq, sk, d, causal, window).  One KV head
#: a query head (the old contract), GQA at the llama3-8b (32/8) and
#: hymba-1.5b (25/5, d 64, window 1024) groupings, and the long-context
#: rows at sk 4096 the serve path's short prompts never reach.
K2_ROWS = (
    ("prefill chunk", 32, 32, 32, 96, 128, True, None),
    ("decode", 32, 32, 1, 77, 128, True, None),
    ("non-causal sk 200", 32, 32, 32, 200, 128, False, None),
    ("window 128", 32, 32, 32, 300, 128, True, 128),
    ("llama GQA prefill chunk", 32, 8, 32, 96, 128, True, None),
    ("llama GQA decode", 32, 8, 1, 77, 128, True, None),
    ("hymba GQA prefill chunk", 25, 5, 32, 96, 64, True, 1024),
    ("hymba GQA decode", 25, 5, 1, 77, 64, True, 1024),
    ("llama decode sk 4096", 32, 8, 1, 4096, 128, True, None),
    ("llama 256-row prefill sk 4096", 32, 8, 256, 4096, 128, True, None),
    ("hymba decode sk 4096, window 1024", 25, 5, 1, 4096, 64, True, 1024),
)


def _fa_sig(h, hk, sq, sk, d, causal, window, dtype=torch.bfloat16):
    """The launch signature of the dispatch's pick for these shapes."""
    from repro_torch.kernels import ops
    a = ops.select("flash_attention_h100",
                   {"SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk}
                   ).assignment
    return (h, hk, sq, sk, d, a["bq"], a["bkv"], a["kv_chunk"], a["stages"],
            causal, window, dtype)


#: The K2 signatures whose leaves phase 4 times (name, h, hk, sq, sk, d,
#: causal, window): a serve decode step and prefill chunk of llama3-8b,
#: the two llama rows at sk 4096 and hymba-1.5b's windowed decode there.
K2_LEAF_ROWS = (
    ("llama decode sk 64", 32, 8, 1, 64, 128, True, None),
    ("llama prefill chunk sq 32 sk 64", 32, 8, 32, 64, 128, True, None),
    ("llama decode sk 4096", 32, 8, 1, 4096, 128, True, None),
    ("llama 256-row prefill sk 4096", 32, 8, 256, 4096, 128, True, None),
    ("hymba decode sk 4096, window 1024", 25, 5, 1, 4096, 64, True, 1024),
)
FA_PARAMS = ("bq", "bkv", "kv_chunk", "stages")
#: Phase 4's paged rows: (name, h, hk, d, window, rows, sq, lengths, nblk,
#: page, q dtype), on a bf16 pool: decode over 4 rows of ragged lengths,
#: one of them 0, at both groupings over a 4096-key pool (more than one
#: split), a prefill chunk at the served pool of 256 keys, and f32 q on the
#: bf16 pool (the f32 models of phase 7).
K2_PAGED_ROWS = (
    ("llama paged decode", 32, 8, 128, None, 4, 1, (77, 0, 1000, 4096), 256,
     16, torch.bfloat16),
    ("hymba paged decode", 25, 5, 64, 1024, 4, 1, (77, 0, 1500, 4096), 256,
     16, torch.bfloat16),
    ("llama paged prefill chunk", 32, 8, 128, None, 1, 32, (96,), 16, 16,
     torch.bfloat16),
    ("hymba paged prefill chunk", 25, 5, 64, 1024, 1, 32, (200,), 16, 16,
     torch.bfloat16),
    ("llama paged decode, f32 q on the bf16 pool", 32, 8, 128, None, 4, 1,
     (77, 0, 150, 256), 16, 16, torch.float32),
)


def _paged_sig(h, hk, d, window, rows, sq, nblk, page, dtype,
               causal=True, assignment=None) -> tuple:
    """The paged launch signature of the dispatch's pick for these shapes
    (or of the leaf ``assignment``), on a bf16 pool."""
    from repro_torch.kernels import ops
    a = assignment or ops.select(
        "flash_attention_h100",
        {"SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk}).assignment
    return ("paged", rows, h, hk, sq, nblk * page, d, page,
            *(a[n] for n in FA_PARAMS), causal, window, dtype,
            torch.bfloat16)


def _fa_leaves(data, want: int = 10) -> list:
    """The pick, then the feasible leaves one step from it (bq, kv_chunk
    doubled and halved, the other bkv and stages), then the napkin's two
    worst, then its best others: ``want`` candidates of different formats."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels.flash_attention import FAMILY
    ranked = rank_candidates(FAMILY, H100_SXM, data)
    key = lambda c: tuple(c.assignment[n] for n in FA_PARAMS)
    by_key = {}
    for c in ranked:
        by_key.setdefault(key(c), c)
    pick = ranked[0]
    p = dict(pick.assignment)
    order = [pick]
    for name, vals in (("bq", (2 * p["bq"], p["bq"] // 2)),
                       ("kv_chunk", (2 * p["kv_chunk"], p["kv_chunk"] // 2)),
                       ("bkv", (96 - p["bkv"],)),
                       ("stages", (2, 3, 4))):
        for val in vals:
            c = by_key.get(tuple({**p, name: val}[n] for n in FA_PARAMS))
            if c is not None:
                order.append(c)
    order += ranked[:-3:-1] + ranked[1:]
    out, seen = [], set()
    for c in order:
        if key(c) not in seen:
            seen.add(key(c))
            out.append(c)
        if len(out) == want:
            break
    return out


def _profile_line(times: dict) -> str:
    """'total: kernel t; ...' of ``kernel_us``, longest first, K2's two
    kernels by their short names."""
    def short(name):
        return next((k for k in ("combine_kernel", "flash_kernel")
                     if k in name), name[:48])
    parts = "; ".join(f"{short(n)} {t:.2f}" for n, t in
                      sorted(times.items(), key=lambda kv: -kv[1]))
    return f"{sum(times.values()):.2f} ({parts})"


def phase_k2(gen) -> float:
    err = 0.0
    for name, h, hk, sq, sk, d, causal, window in K2_ROWS:
        sig = _fa_sig(h, hk, sq, sk, d, causal, window)
        # a split pick (sk past kv_chunk) is launched three times, bit for bit
        splits = -(-sk // sig[7])
        row = flash_case(sig, gen, timed=True,
                         launches=3 if splits > 1 else 1, profiled=True)
        err = max(err, row["err"])
        leaf = dict(zip(("bq", "bkv", "kv_chunk", "stages"), sig[5:9]))
        say(f"[K2] {name}: h{h} hk{hk} sq{sq} sk{sk} d{d} window {window} "
            f"leaf {leaf}, {splits} split(s)"
            f"{', three launches bit for bit equal' if splits > 1 else ''}: "
            f"{fmt(row)}")
        say(f"[K2] {name}: device us a call (profiler): K2 "
            f"{_profile_line(row['k2_us'])}; SDPA "
            f"{_profile_line(row['sdpa_us'])}")
    say(f"[K2] SDPA timed with enable_gqa: {sdpa_gqa()}")

    # the paged entry: every row of a layer in one launch, through the
    # tables, at the lengths on the device
    for name, h, hk, d, window, rows, sq, lens, nblk, page, dtype in \
            K2_PAGED_ROWS:
        sig = _paged_sig(h, hk, d, window, rows, sq, nblk, page, dtype)
        PAGED_LENS[sig] = lens
        nsplit = -(-nblk * page // sig[10])
        row = paged_case(sig, gen, timed=True,
                         launches=3 if nsplit > 1 else 1)
        err = max(err, row["err"])
        leaf = dict(zip(FA_PARAMS, sig[8:12]))
        say(f"[K2] {name}: rows {rows} h{h} hk{hk} sq{sq} d{d} window "
            f"{window} lengths {list(lens)}, pool {nblk} x {page} keys, "
            f"{dtype} q, leaf {leaf}, {nsplit} split(s)"
            f"{', three launches bit for bit equal' if nsplit > 1 else ''}"
            f", row of length 0 all zeros: {fmt(row)} (SDPA over K/V "
            f"gathered beforehand: its time leaves out the gather)")

    # leaves of the tree at each signature: napkin rank, card rank
    for name, h, hk, sq, sk, d, causal, window in K2_LEAF_ROWS:
        rows = {}
        for cand in _fa_leaves({"SQ": sq, "HD": d, "GROUP": h // hk,
                                "HK": hk}):
            sig = (h, hk, sq, sk, d,
                   *(cand.assignment[n] for n in FA_PARAMS), causal, window,
                   torch.bfloat16)
            rows[sig] = dict(flash_case(sig, gen, timed=True,
                                        leaf_only=True), score=cand.score)
            err = max(err, rows[sig]["err"])
        rank = {k: sorted(rows, key=lambda s: rows[s][k])
                for k in ("ms", "device_ms")}
        by_score = sorted(rows, key=lambda s: -rows[s]["score"])
        for i, (sig, row) in enumerate(rows.items()):
            leaf = dict(zip(FA_PARAMS, sig[5:9]))
            say(f"[K2] leaf {name} {leaf}{' (pick)' if i == 0 else ''}: "
                f"{fmt(row)}; napkin score {row['score']:.4g} rank "
                f"{by_score.index(sig) + 1}, card rank "
                f"{rank['ms'].index(sig) + 1} (device "
                f"{rank['device_ms'].index(sig) + 1}) of {len(rows)}")
        pick = rows[next(iter(rows))]
        for k in ("ms", "device_ms"):
            best = rows[rank[k][0]][k]
            say(f"[K2] {name}: {k} pick {pick[k]:.4f}, fastest of "
                f"{len(rows)} leaves {best:.4f} ({pick[k] / best:.2f}x)")
    return err


#: Phase 5's leaf rows: a one-row 256-step mamba2-130m prefill chunk.
K3_LEAF_SIG = (1, 256, 24, 64, 128)
K3_PARAMS = ("chunk", "bd")


def phase_k3(gen) -> float:
    from repro_torch.configs import get_config
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import FAMILY as SSD
    err = 0.0
    for arch in ("mamba2_130m", "hymba_1p5b"):
        s = get_config(arch).ssm
        cases = [("decode, 4 rows, in place", 4, 1, True, True, -1),
                 ("decode, 4 rows, in place, row 2 masked out", 4, 1, True,
                  True, 2)]
        cases += [(f"chunk {n}", 1, n, True, False, -1) for n in
                  (1, 2, 4, 8, 16, 32, 64, 128, 256)]
        cases += [("seq 200, no state", 1, 200, False, False, -1),
                  ("seq 200, state in", 1, 200, True, False, -1)]
        # a prefill chunk's launch: the whole 4-slot state, slot 3 picked
        # on the device, in the step body and in the chunk body
        cases += [(f"chunk {n}, state row 3 of 4 by state_rows", 1, n, True,
                   False, -1, 4) for n in (4, 32 if s.state < 64 else 256)]
        for name, rows, seq, with_state, masked, drop, *srows in cases:
            a = ops.select("ssd_scan_h100", {"SQ": seq, "HD": s.head_dim,
                                             "STATE": s.state}).assignment
            sig = (rows, seq, s.heads, s.head_dim, s.state, a["chunk"],
                   a["bd"], with_state, masked, srows[0] if srows else 0,
                   torch.bfloat16)
            row = ssd_case(sig, gen, timed=False, drop=drop)
            err = max(err, row["err"])
            say(f"[K3] {arch} {name}: heads {s.heads} hd {s.head_dim} state "
                f"{s.state} leaf {dict(a)}: {fmt(row)}"
                f"{'; the masked row kept its state bit for bit' if drop >= 0 else ''}"
                f"{'; the other state rows kept theirs bit for bit' if srows else ''}")

    # every feasible leaf at one 256-step mamba chunk: napkin rank, card rank
    R, S, H, hd, n = K3_LEAF_SIG
    data = {"SQ": S, "HD": hd, "STATE": n}
    ranked = rank_candidates(SSD, H100_SXM, data)
    leaves, seen = [], set()
    for cand in ranked:
        key = tuple(cand.assignment[k] for k in K3_PARAMS)
        if key not in seen:
            seen.add(key)
            leaves.append(cand)
    if len(leaves) < 5:
        raise AssertionError(f"only {len(leaves)} K3 leaves at {data}")
    rows = {}
    for cand in leaves:
        sig = (R, S, H, hd, n, cand.assignment["chunk"],
               cand.assignment["bd"], True, False, 0, torch.bfloat16)
        rows[sig] = dict(ssd_case(sig, gen, timed=True, leaf_only=True),
                         score=cand.score)
        err = max(err, rows[sig]["err"])
    rank = {k: sorted(rows, key=lambda g: rows[g][k])
            for k in ("ms", "device_ms")}
    by_score = sorted(rows, key=lambda g: -rows[g]["score"])
    for i, (sig, row) in enumerate(rows.items()):
        leaf = dict(zip(K3_PARAMS, sig[5:7]))
        say(f"[K3] leaf {leaf}{' (pick)' if i == 0 else ''} at rows {R} seq "
            f"{S} heads {H} hd {hd} state {n}: {fmt(row)}; napkin score "
            f"{row['score']:.4g} rank {by_score.index(sig) + 1}, card rank "
            f"{rank['ms'].index(sig) + 1} (device "
            f"{rank['device_ms'].index(sig) + 1}) of {len(rows)}")
    pick = rows[next(iter(rows))]
    for k in ("ms", "device_ms"):
        best = rows[rank[k][0]][k]
        say(f"[K3] seq {S} chunk: {k} pick {pick[k]:.4f}, fastest of "
            f"{len(rows)} leaves {best:.4f} ({pick[k] / best:.2f}x)")
    return err


def _format(family, cand) -> tuple:
    """The launch format of a candidate: its program parameters with the
    grain the kernel runs, and whether it stages in shared memory."""
    from repro_torch.kernels.instantiate_cache import grain
    a, plan = cand.assignment, cand.plan
    if family.name == "matadd_h100":
        return a["bm"], a["bn"], a["s"], True
    cached = bool(plan.flags["smem_cache"])
    if family.name == "transpose_h100":
        return a["bm"], a["bn"], grain(plan, a["s"]), cached
    return a["B"], grain(plan, a["s"]), cached


def _feasible_formats(family, machine, data) -> dict:
    """{launch format: its best-scored candidate} over the tree's feasible
    candidates for ``machine`` and ``data``."""
    from repro_torch.core.select import rank_candidates
    out = {}
    for cand in rank_candidates(family, machine, data, max_per_leaf=4096):
        out.setdefault(_format(family, cand), cand)
    return out


#: Leaves timed at each size of the case-study path (phase 6), as launch
#: formats: (bm, bn, grain, cached) for matadd and transpose, (B, grain,
#: cached) for Jacobi.  The H100_SXM pick is timed first, then these
#: formats feasible under H100_SXM, then those of the leaves only a
#: smaller machine keeps (matadd's grain-1 case C2 at G = 12, the uncached
#: case 3 at V = 0), which H100_SXM never picks.
CASE_LEAVES = {
    "matadd_h100": (
        [(1, 32, 2, True), (4, 64, 2, True), (8, 128, 2, True),
         (32, 32, 2, True), (1, 1024, 2, True)],
        ("G = 12", dict(vreg_budget=12),
         [(1, 256, 1, True), (32, 32, 1, True)])),
    "transpose_h100": (
        [(32, 32, 1, True), (32, 32, 4, True), (32, 32, 8, True),
         (8, 128, 2, True), (16, 64, 1, True), (1, 1024, 1, True)],
        ("V = 0", dict(vmem_bytes=0),
         [(32, 32, 1, False), (1, 1024, 1, False)])),
    "jacobi1d_h100": (
        [(32, 1, True), (128, 2, True), (256, 4, True), (1024, 8, True),
         (512, 1, True)],
        ("V = 0", dict(vmem_bytes=0), [(256, 1, False)])),
}


def _sig(name, data, form, dtype) -> tuple:
    """The launch signature (the wrapper's ``shapes`` key) of the launch
    format ``form``."""
    if name == "jacobi1d_h100":
        return (data["N"], *form, dtype)
    if name == "matadd_h100":
        return (data["M"], data["N"], *form[:3], dtype)
    return (data["M"], data["N"], *form, dtype)


def case_leaf_rows(name, data, gen) -> dict:
    """Time up to eight leaves of different launch formats at one size of
    the case-study path; print each beside the napkin's and the card's
    rank.  Returns {signature: row}."""
    import dataclasses
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels import ops
    family = ops.FAMILIES[name]
    live, (label, change, small) = CASE_LEAVES[name]
    picks = _feasible_formats(family, H100_SXM, data)
    pick = _format(family, ops.select(name, data))
    runs = [(pick, picks[pick], "H100_SXM pick")]
    runs += [(f, picks.get(f), "live under H100_SXM") for f in live
             if f != pick]
    others = _feasible_formats(family, dataclasses.replace(H100_SXM,
                                                           **change), data)
    runs += [(f, others.get(f), f"live only at {label}") for f in small]
    rows = {}
    for form, cand, why in runs:
        if cand is None:
            raise AssertionError(f"{name} {form} is no feasible leaf at "
                                 f"{data} ({why})")
        sig = _sig(name, data, form, torch.float32)
        rows[sig] = dict(CASES[name](sig, gen, timed=True),
                         score=cand.score, why=why)
    by_score = sorted(rows, key=lambda k: -rows[k]["score"])
    by_ms = sorted(rows, key=lambda k: rows[k]["ms"])
    for sig, row in rows.items():
        say(f"[cases] leaf {name} {sig[:-1]} ({row['why']}): {fmt(row)}; "
            f"napkin score {row['score']:.4g} rank "
            f"{by_score.index(sig) + 1}, card rank {by_ms.index(sig) + 1} "
            f"of {len(rows)}")
    return rows


def _counters(names) -> dict:
    """{name: the kernel's public wrapper, which carries its launch
    counter}, each from the module named after its CUDA source."""
    return {n: getattr(importlib.import_module(
        "repro_torch.kernels." + Path(KERNELS[n][0]).stem), n) for n in names}


def phase_cases(gen) -> dict:
    """The case-study path at the paper's sizes (phase 6); returns each
    kernel's launches and launch shapes on the path, the rows timed at
    those shapes and the largest error of each kernel."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.kernels.jacobi1d import jacobi1d_plain
    from repro_torch.kernels.matadd import matadd_plain
    from repro_torch.kernels.transpose import transpose_plain
    t0 = time.perf_counter()
    cache = get_default_cache()
    cache.freeze([(ops.FAMILIES[f], H100_SXM, d) for f, d in CASE_PATH])
    stats = cache.stats
    resolved0 = (stats.cold_builds, stats.memory_hits)
    (_, add_d), (_, tr_d) = CASE_PATH[:2]
    a = torch.randn(add_d["M"], add_d["N"], generator=gen, device=DEV)
    b = torch.randn(add_d["M"], add_d["N"], generator=gen, device=DEV)
    t = torch.randn(tr_d["M"], tr_d["N"], generator=gen, device=DEV)
    xs = [torch.randn((d["N"],), generator=gen, device=DEV)
          for _, d in CASE_PATH[2:]]

    kernels = _counters(CASE_KERNELS)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()

    def counted(name, want, fn):
        n0 = kernels[name].launches
        out = fn()
        if kernels[name].launches - n0 != want:
            raise AssertionError(f"{name}: {kernels[name].launches - n0} "
                                 f"launches, want {want}")
        return out

    add = counted("matadd_h100", 1, lambda: ops.matadd(a, b))
    tr = counted("transpose_h100", 1, lambda: ops.transpose(t))
    jac = [counted("jacobi1d_h100", JACOBI_STEPS,
                   lambda x=x: ops.jacobi1d(x, JACOBI_STEPS)) for x in xs]
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    shapes = {n: dict(k.shapes) for n, k in kernels.items()}
    wall = time.perf_counter() - t0
    resolved = (stats.cold_builds - resolved0[0],
                stats.memory_hits - resolved0[1])
    say(f"[cases] path: matadd {tuple(a.shape)}, transpose "
        f"{tuple(t.shape)}, jacobi n {[x.numel() for x in xs]} x "
        f"{JACOBI_STEPS} sweeps; launches {json.dumps(launches)}; "
        f"dispatches outside the frozen lane (cold, LRU): {resolved}")
    if any(resolved):
        raise AssertionError(f"{resolved} dispatches left the frozen lane")
    errs = {"matadd_h100": exact("ops.matadd", add, a + b),
            "transpose_h100": exact("ops.transpose", tr,
                                    t.t().contiguous())}
    errs["jacobi1d_h100"] = max(
        held(f"ops.jacobi1d n {x.numel()}", y,
             jacobi1d_plain(x, JACOBI_STEPS, B=32, s=1), JACOBI_TOL)
        for x, y in zip(xs, jac))
    say(f"[cases] path agrees with the plain versions: matadd and "
        f"transpose bit for bit, jacobi max_abs_err "
        f"{errs['jacobi1d_h100']:.3e}")
    del add, tr, jac

    # bf16 at 8192² and ragged shapes, through the same ops
    ab = a.bfloat16()
    tb = t[:add_d["M"], :add_d["N"]].contiguous().bfloat16()
    exact("ops.matadd bf16", ops.matadd(ab, ab.flip(0)), ab + ab.flip(0))
    exact("ops.transpose bf16", ops.transpose(tb), tb.t().contiguous())
    r = a[:300, :700].contiguous()
    exact("ops.matadd 300x700", ops.matadd(r, r.flip(1)), r + r.flip(1))
    exact("ops.transpose 300x700", ops.transpose(r), r.t().contiguous())
    x = xs[0][:1026].contiguous()
    errs["jacobi1d_h100"] = max(errs["jacobi1d_h100"], held(
        "ops.jacobi1d n 1026", ops.jacobi1d(x, JACOBI_STEPS),
        jacobi1d_plain(x, JACOBI_STEPS, B=32, s=1), JACOBI_TOL))
    # thin operands: matadd's (1, 2^25) has 16,384 column blocks (on the
    # grid's x), its (2^22, 8) and transpose's (4, 2^25) more than 65,535
    # blocks on the grid's y (one launch a 65,535)
    w = torch.randn((1 << 25,), generator=gen, device=DEV)
    exact("ops.matadd 1x2^25", ops.matadd(w[None], w.flip(0)[None]),
          w[None] + w.flip(0)[None])
    t8 = w.view(1 << 22, 8)
    exact("ops.matadd 2^22x8", ops.matadd(t8, t8.flip(0)), t8 + t8.flip(0))
    w = w.repeat(4).view(4, 1 << 25)
    exact("ops.transpose 4x2^25", ops.transpose(w), w.t().contiguous())
    del w, t8
    say(f"[cases] bf16 matadd and transpose at {tuple(ab.shape)}, f32 at "
        f"{tuple(r.shape)} and n {x.numel()}, matadd at (1, 2^25) and "
        f"(2^22, 8) and transpose at (4, 2^25): agree")
    del a, b, t, xs, ab, tb
    torch.cuda.empty_cache()

    rows = {name: {} for name in kernels}
    for name, data in CASE_PATH:
        rows[name].update(case_leaf_rows(name, data, gen))
    # K5's pick at 8192² in bf16, and in f32 with A and B one element into
    # their buffers (the masked scalar path), bit for bit and timed
    pick = _format(ops.FAMILIES["matadd_h100"],
                   ops.select("matadd_h100", add_d))
    for dtype, shift in ((torch.bfloat16, 0), (torch.float32, 1)):
        sig = _sig("matadd_h100", add_d, pick, dtype)
        row = matadd_case(sig, gen, timed=True, shift=shift)
        if not shift:
            rows["matadd_h100"][sig] = row
        say(f"[cases] matadd pick {sig[:-1]} {dtype}"
            f"{', misaligned by one element' if shift else ''}: {fmt(row)}")
    for name, by_sig in shapes.items():
        for sig in by_sig:
            if sig not in rows[name]:          # the pick, timed above
                raise AssertionError(f"{name} {sig} was not timed")
            errs[name] = max(errs[name], rows[name][sig]["err"])
    torch.cuda.empty_cache()
    say(f"[cases] phase {time.perf_counter() - t0:.1f} s (the path itself "
        f"{1e3 * wall:.1f} ms)")
    return {"launches": launches, "shapes": shapes, "rows": rows,
            "errs": errs}


def _serve(cfg, params, prompts, device, **kw):
    from repro_torch.runtime import ServeEngine
    eng = ServeEngine(cfg, params, device=device, **kw)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r for r in eng.run_until_drained()}
    return eng, [done[r] for r in rids]


def _to(node, device):
    """A parameter tree (dicts, lists, tensors) copied to ``device``."""
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device)


def phase_parity() -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model

    for arch in [a for a, _, _ in PATHS] + [a for a, _ in NEW_PATHS]:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        params_cpu = init_model(cfg, seed=7, device="cpu")
        if cfg.qkv_bias:          # init makes them zero: plant non-zero ones
            g = torch.Generator().manual_seed(7)
            for lp in params_cpu["layers"]:
                for name in ("bq", "bk", "bv"):
                    lp["attn"][name].normal_(generator=g)
        params_gpu = _to(params_cpu, DEV)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 19, 11, 3, 26)]
        kw = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8,
                  warm_kernels=True)
        _, on_cpu = _serve(cfg, params_cpu, prompts, "cpu", **kw)
        cpu_toks = [r.out for r in on_cpu]
        say(f"[parity] {cfg.name} f32, cpu plain:    {cpu_toks}")
        for depth in (1, 2):
            eng, on_gpu = _serve(cfg, params_gpu, prompts, DEV,
                                 async_depth=depth, **kw)
            gpu_toks = [r.out for r in on_gpu]
            st = eng.sched.stats
            prefills = sum(g.replays for g in eng.prefill_graphs.values())
            say(f"[parity] {cfg.name} f32, cuda kernels, decode graph "
                f"replayed {eng.graph.replays} times, prefill graphs "
                f"{prefills} times for {st.prefill_chunks} chunks, eager "
                f"prefill bodies {eng.eager_prefills}, async_depth {depth}: "
                f"{gpu_toks}")
            if eng.graph.replays != st.decode_ticks:
                raise AssertionError(f"{cfg.name}: {eng.graph.replays} "
                                     "graph replays, "
                                     f"{st.decode_ticks} decode ticks")
            if prefills != st.prefill_chunks or eng.eager_prefills:
                raise AssertionError(f"{cfg.name}: {prefills} prefill graph "
                                     f"replays and {eng.eager_prefills} eager"
                                     f" prefills for {st.prefill_chunks} "
                                     "chunks")
            eng.close()
            if gpu_toks != cpu_toks or any(len(t) != MAX_NEW
                                           for t in gpu_toks):
                raise AssertionError(
                    f"serve parity ({cfg.name}, async_depth {depth}): "
                    "tokens differ between the kernels on cuda and the "
                    "plain versions on cpu")


def tick_profile(replay) -> str:
    """A decode tick's device time by kernel under ``torch.profiler`` (20
    calls of ``replay``, uncounted): K1-K3 and the rest, with the rest's
    largest kernels."""
    times = kernel_us(replay)
    groups = {"K1": ("matmul_kernel",),
              "K2": ("flash_kernel", "combine_kernel"),
              "K3": ("ssd_",)}
    sums = {g: 0.0 for g in list(groups) + ["other"]}
    other = {}
    for name, t in times.items():
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)), "other")
        sums[g] += t
        if g == "other":
            other[name[:60]] = t
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    return (f"decode tick device us by kernel (profiler, a replay): "
            f"total {sum(sums.values()):.1f}; "
            + ", ".join(f"{g} {t:.1f}" for g, t in sums.items())
            + "; largest other: "
            + "; ".join(f"{n} {t:.1f}" for n, t in top))


class _TickClock:
    """Times an engine's steps: the host clock from ``step()``'s start to a
    graph replay's return, and CUDA events around the replay (its device
    time), for each prefill chunk (by its length) and for each decode tick
    that ran no prefill chunk."""

    def __init__(self, eng):
        self.eng, self.decode_graph = eng, eng.graph
        self.host, self.events = {}, {}
        self._t0 = self._chunks = None
        step = eng.step

        def timed_step():
            self._t0 = time.perf_counter()
            self._chunks = eng.sched.stats.prefill_chunks
            return step()
        eng.step = timed_step
        eng.graph = _Timed(self, "decode", eng.graph)
        eng.prefill_graphs = {C: _Timed(self, C, g)
                              for C, g in eng.prefill_graphs.items()}

    def profile(self) -> str:
        """The decode tick's device time by kernel under ``torch.profiler``
        (20 replays of the graph on the last tick's inputs, uncounted)."""
        return tick_profile(self.decode_graph.graph.replay)

    def lines(self) -> list:
        """One line for the decode ticks, one a prefill chunk length:
        host and device medians (and ranges) in ms."""
        torch.cuda.synchronize()
        out = []
        for key in sorted(self.events, key=lambda k: (k != "decode", k)):
            dev = sorted(s.elapsed_time(e) for s, e in self.events[key])
            host = sorted(1e3 * t for t in self.host[key])
            what = ("decode tick (no prefill chunk in it" if key == "decode"
                    else f"prefill chunk of {key} tokens (one graph replay")
            out.append(
                f"{what}, {len(dev)} of them): host {host[len(host) // 2]:.3f}"
                f" ms median (from step() to the replay's return; "
                f"{host[0]:.3f}-{host[-1]:.3f}), device "
                f"{dev[len(dev) // 2]:.3f} ms median (CUDA events around the "
                f"replay; {dev[0]:.3f}-{dev[-1]:.3f})")
        return out or ["no step timed"]


class _Timed:
    """One captured step of an engine, timed by ``clock`` under ``key`` at
    each replay."""

    def __init__(self, clock: _TickClock, key, step):
        self.clock, self.key, self.step = clock, key, step

    def __call__(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.step()
        end.record()
        c = self.clock
        if self.key != "decode" or \
                c.eng.sched.stats.prefill_chunks == c._chunks:
            c.host.setdefault(self.key, []).append(
                time.perf_counter() - c._t0)
            c.events.setdefault(self.key, []).append((start, end))

    def __getattr__(self, name):               # replays, graph, delta
        return getattr(self.step, name)


def _serve_wall(eng, prompts) -> tuple:
    """Serve ``prompts`` on ``eng``; (wall s, outputs, ticks)."""
    ticks = eng.sched.ticks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r.out for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, [done[r] for r in rids],
            eng.sched.ticks - ticks)


def phase_trace(eng, prompts, outs) -> None:
    """llama3-8b served again on its engine under ``obs.tracing()``: the
    tick count against the ``TickSpan`` count, the wall with and without
    the trace (alternated, two runs each), and the device's idle share
    over a traced run under ``torch.profiler``: 1 − (the device time of
    every kernel and copy it lists) / that run's wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    walls = {False: [], True: []}
    for traced in (False, True, True, False):
        if traced:
            with obs.tracing() as rec:
                wall, toks, ticks = _serve_wall(eng, prompts)
            spans = [r for r in rec.records() if r["etype"] == "tick_span"]
            bad = [r for r in rec.records() if r["etype"] not in (
                "tick_span", "admission_decision")]
            say(f"[trace] {eng.cfg.name}: {ticks} ticks, {len(spans)} "
                f"TickSpan records, {len(rec)} records in all "
                f"({rec.dropped} dropped); median span "
                f"{sorted(r['duration_us'] for r in spans)[len(spans) // 2]:.1f}"
                f" us on the engine's clock; other records: {len(bad)}")
            if len(spans) != ticks or rec.dropped:
                raise AssertionError(f"{ticks} ticks, {len(spans)} spans")
            if bad:
                raise AssertionError(f"records past warm-up: {bad[:2]}")
        else:
            wall, toks, ticks = _serve_wall(eng, prompts)
        walls[traced].append(wall)
        if toks != outs:
            raise AssertionError("tokens of a repeated run differ")
    say(f"[trace] {eng.cfg.name} wall s untraced "
        f"{', '.join(f'{w:.3f}' for w in walls[False])}, traced "
        f"{', '.join(f'{w:.3f}' for w in walls[True])} (runs in the order "
        "untraced, traced, traced, untraced)")
    with obs.tracing(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, toks, _ = _serve_wall(eng, prompts)
    busy_us = 0.0                     # self times: nothing counted twice
    for e in prof.key_averages():
        busy_us += (getattr(e, "self_device_time_total", 0)
                    or getattr(e, "self_cuda_time_total", 0) or 0)
    if not busy_us or toks != outs:
        raise AssertionError("the profiler saw no device time, or the "
                             "profiled run's tokens differ")
    idle = 1.0 - busy_us / 1e6 / wall
    say(f"[trace] {eng.cfg.name} device idle share over a traced run under "
        f"torch.profiler: {idle:.4f} (device busy {busy_us / 1e3:.3f} ms of "
        f"{1e3 * wall:.3f} ms wall; against the faster traced wall without "
        f"the profiler {1.0 - busy_us / 1e6 / min(walls[True]):.4f})")


def phase_serve(arch: str, serve_kw: dict, prompt_lens: tuple,
                depths: tuple = (1,), traced: bool = False,
                layers=None, padded: bool = False) -> dict:
    """One main path: ``arch`` at full width through ServeEngine (its depth
    cut to ``layers`` when given); returns its name, wall time, peak
    device memory and each kernel's launches and launch shapes.  Each
    depth of ``depths`` past the first serves the same prompts once more at
    that ``async_depth``: its tokens must equal the first run's.  With
    ``traced``, :func:`phase_trace` serves them again on the engine.
    With ``padded`` the config takes the ``moe_a2a`` flag and each layer's
    expert stacks are padded with zero experts to the count it stores
    (``a2a_padded_experts``) after the same init: phase 14 (d)."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    from repro_torch.models.transformer import has_attn, has_mlp, has_ssm
    from repro_torch.runtime import ServeEngine

    cfg = get_config(arch)
    full = cfg.layers
    if layers is not None:
        cfg = cfg.scaled(layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=DEV)
    if padded:
        from repro_torch.models.moe import a2a_padded_experts
        cfg = cfg.scaled(perf_flags=("moe_a2a",))
        for lp in params["layers"]:
            for k in ("wi", "wg", "wo"):
                w = lp["moe"][k]
                pad = w.new_zeros((a2a_padded_experts(cfg) - w.shape[0],)
                                  + tuple(w.shape[1:]))
                lp["moe"][k] = torch.cat([w, pad])
                del w, pad
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"[serve] {cfg.name} expert storage padded with zeros to "
            f"{a2a_padded_experts(cfg)} of {cfg.moe.num_experts} experts "
            f"(perf flag moe_a2a; the dense layer runs the first "
            f"{cfg.moe.num_experts}); the padding's transient peak "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB,"
            f" not counted in the path's peak below")
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name} full width: {cfg.layers} of {full} layers, "
        f"{cfg.block} block, d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; weights "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB made in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV, **serve_kw)
    stats = get_default_cache().stats
    cold0 = stats.cold_builds
    say(f"[serve] warm-up: {len(eng.kernel_plan)} kernel picks frozen and "
        f"{1 + len(eng.prefill_graphs)} steps captured in "
        f"{time.perf_counter() - t0:.1f} s (workspaces, eager runs and "
        f"captures {eng.capture_s:.3f} s); engine {serve_kw}")
    say(f"[serve] {cfg.name} capture s a graph (its eager run and capture): "
        + ", ".join(f"{k} {t:.3f}" for k, t in eng.capture_times.items()))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(*prompt_lens, 4)]

    kernels = _counters(SERVE_KERNELS)
    clock = _TickClock(eng)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    shapes = {n: dict(k.shapes) for n, k in kernels.items()}
    replays = eng.graph.replays
    prefill_replays = {C: g.replays for C, g in eng.prefill_graphs.items()}

    outs = [done[r] for r in rids]
    for r, p in zip(outs, prompts):
        say(f"[serve] request {r.rid}: prompt {len(p)} tokens -> {r.out}")
        if r.error is not None or len(r.out) != MAX_NEW or not all(
                0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.rid} did not return "
                                 f"{MAX_NEW} valid tokens")
    cold = stats.cold_builds - cold0
    st = eng.sched.stats
    ntok = sum(len(r.out) for r in outs)
    attn, ssm, mlp = has_attn(cfg), has_ssm(cfg), has_mlp(cfg)
    moe = cfg.block == "attn_moe"
    # K1: q, k, v, o; the SSM's x, B, C, decay and out; the MLP's wi, wg,
    # wo; the MoE router, and its experts' wi, wg, wo on the batched entry
    per_step_mm = cfg.layers * (4 * attn + 5 * ssm + 3 * mlp + moe) + 1
    per_step_batched = cfg.layers * 3 * moe
    steps = st.prefill_chunks + st.decode_ticks
    say(f"[serve] {cfg.name}: {len(outs)} requests, {ntok} tokens in "
        f"{wall:.3f} s: {ntok / wall:.2f} tokens/s; {st.prefill_chunks} "
        f"prefill chunks, {st.decode_ticks} decode steps, {replays} decode "
        f"graph replays, prefill graph replays by chunk length "
        f"{prefill_replays}, eager prefill bodies {eng.eager_prefills}")
    for line in clock.lines():
        say(f"[serve] {cfg.name} {line}")
    say(f"[serve] {cfg.name} {clock.profile()}")
    say(f"[serve] {cfg.name} launches: {json.dumps(launches)}; matmul per "
        f"prefill chunk or decode step {per_step_mm}, batched matmul "
        f"{per_step_batched}, K2 and K3 one a layer each; cold dispatch "
        f"builds after warm-up: {cold}")
    used = ["matmul_h100"] + ["matmul_h100_batched"] * moe \
        + ["flash_attention_h100"] * attn + ["ssd_scan_h100"] * ssm
    if any(launches[n] == 0 for n in used):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    if replays != st.decode_ticks:
        raise AssertionError(f"{replays} graph replays for {st.decode_ticks}"
                             " decode ticks")
    if sum(prefill_replays.values()) != st.prefill_chunks \
            or eng.eager_prefills:
        raise AssertionError(f"prefill graph replays {prefill_replays} and "
                             f"{eng.eager_prefills} eager prefill bodies for"
                             f" {st.prefill_chunks} chunks")
    if launches["matmul_h100"] != per_step_mm * steps:
        raise AssertionError("matmul launches do not match the steps run")
    if launches["matmul_h100_batched"] != per_step_batched * steps:
        raise AssertionError("batched matmul launches do not match the "
                             "steps run")
    if launches["flash_attention_h100"] != cfg.layers * steps * attn:
        raise AssertionError("attention launches do not match the steps run")
    if launches["ssd_scan_h100"] != cfg.layers * steps * ssm:
        raise AssertionError("SSD scan launches do not match the steps run")
    # the lengths phase 9 times each paged signature at: a decode step's
    # rows halfway through their new tokens, a prefill chunk at the mean
    # prompt length (the served lengths; the device's own are not read)
    for sig in shapes["flash_attention_h100"]:
        rows, sq = sig[1], sig[4]
        PAGED_LENS[sig] = (
            tuple(len(p) + MAX_NEW // 2 for p in prompts)[:rows]
            if sq == 1 and rows == len(prompts)
            else (max(sq, round(np.mean([len(p) for p in prompts]))),))
    if traced:
        phase_trace(eng, prompts, [r.out for r in outs])
    eng.close()

    for depth in depths[1:]:
        again = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                            async_depth=depth, **serve_kw)
        t0 = time.perf_counter()
        rids = [again.submit(p, max_new=MAX_NEW) for p in prompts]
        redo = {r.rid: r.out for r in again.run_until_drained()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = [redo[r] for r in rids]
        say(f"[serve] {cfg.name} at async_depth {depth}: {ntok} tokens in "
            f"{dt:.3f} s: {ntok / dt:.2f} tokens/s; tokens equal to "
            f"async_depth {depths[0]}: {toks == [r.out for r in outs]}")
        if toks != [r.out for r in outs]:
            raise AssertionError(f"{cfg.name}: async_depth {depth} tokens "
                                 "differ")
        again.close()
        del again

    # one full-width forward through the kernels: finite logits of the
    # expected shape
    logits, _ = forward(params, cfg, prompts[0][None, :16])
    torch.cuda.synchronize()
    if logits.shape != (1, 16, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"full-width forward: logits "
                             f"{tuple(logits.shape)} not finite")
    say(f"[serve] {cfg.name} full-width forward: logits "
        f"{tuple(logits.shape)} finite")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    say(f"[serve] {cfg.name} peak device memory of the path (weights, pool, "
        f"workspaces, graphs, forward): {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    # the engine and its tick clock refer to each other: collect the cycle
    # so the next path gets this one's memory
    del eng, clock, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": cfg.name + (" (padded storage)" if padded else ""),
            "wall_ms": 1e3 * wall, "launches": launches,
            "shapes": shapes, "peak_gib": peak,
            "tokens": [r.out for r in outs]}


def phase_shapes(shapes, gen, timed=None, before="phase 3"):
    """Every launch signature of the main paths, checked and timed once (a
    signature in ``timed`` {name: {sig: row}} was, in an earlier phase,
    ``before``, and keeps its row); returns {name: {sig: row}}."""
    rows = {}
    for name, by_sig in shapes.items():
        rows[name] = {}
        for sig, n in sorted(by_sig.items(), key=lambda kv: str(kv[0])):
            row = (timed or {}).get(name, {}).get(sig)
            again = row is not None
            if row is None:
                row = CASES[name](sig, gen, timed=True)
            rows[name][sig] = row
            say(f"[shapes] {name} {sig[:-1]} x{n}"
                f"{f' (timed in {before})' if again else ''}: {fmt(row)}")
            torch.cuda.empty_cache()
    return rows


def phase_host_cost(gen) -> None:
    """Host clock over 1000 launches at M = 1, N = 32, K = 32 with no
    synchronise inside the loop: what a launch costs the host through the
    wrapper, through ``ops.matmul`` (dispatch and wrapper) and, beside
    them, ``torch.matmul``; then two parts of the wrapper alone, the C
    entry point (checks and the launch) and the output's ``torch.empty``."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    a = torch.randn((1, 32), generator=gen, device=DEV).bfloat16()
    b = torch.randn((32, 32), generator=gen, device=DEV).bfloat16()
    cand = ops.select("matmul_h100", {"M": 1, "N": 32, "K": 32})
    fn = ops.FAMILIES["matmul_h100"].instantiate(cand.plan, cand.assignment,
                                                 "cuda")
    c = torch.empty((1, 32), device=DEV)
    kw = fn.keywords
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), None, None, 1, 32, 32,
            kw["bm"], kw["bn"], kw["bk"], kw["s"], 1, kw["stages"],
            int(kw["cached"]), 1, torch.cuda.current_stream().cuda_stream)
    for label, call in (("wrapper", lambda: fn(a, b)),
                        ("ops.matmul", lambda: ops.matmul(a, b)),
                        ("torch.matmul", lambda: torch.matmul(a, b)),
                        ("of which the C entry alone",
                         lambda: mm._entry()(*args)),
                        ("of which torch.empty", lambda: torch.empty(
                            (1, 32), dtype=torch.float32, device=DEV))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        host = (time.perf_counter() - t0) / 1000
        torch.cuda.synchronize()
        say(f"[shapes] K1 host cost a launch, {label}, M1 N32 K32 (leaf "
            f"{dict(cand.assignment)}): {1e3 * host:.4f} ms")

    # K3 at mamba2-130m's decode signature (4, 1, 24, 64, 128), as the
    # decode step calls it: in place, with a device mask of the rows
    from repro_torch.kernels import ssd_scan as ssd
    R, S, H, hd, N = 4, 1, 24, 64, 128
    x = torch.randn((R, S, H, hd), generator=gen, device=DEV).bfloat16()
    av = torch.full((R, S, H), 0.5, device=DEV)
    bc = torch.randn((R, S, N), generator=gen, device=DEV).bfloat16()
    st = torch.randn((R, H, N, hd), generator=gen, device=DEV)
    mask = torch.ones((R,), dtype=torch.bool, device=DEV)
    cand = ops.select("ssd_scan_h100", {"SQ": S, "HD": hd, "STATE": N})
    fn = ops.FAMILIES["ssd_scan_h100"].instantiate(cand.plan,
                                                   cand.assignment, "cuda")
    y = torch.empty_like(x)
    bx = bc[:, :, None, :].expand(R, S, H, N)
    args = (x.data_ptr(), av.data_ptr(), bc.data_ptr(), bc.data_ptr(),
            st.data_ptr(), y.data_ptr(), st.data_ptr(), mask.data_ptr(),
            None, R, 0, S, H, hd, N, 1, fn.keywords["bd"], *bx.stride()[:3],
            *bx.stride()[:3], 1, torch.cuda.current_stream().cuda_stream)
    for label, call in (("wrapper",
                         lambda: fn(x, av, bc, bc, st, out_state=st,
                                    mask=mask)),
                        ("ops.ssd_scan",
                         lambda: ops.ssd_scan(x, av, bc, bc, st,
                                              out_state=st, mask=mask)),
                        ("of which the C entry alone",
                         lambda: ssd._entry()(*args))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        host = (time.perf_counter() - t0) / 1000
        torch.cuda.synchronize()
        say(f"[shapes] K3 host cost a launch, {label}, rows {R} seq {S} "
            f"heads {H} hd {hd} state {N}, in place, masked (leaf "
            f"{dict(cand.assignment)}): {1e3 * host:.4f} ms")


def launch_sums(shapes, rows) -> dict:
    """{name: {key: sum over the launches in ``shapes`` of the key's time
    at each launch's signature}} (None where a signature has none)."""
    out = {}
    for name, by_sig in shapes.items():
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "library_device_ms": 0.0,
               "bound_ms": 0.0, "bound_f32_ms": 0.0}
        for sig, n in by_sig.items():
            for key in tot:
                val = rows[name][sig].get(key)
                tot[key] = (None if tot[key] is None or val is None
                            else tot[key] + n * val)
        out[name] = tot
    return out


def _sums_line(sums) -> str:
    return "; ".join(f"{name} " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items() if v is not None)
        for name, tot in sums.items() if tot["ms"])


# ---------------------------------------------------------------------------
# Phase 10: the engine options on the card
# ---------------------------------------------------------------------------

#: Phase 8's llama3-8b engine settings, which phase 10 serves at, and the
#: three of them a serve plan is traced for.
LLAMA_KW = dict(PATHS[2][1])
LLAMA_SIZES = {k: LLAMA_KW[k] for k in ("max_len", "max_batch",
                                        "prefill_chunk")}
#: Phase 7's smoke engine settings and prompt lengths, for the drill.
DRILL_KW = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8)
DRILL_LENS = (5, 19, 11, 3, 26)


def _fresh_cache(root=None):
    """A new process-wide dispatch cache (on the tables under ``root``)."""
    from repro_torch.artifacts import ArtifactStore, DispatchCache
    from repro_torch.artifacts.dispatch import set_default_cache
    cache = DispatchCache(store=ArtifactStore(root) if root else None)
    set_default_cache(cache)
    return cache


def _serve_timed(eng, prompts, staged: bool = False) -> tuple:
    """Serve ``prompts`` on ``eng`` (``staged``: the first to completion,
    then the rest); (wall s, outputs in submit order)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, outs = [], {}
    batches = [prompts[:1], prompts[1:]] if staged else [prompts]
    for batch in batches:
        rids += [eng.submit(p, max_new=MAX_NEW) for p in batch]
        for r in eng.run_until_drained():
            if r.error is not None:
                raise AssertionError(f"request {r.rid}: {r.error}")
            outs[r.rid] = r.out
    torch.cuda.synchronize()
    return time.perf_counter() - t0, [outs[r] for r in rids]


def _agree(a, b) -> str:
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    return f"{same} of {sum(len(p) for p in a)} tokens agree"


def _shared_prompts(vocab: int) -> list:
    """Eight prompts: a 48-token prefix (three full 16-token blocks) and
    8-24 tokens of their own; the leader's own 16 fill block 3, and two
    followers take its first 8 of them before they diverge, mid-block, so
    they map block 3 and copy it on write."""
    rng = np.random.default_rng(10)
    prefix = rng.integers(0, vocab, 48)
    lead_tail = rng.integers(0, vocab, 16)
    prompts = [np.concatenate([prefix, lead_tail])]
    for i in range(7):
        own = rng.integers(0, vocab, int(rng.integers(8, 25)))
        head = lead_tail[:8] if i < 2 else own[:0]
        prompts.append(np.concatenate([prefix, head, own]))
    return prompts


def _check_pool(eng) -> None:
    eng.pool.check_invariants([s.blocks for s in eng.sched.running()])


def phase_options() -> None:
    """The engine options of this slice on the card: (a) prefix sharing at
    full width, (b) a plan-backed start, (c) the degrade drill."""
    import tempfile
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.core import select as tselect
    from repro_torch.launch import compile_artifacts, plan_artifacts
    from repro_torch.models import init_model
    from repro_torch.plans import PlanStore, StalePlanError, StalePlanWarning
    from repro_torch.runtime import ServeEngine
    from repro_torch.runtime.serving import warm_kernel_dispatch

    cfg = get_config("llama3_8b")
    params = init_model(cfg, seed=0, device=DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(*PATHS[2][2], 4)]
    kernels = _counters(("matmul_h100", "flash_attention_h100"))
    with tempfile.TemporaryDirectory() as root:
        # (b) the disk tier and a serve plan, built by the two CLIs
        t0 = time.perf_counter()
        if compile_artifacts.main(["--machine", "h100_sxm", "--out", root,
                                   "--quick"]) != 0:
            raise AssertionError("compile_artifacts failed")
        t_tables = time.perf_counter() - t0
        t0 = time.perf_counter()
        if plan_artifacts.main([
                "--config", "llama3_8b", "--out", root,
                "--max-len", str(LLAMA_KW["max_len"]),
                "--max-batch", str(LLAMA_KW["max_batch"]),
                "--prefill-chunk", str(LLAMA_KW["prefill_chunk"])]) != 0:
            raise AssertionError("plan_artifacts failed")
        say(f"[options] (b) tables for h100_sxm (--quick) in {t_tables:.3f}"
            f" s, llama3-8b serve plan in {time.perf_counter() - t0:.3f} s")
        starts = {}
        engines = {}
        for how in ("online", "plan"):
            cache = _fresh_cache(root)
            calls = tselect.STATS.enumerate_calls
            t0 = time.perf_counter()
            eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                              plan_store=(PlanStore(root) if how == "plan"
                                          else False), **LLAMA_KW)
            total = time.perf_counter() - t0
            starts[how] = (total - eng.capture_s, eng.capture_s,
                           cache.stats.cold_builds,
                           tselect.STATS.enumerate_calls - calls)
            engines[how] = (eng, cache)
            say(f"[options] (b) {how} start: warm {starts[how][0]:.3f} s, "
                f"capture {eng.capture_s:.3f} s ({len(eng.capture_times)} "
                f"graphs); cold builds {starts[how][2]}, online "
                f"enumerations {starts[how][3]}; sources "
                f"{sorted({p['rank_source'] for p in eng.kernel_plan.values()})}")
        online, plan = engines["online"][0], engines["plan"][0]
        if starts["plan"][2:] != (0, 0):
            raise AssertionError(f"plan-backed start resolved: {starts}")
        diff = [k for k, p in plan.kernel_plan.items()
                if p["candidate"] != online.kernel_plan[k]["candidate"]]
        if diff or plan.kernel_plan.keys() != online.kernel_plan.keys():
            raise AssertionError(f"plan picks differ from online: {diff}")
        w_on, t_on = _serve_timed(online, prompts)
        w_plan, t_plan = _serve_timed(plan, prompts)
        say(f"[options] (b) {len(plan.kernel_plan)} picks equal; tokens "
            f"bit for bit: {t_plan == t_on} ({_agree(t_on, t_plan)}); "
            f"walls online {w_on:.3f} s, plan-backed {w_plan:.3f} s; cold "
            f"builds while serving {engines['plan'][1].stats.cold_builds}")
        if t_plan != t_on or engines["plan"][1].stats.cold_builds:
            raise AssertionError("plan-backed tokens differ, or it "
                                 "resolved cold while serving")
        # a rewritten table: the start warns and warms online; strict
        # refuses
        from repro_torch.artifacts import ArtifactStore
        store = ArtifactStore(root)
        table = store.load_dispatch("matmul_h100", "h100_sxm")
        bucket = next(iter(table["buckets"]))
        table["buckets"][bucket][0]["score"] += 1.0
        store.save_dispatch(table)
        _fresh_cache(root)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            picks = warm_kernel_dispatch(cfg, plan_store=PlanStore(root),
                                         **LLAMA_SIZES)
        stale = [w for w in caught
                 if issubclass(w.category, StalePlanWarning)]
        _fresh_cache(root)
        try:
            warm_kernel_dispatch(cfg, plan_store=PlanStore(root),
                                 strict_plans=True, **LLAMA_SIZES)
            refused = False
        except StalePlanError:
            refused = True
        say(f"[options] (b) stale table: {len(stale)} StalePlanWarning, "
            f"{len(picks)} picks warmed online "
            f"({sorted({p['rank_source'] for p in picks.values()})}); "
            f"strict_plans raised StalePlanError: {refused}")
        if len(stale) != 1 or not picks or not refused:
            raise AssertionError("the stale plan was not refused")
        online.close()

        # (a) prefix sharing at full width, on and off, the same weights
        shared = _shared_prompts(cfg.vocab)
        runs = {}
        for share in (False, True):
            _fresh_cache(root)
            eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                              prefix_sharing=share, plan_store=False,
                              **LLAMA_KW)
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            wall, toks = _serve_timed(eng, shared, staged=True)
            launches = {n: k.launches for n, k in kernels.items()}
            _check_pool(eng)
            runs[share] = (eng, wall, toks, launches)
        for share, (eng, wall, toks, launches) in runs.items():
            st, ps = eng.sched.stats, eng.pool.stats
            replays = sum(g.replays for g in eng.prefill_graphs.values())
            steps = st.prefill_chunks + st.decode_ticks
            say(f"[options] (a) llama3-8b sharing "
                f"{'on ' if share else 'off'}: {len(toks)} requests, wall "
                f"{wall:.3f} s; prefill chunks {st.prefill_chunks} (graph "
                f"replays {replays}), prefill tokens {st.prefill_tokens} of "
                f"{sum(map(len, shared))}, decode steps {st.decode_ticks}; "
                f"prefix_hits {ps.prefix_hits}, prefix_tokens_saved "
                f"{ps.prefix_tokens_saved}, cow_copies {ps.cow_copies}; "
                f"launches {json.dumps(launches)}")
            if any(len(t) != MAX_NEW for t in toks):
                raise AssertionError("a shared-prefix request came back "
                                     "short")
            if st.prefill_tokens != sum(map(len, shared)) \
                    - ps.prefix_tokens_saved:
                raise AssertionError("prefill tokens computed != prompt "
                                     "tokens - tokens saved")
            if replays != st.prefill_chunks or eng.eager_prefills:
                raise AssertionError("a prefill chunk did not replay once")
            if launches["matmul_h100"] != (cfg.layers * 7 + 1) * steps or \
                    launches["flash_attention_h100"] != cfg.layers * steps:
                raise AssertionError(f"launches {launches} do not match "
                                     f"{steps} steps")
        on, off = runs[True], runs[False]
        ps = on[0].pool.stats
        if not (on[0].sched.stats.prefill_chunks
                < off[0].sched.stats.prefill_chunks
                and ps.cow_copies > 0 and ps.prefix_hits > 0):
            raise AssertionError("sharing saved no chunk or copied nothing")
        say(f"[options] (a) sharing saved "
            f"{off[0].sched.stats.prefill_chunks - on[0].sched.stats.prefill_chunks}"
            f" prefill chunks and {off[1] - on[1]:.3f} s of wall; bf16 "
            f"tokens on against off: {_agree(off[2], on[2])} (not held: a "
            f"tail chunk has another M, so K1 may pick another split)")
        for eng, *_ in runs.values():
            eng.close()

        # (c) full width: one K1 triple demoted mid-run, the graphs that
        # launch it captured again (the model dispatches through the
        # process-wide cache: the engine's own again)
        from repro_torch.artifacts.dispatch import set_default_cache
        from repro_torch.runtime import faults
        from repro_torch.runtime.faults import FaultSpec
        eng, cache = engines["plan"]
        set_default_cache(cache)
        eng.degrade = True
        with faults.inject([FaultSpec("serve.decode",
                                      eng.sched.ticks + 6, "error")]) as inj:
            wall, toks = _serve_timed(eng, prompts)
        (ev,) = eng.degrade_events
        (rec,) = eng.recapture_log
        say(f"[options] (c) llama3-8b bf16 full width: {len(inj.fired)} "
            f"fault, {ev.describe()}; recaptured "
            f"{', '.join(f'{k} {s:.3f} s' for k, s in rec.seconds.items())}"
            f" (grew workspaces: {rec.grew}; all 7 graphs took "
            f"{eng.capture_s:.3f} s at start); wall {wall:.3f} s; tokens "
            f"against the run before: {_agree(t_plan, toks)}")
        if ev.family != "matmul_h100" or not rec.seconds or any(
                len(t) != MAX_NEW for t in toks):
            raise AssertionError("the full-width demotion did not recapture "
                                 "a K1 step or a request came back short")
        eng.close()
    del params, engines, online, plan, eng, runs, on, off
    torch.cuda.empty_cache()
    _fresh_cache()
    phase_drill()


def _drill_engine(cfg, params, depth, **kw):
    from repro_torch.runtime import ServeEngine
    _fresh_cache()
    return ServeEngine(cfg, params, device=DEV, warm_kernels=True,
                       degrade=True, async_depth=depth, **DRILL_KW, **kw)


def _drill_serve(eng, prompts, schedule=()):
    """Serve under ``schedule`` with the pool's invariants proved every
    tick; a recapture's live state (KV pool, SSM state, ``last_tok``) is
    held bit for bit.  Returns the outputs in submit order."""
    from repro_torch.runtime import faults
    real = eng._recapture

    def held(triple):
        torch.cuda.synchronize()
        before = ({k: v.clone() for k, v in eng.cache.items()},
                  eng.last_tok.clone())
        steps = {k: s.triples for k, s in eng._graphs.steps.items()}
        rec = real(triple)
        for k, v in before[0].items():
            if not torch.equal(eng.cache[k], v):
                raise AssertionError(f"a recapture moved the live {k}")
        if not torch.equal(eng.last_tok, before[1]):
            raise AssertionError("a recapture moved last_tok")
        want = list(steps) if rec.grew else [
            k for k, t in steps.items() if triple in t]
        if list(rec.seconds) != want:
            raise AssertionError(f"recaptured {list(rec.seconds)}, the "
                                 f"steps that launch it are {want}")
        return rec
    eng._recapture = held
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    outs = {}
    with faults.inject(list(schedule)) as inj:
        for _ in range(500):
            for r in eng.step():
                outs[r.rid] = r.out
            _check_pool(eng)
            if not eng.sched.has_work():
                break
    for r in eng.run_until_drained():
        outs[r.rid] = r.out
    return [outs[r] for r in rids], inj


def phase_drill() -> None:
    """(c) The degrade drill on the f32 smoke configs of phase 7, at
    ``async_depth`` 1 and 2: schedule A (a prefill error at tick 1, a
    decode error at tick 6) demotes and recaptures, schedule B (two decode
    errors at one tick) poisons and recomputes, both with the fault-free
    tokens; schedule C (a fatal fault) propagates and the engine drains."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.runtime.faults import ANY_TICK, FatalFault, FaultSpec
    sched_a = [FaultSpec("serve.prefill", 1, "error"),
               FaultSpec("serve.decode", 6, "error")]
    sched_b = [FaultSpec("serve.decode", 6, "error")] * 2
    for arch, _, _ in PATHS:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        params = init_model(cfg, seed=7, device=DEV)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab, n) for n in DRILL_LENS]
        for depth in (1, 2):
            eng = _drill_engine(cfg, params, depth)
            ref, _ = _drill_serve(eng, prompts)
            eng.close()
            eng = _drill_engine(cfg, params, depth)
            got_a, inj = _drill_serve(eng, prompts, sched_a)
            recs = "; ".join(
                f"tick {r.tick} {r.triple[0]}{dict(r.triple[2])}: "
                + ", ".join(f"{k} {s * 1e3:.1f} ms"
                            for k, s in r.seconds.items())
                for r in eng.recapture_log)
            say(f"[drill] {cfg.name} f32 async_depth {depth} A: "
                f"{len(inj.fired)} faults, {len(eng.degrade_events)} "
                f"demotions, recaptured {recs}; tokens equal to the "
                f"fault-free run: {got_a == ref}")
            if got_a != ref or not eng.degrade_events or not \
                    eng.recapture_log:
                raise AssertionError(f"{cfg.name} schedule A")
            eng.close()
            eng = _drill_engine(cfg, params, depth)
            got_b, inj = _drill_serve(eng, prompts, sched_b)
            say(f"[drill] {cfg.name} f32 async_depth {depth} B: "
                f"{len(inj.fired)} faults, poisoned "
                f"{eng.sched.stats.poisoned}, {len(eng.degrade_events)} "
                f"demotions, {eng.recaptures} steps recaptured; tokens "
                f"equal to the fault-free run: {got_b == ref}")
            if got_b != ref or len(inj.fired) != 2 or \
                    not eng.sched.stats.poisoned:
                raise AssertionError(f"{cfg.name} schedule B")
            eng.close()
            eng = _drill_engine(cfg, params, depth)
            try:
                _drill_serve(eng, prompts,
                             [FaultSpec("serve.decode", ANY_TICK, "fatal")])
                raise AssertionError(f"{cfg.name}: the fatal fault did "
                                     "not propagate")
            except FatalFault:
                pass
            done = eng.run_until_drained()
            say(f"[drill] {cfg.name} f32 async_depth {depth} C: FatalFault "
                f"propagated; drained {len(done)} requests, "
                f"{sum(len(r.out) for r in done)} tokens")
            if len(done) != len(prompts) or any(len(r.out) != MAX_NEW
                                                for r in done):
                raise AssertionError(f"{cfg.name} schedule C: not drained")
            eng.close()
    _fresh_cache()


# ---------------------------------------------------------------------------
# Phase 11: tuning and the kernel monitor on the card
# ---------------------------------------------------------------------------

#: The families phase 11 tunes at the serve signatures (K4-K6 at their
#: case-study sizes).
TUNED = ("matmul_h100", "flash_attention_h100", "ssd_scan_h100")
#: (a)'s measurement: every candidate of a bucket (the tables keep 8), no
#: dim clamped, three timed replays of ten launches after one untimed.
TUNE_CFG = dict(iters=3, warmup=1, trim=1, max_dim=1 << 30, top_k=8,
                device="cuda")


def _data_of(name: str, sig) -> dict:
    """The dispatch key of a launch signature (the batched entry's is its
    per-expert product's)."""
    if name == "matmul_h100":
        return dict(zip("MNK", sig[:3]))
    if name == "matmul_h100_batched":
        return dict(zip("MNK", sig[1:4]))
    if name == "ssd_scan_h100":
        return {"SQ": sig[1], "HD": sig[3], "STATE": sig[4]}
    h, hk, sq, _, d = sig[2:7] if sig[0] == "paged" else sig[:5]
    return {"SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk}


def _with_pick(name: str, sig, cand) -> tuple:
    """``sig`` launched through candidate ``cand`` instead of its pick."""
    if name == "matmul_h100":
        return _mm_sig(_data_of(name, sig), cand, sig[-1])
    if name == "matmul_h100_batched":
        return sig[:1] + _mm_sig(_data_of(name, sig), cand, sig[-1])
    a = cand.assignment
    if name == "ssd_scan_h100":
        return sig[:5] + (a["chunk"], a["bd"]) + sig[7:]
    i = 8 if sig[0] == "paged" else 5
    return sig[:i] + tuple(a[n] for n in FA_PARAMS) + sig[i + 4:]


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _llama_prompts(vocab: int) -> list:
    """Phase 8's llama3-8b prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n))
            for n in rng.integers(*PATHS[2][2], 4)]


def _first_diff(a, b) -> str:
    for r, (p, q) in enumerate(zip(a, b)):
        for i, (x, y) in enumerate(zip(p, q)):
            if x != y:
                return f"first difference at request {r}, token {i}"
    return "no difference"


def tune_tables(root: str, shapes) -> None:
    """(a) The port's tables for ``h100_sxm`` over every K1, K2 and K3
    signature phase 8 launched and every triple the nine paths' engines
    resolve (their warm sets), K4-K6 at the case-study sizes; then measure
    -> calibrate -> compact with the CUDA timer, each table rewritten."""
    from repro_torch.artifacts import ArtifactStore, compile_family, serde
    from repro_torch.configs import get_config
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels.ops import FAMILIES
    from repro_torch.plans.trace import trace_warm_set
    from repro_torch.tuning import (MeasureConfig, calibrate_table,
                                    compact_table, measure_table)
    from repro_torch.tuning.compact import compaction_summary
    from repro_torch.tuning.measure import DeviceTimer
    keys = {n: {} for n in TUNED + CASE_KERNELS}
    for name, by_sig in shapes.items():
        fam = "matmul_h100" if name == "matmul_h100_batched" else name
        for sig in by_sig:
            d = _data_of(name, sig)
            keys[fam][tuple(sorted(d.items()))] = d
    launched = {n: len(k) for n, k in keys.items()}
    for arch, kw in [(a, k) for a, k, _ in PATHS] + [
            (a, NEW_KW) for a, _ in NEW_PATHS]:
        for op in trace_warm_set(get_config(arch), max_len=kw["max_len"],
                                 max_batch=kw["max_batch"],
                                 prefill_chunk=kw["prefill_chunk"]):
            keys[op.family][op.data] = op.data_dict()
    for name, data in CASE_PATH:
        keys[name][tuple(sorted(data.items()))] = dict(data)
    store = ArtifactStore(root)
    cfg = MeasureConfig(**TUNE_CFG)
    timer = DeviceTimer()
    for name, by_key in keys.items():
        fam = FAMILIES[name]
        t0 = time.perf_counter()
        compile_family(fam, store, machines=[H100_SXM],
                       shapes=list(by_key.values()))
        table = store.load_dispatch(name, H100_SXM.name)
        t1 = time.perf_counter()
        samples = measure_table(fam, table, cfg, timer=timer)
        timer.clear()
        t2 = time.perf_counter()
        tuned = compact_table(calibrate_table(
            fam, table, samples,
            meta={**TUNE_CFG, "card": torch.cuda.get_device_name(0)}),
            samples)
        store.save_dispatch(tuned)
        buckets = table["buckets"]
        ranks = tuned["measured_ranks"]
        failed = [s for s in samples if s.us is None]
        moved = sum(r["order"][0] != 0 for r in ranks.values())
        last = sum(len(buckets[b]) > 1
                   and r["order"][0] == len(buckets[b]) - 1
                   for b, r in ranks.items())
        cal = tuned.get("calibration")
        fit = ("no fit" if cal is None else
               f"fit n {cal['n_samples']}, rms_log_residual "
               f"{cal['rms_log_residual']:.4f}, top1_agreement "
               f"{cal['top1_agreement']}")
        say(f"[tune] (a) {name}: {len(by_key)} signatures "
            f"({launched[name]} of them launched in phase 8), "
            f"{len(buckets)} buckets; "
            f"{len(samples) - len(failed)} samples timed, {len(failed)} "
            f"failed; {fit}; compaction {compaction_summary(tuned)}; the "
            f"measured first pick differs from the symbolic one in {moved} "
            f"of {len(ranks)} buckets and is the table's last entry in "
            f"{last}; compile {t1 - t0:.1f} s, measure {t2 - t1:.1f} s")
        if failed:
            # every entry of a table is feasible at its bucket's shape, so a
            # failed sample is a fault: print the first one's error
            s = failed[0]
            leaf = serde.table_leaves(table)[s.leaf_index]
            try:
                timer(fam, leaf.plan, s.assignment, s.data, cfg)
                why = "it ran when tried again"
            except Exception as e:     # noqa: BLE001 — printed, then raised
                why = repr(e)[:400]
            timer.clear()
            raise AssertionError(
                f"{name}: {len(failed)} samples failed, first {s.bucket} "
                f"{s.assignment}: {why}")
    _free()


def measured_picks(root: str, shapes, rows, gen) -> None:
    """(b) At every phase-8 K1, K1b, K2 and K3 signature whose pick the
    tuned tables change, the measured pick held against its plain version
    and timed as phase 9 times a pick (the kernel alone); sums over phase
    8's launches beside the symbolic picks' (phase 9's rows) and the
    library's, K1's and K1b's also by the symbolic pick's kb."""
    from repro_torch.artifacts import ArtifactStore, DispatchCache
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels.ops import FAMILIES
    cache = DispatchCache(store=ArtifactStore(root))
    keys = ("ms", "device_ms", "library_ms", "library_device_ms")
    for name in SERVE_KERNELS:
        fam = FAMILIES["matmul_h100" if name == "matmul_h100_batched"
                       else name]
        sym = {k: 0.0 for k in keys}
        mea = {"ms": 0.0, "device_ms": 0.0}
        by_kb = {}
        changed = changed_launches = 0
        err = 0.0
        timed = {}
        for sig, n in shapes[name].items():
            new = _with_pick(name, sig,
                             cache.best_variant(fam, H100_SXM,
                                                _data_of(name, sig)))
            old = rows[name][sig]
            row = old
            if new != sig:
                changed += 1
                changed_launches += n
                if new not in timed:
                    if name == "flash_attention_h100" and sig[0] == "paged":
                        PAGED_LENS[new] = PAGED_LENS[sig]
                    timed[new] = CASES[name](new, gen, timed=True,
                                             leaf_only=True)
                    err = max(err, timed[new]["err"])
                    torch.cuda.empty_cache()
                row = timed[new]
            for k in keys:
                sym[k] = (None if sym[k] is None or old.get(k) is None
                          else sym[k] + n * old[k])
            for k in mea:
                mea[k] += n * row[k]
            if name in ("matmul_h100", "matmul_h100_batched"):
                kb = sig[8 if name == "matmul_h100_batched" else 7]
                t = by_kb.setdefault(kb, [0, 0.0, 0.0, 0.0])
                t[0] += n
                t[1] += n * old["device_ms"]
                t[2] += n * row["device_ms"]
                t[3] += n * (old.get("library_device_ms") or 0.0)
        lib = ", ".join(f"{k} {sym[k]:.3f}" for k in keys[2:]
                        if sym[k] is not None)
        say(f"[tune] (b) {name}: {len(shapes[name])} signatures, the "
            f"measured pick differs at {changed} ({changed_launches} of "
            f"{sum(shapes[name].values())} launches; largest error against "
            f"the plain version {err:.3e}); ms over phase 8's launches: "
            f"symbolic picks {sym['ms']:.3f}, measured picks "
            f"{mea['ms']:.3f}; device_ms: symbolic {sym['device_ms']:.3f}, "
            f"measured {mea['device_ms']:.3f}; library {lib or 'none'}")
        for kb in sorted(by_kb):
            c, s_dev, m_dev, l_dev = by_kb[kb]
            say(f"[tune] (b) {name} launches whose symbolic pick has kb "
                f"{kb}: {c}, device_ms symbolic {s_dev:.3f}, measured "
                f"{m_dev:.3f}, library {l_dev:.3f} (gap symbolic "
                f"{s_dev - l_dev:.3f}, measured {m_dev - l_dev:.3f})")
    _free()


def serve_tuned(root: str, cfg, params, want) -> None:
    """(b) llama3-8b at phase 8's settings from the tuned tables: every warm
    triple's rank_source is ``measured``, no cold build; bf16 tokens
    against phase 8's."""
    from repro_torch.runtime import ServeEngine
    cache = _fresh_cache(root)
    eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                      plan_store=False, **LLAMA_KW)
    sources = sorted({p["rank_source"] for p in eng.kernel_plan.values()})
    cold = cache.stats.cold_builds
    wall, toks = _serve_timed(eng, _llama_prompts(cfg.vocab))
    say(f"[tune] (b) llama3-8b bf16 from the tuned tables: "
        f"{len(eng.kernel_plan)} warm picks, rank sources {sources}, cold "
        f"builds {cold} at warm-up and {cache.stats.cold_builds - cold} "
        f"while serving, measured hits {cache.stats.measured_hits}; wall "
        f"{wall:.3f} s; tokens against phase 8: {_agree(want, toks)} "
        f"({_first_diff(want, toks)})")
    if sources != ["measured"] or cache.stats.cold_builds:
        raise AssertionError("a warm pick did not come from a measured "
                             "order, or a dispatch resolved cold")
    eng.close()
    _fresh_cache()


class _StepTimes:
    """Host and device time of each of an engine's steps (the host clock
    around ``step()``, which at async_depth 1 returns after the tick's
    commit, and CUDA events around it), and each probe's host time and
    whether it was its triple's first (its challenger pool is built then:
    a host enumeration)."""

    def __init__(self, eng):
        self.ticks, self.probes = [], []
        step, mon = eng.step, eng.monitor
        self._probed = False
        if mon is not None:
            probe = mon._probe

            def timed_probe(st, tick):
                first = st.pool is None
                t0 = time.perf_counter()
                probe(st, tick)
                self.probes.append((st.family.name, first,
                                    time.perf_counter() - t0))
                self._probed = True
            mon._probe = timed_probe

        def timed_step():
            self._probed = False
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = step()
            end.record()
            self.ticks.append((self._probed, time.perf_counter() - t0,
                               start, end))
            return out
        eng.step = timed_step

    def line(self, probed: bool) -> str:
        torch.cuda.synchronize()
        got = [(h, s.elapsed_time(e)) for p, h, s, e in self.ticks
               if p == probed]
        if not got:
            return "none"
        host = sorted(1e3 * h for h, _ in got)
        dev = sorted(d for _, d in got)
        return (f"{len(got)} ticks, host {host[len(host) // 2]:.3f} ms "
                f"median ({host[0]:.3f}-{host[-1]:.3f}), device span "
                f"{dev[len(dev) // 2]:.3f} ms median ({dev[0]:.3f}-"
                f"{dev[-1]:.3f})")


def monitor_defaults(cfg, params) -> list:
    """(c) llama3-8b at phase 8's settings and picks, served without and
    with the monitor at its defaults (the CUDA timer), at async_depth 1 and
    2 (where a probe, which waits for its own timing, drains the tick in
    flight); returns the unmonitored tokens at depth 1."""
    from repro_torch.runtime import ServeEngine
    prompts = _llama_prompts(cfg.vocab)
    first = None
    for depth in (1, 2):
        runs = {}
        for monitored in (False, True):
            _fresh_cache()
            eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                              plan_store=False, monitor=monitored,
                              async_depth=depth, **LLAMA_KW)
            clock = _StepTimes(eng)
            wall, toks = _serve_timed(eng, prompts)
            runs[monitored] = (eng, clock, wall, toks)
        plain, pclock, pwall, ptoks = runs[False]
        eng, clock, wall, toks = runs[True]
        first = ptoks if first is None else first
        mon = eng.monitor
        say(f"[tune] (c) llama3-8b bf16 async_depth {depth}, monitor at its "
            f"defaults (window {mon.window}, every {mon.probe_every} ticks, "
            f"threshold {mon.threshold}, patience {mon.patience}, max_dim "
            f"{mon.measure.max_dim}, {len(mon._triples)} triples tracked): "
            f"{mon.stats_line()}; probe failures "
            f"{mon.stats.probe_failures}; swaps: "
            f"{[e.describe() for e in mon.events] or 'none'}; recaptures "
            f"{eng.recaptures}")
        say(f"[tune] (c) async_depth {depth}: unmonitored ticks: "
            f"{pclock.line(False)}; monitored ticks without a probe: "
            f"{clock.line(False)}; probe ticks: {clock.line(True)}")
        firsts = sorted(1e3 * t for _, f, t in clock.probes if f)
        again = sorted(1e3 * t for _, f, t in clock.probes if not f)
        say(f"[tune] (c) async_depth {depth}: probes' host ms: first probe "
            f"of a triple {[round(t, 3) for t in firsts]}, repeated "
            f"{[round(t, 3) for t in again]}; families probed "
            f"{sorted({n for n, _, _ in clock.probes})}")
        say(f"[tune] (c) async_depth {depth}: walls: unmonitored "
            f"{pwall:.3f} s, monitored {wall:.3f} s; tokens equal: "
            f"{toks == ptoks} ({_agree(ptoks, toks)}); unmonitored against "
            f"async_depth 1: {_agree(first, ptoks)}")
        if mon.stats.probes == 0 or mon.stats.probe_failures:
            raise AssertionError("the monitor probed nothing, or a probe "
                                 "failed on the card")
        plain.close()
        eng.close()
        del runs, plain, eng, clock, pclock
        _free()
    _fresh_cache()
    return first


class _SlowPick:
    """(d)'s deterministic timer: the assignments in ``slow`` measure 8 ms,
    every other candidate 4 ms (no kernel runs)."""

    def __init__(self):
        self.slow = set()

    def __call__(self, family, plan, assignment, data, cfg):
        key = tuple(sorted((k, int(v)) for k, v in assignment.items()))
        return [8e-3 if key in self.slow else 4e-3] * max(1, cfg.iters)


def forced_swap(cfg, params, prompts, kw, label) -> tuple:
    """(d) One K1 triple's frozen incumbent skewed slow (window 2, patience
    2, a probe every tick): the swap fires at tick 3 and the engine
    captures again exactly the steps that launch the triple (every step if
    a workspace grew).  Returns (unmonitored tokens, monitored tokens)."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels.ops import FAMILIES
    from repro_torch.runtime import KernelMonitor, ServeEngine, cand_key
    _fresh_cache()
    ref = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                      plan_store=False, **kw)
    _, want = _serve_timed(ref, prompts)
    ref.close()
    cache = _fresh_cache()
    timer = _SlowPick()
    eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                      plan_store=False, monitor=True, monitor_timer=timer,
                      **kw)
    op = next(o for o in eng._warm_ops if o.family == "matmul_h100")
    mon = KernelMonitor(cache, machine=H100_SXM, window=2, patience=2,
                        probe_every=1, top_k=2, timer=timer)
    mon.track(FAMILIES["matmul_h100"], op.data_dict())
    inc = cache.frozen_entry("matmul_h100", H100_SXM.name, op.data_dict())
    timer.slow.add(cand_key(inc.candidate)[1])
    eng.monitor = mon
    holding = {k: s.triples for k, s in eng._graphs.steps.items()}
    wall, got = _serve_timed(eng, prompts)
    triple = ("matmul_h100", H100_SXM.name, op.data)
    (ev,) = mon.events
    (rec,) = eng.recapture_log
    want_keys = (list(holding) if rec.grew else
                 [k for k, t in holding.items() if triple in t])
    say(f"[tune] (d) {label}: {ev.describe()}; recaptured "
        f"{', '.join(f'{k} {s:.3f} s' for k, s in rec.seconds.items())} "
        f"(grew workspaces: {rec.grew}; {len(want_keys)} of "
        f"{len(holding)} steps hold the triple); wall {wall:.3f} s")
    if ev.tick != 3 or rec.tick != 3 or rec.triple != triple or \
            list(rec.seconds) != want_keys:
        raise AssertionError(f"{label}: the swap fired at tick {ev.tick} "
                             f"or recaptured {list(rec.seconds)}, not "
                             f"{want_keys} at tick 3")
    eng.close()
    _fresh_cache()
    return want, got


def phase_tune(shapes, rows, gen, llama_tokens) -> None:
    """Phase 11: (a) tune the serve signatures, (b) what the measured picks
    do, (c) the monitor at its defaults, (d) a forced swap; each part's
    seconds printed."""
    import tempfile
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_model
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        tune_tables(root, shapes)
        say(f"[tune] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        measured_picks(root, shapes, rows, gen)
        cfg = get_config("llama3_8b")
        params = init_model(cfg, seed=0, device=DEV)
        serve_tuned(root, cfg, params, llama_tokens)
        say(f"[tune] (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    plain = monitor_defaults(cfg, params)
    say(f"[tune] (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want, got = forced_swap(cfg, params, _llama_prompts(cfg.vocab),
                            LLAMA_KW, "llama3-8b bf16 full width")
    say(f"[tune] (d) llama3-8b bf16 tokens against the unmonitored run: "
        f"{_agree(want, got)} ({_first_diff(want, got)}); the unmonitored "
        f"run against (c)'s: {_agree(plain, want)}")
    del params
    _free()
    scfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    sparams = init_model(scfg, seed=7, device=DEV)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, scfg.vocab, n) for n in DRILL_LENS]
    want, got = forced_swap(scfg, sparams, prompts, DRILL_KW,
                            "llama3-8b f32 smoke")
    say(f"[tune] (d) f32 smoke tokens equal to the unmonitored run: "
        f"{got == want}")
    if got != want:
        raise AssertionError("f32 tokens differ across the swap")
    say(f"[tune] (d) {time.perf_counter() - t0:.1f} s")
    _free()


# ---------------------------------------------------------------------------
# Phase 12: whisper-large-v3 and the non-paged serve steps on the card
# ---------------------------------------------------------------------------

#: Phase 12 (b): whisper-large-v3's batch, prompt length and cache length.
WHISPER_RUN = dict(batch=4, prompt_len=16, max_len=64)
#: Phase 12 (a): K2's four new kinds of call at whisper's shapes (20 query
#: heads over 20 KV heads of 64, bf16), through the paged entry: (name,
#: rows, sq, page, causal, the rows' lengths).  A row's K/V are one block of
#: the pool: the encoder's and the cross-attention's 1500 frames, the
#: decoder's cache of ``max_len``.
K2_WHISPER_ROWS = (
    ("encoder self-attention", 4, 1500, 1500, False, (1500,) * 4),
    ("cross-attention at prefill", 4, 16, 1500, False, (1500,) * 4),
    ("cross-attention at decode", 4, 1, 1500, False, (1500,) * 4),
    ("decoder self-attention at decode", 4, 1, 64, True, (23, 0, 40, 64)),
)


def phase_whisper_k2(gen) -> float:
    """(a) K2's new signatures against the plain version and
    ``kernels.ref``, timed eagerly and as device time beside SDPA and the
    bound; ten leaves of the encoder's signature with the napkin's rank
    beside the card's.  Returns the largest error."""
    err = 0.0
    for name, rows, sq, page, causal, lens in K2_WHISPER_ROWS:
        sig = _paged_sig(20, 20, 64, None, rows, sq, 1, page, torch.bfloat16,
                         causal=causal)
        PAGED_LENS[sig] = lens
        nsplit = -(-page // sig[10])
        row = paged_case(sig, gen, timed=True,
                         launches=3 if nsplit > 1 else 1, against_ref=True)
        err = max(err, row["err"])
        say(f"[whisper] (a) K2 {name}: rows {rows} sq {sq} page {page} "
            f"causal {causal} lengths {list(lens)}, leaf "
            f"{dict(zip(FA_PARAMS, sig[8:12]))}, {nsplit} split(s)"
            f"{', three launches bit for bit equal' if nsplit > 1 else ''}:"
            f" {fmt(row)}")
    leaf_rows = {}
    for cand in _fa_leaves({"SQ": 1500, "HD": 64, "GROUP": 1, "HK": 20}):
        sig = _paged_sig(20, 20, 64, None, 4, 1500, 1, 1500, torch.bfloat16,
                         causal=False, assignment=cand.assignment)
        PAGED_LENS[sig] = (1500,) * 4
        leaf_rows[sig] = dict(paged_case(sig, gen, timed=True,
                                         leaf_only=True), score=cand.score)
        err = max(err, leaf_rows[sig]["err"])
    rank = {k: sorted(leaf_rows, key=lambda s: leaf_rows[s][k])
            for k in ("ms", "device_ms")}
    by_score = sorted(leaf_rows, key=lambda s: -leaf_rows[s]["score"])
    for i, (sig, row) in enumerate(leaf_rows.items()):
        say(f"[whisper] (a) leaf encoder self-attention "
            f"{dict(zip(FA_PARAMS, sig[8:12]))}{' (pick)' if i == 0 else ''}"
            f": {fmt(row)}; napkin score {row['score']:.4g} rank "
            f"{by_score.index(sig) + 1}, card rank "
            f"{rank['ms'].index(sig) + 1} (device "
            f"{rank['device_ms'].index(sig) + 1}) of {len(leaf_rows)}")
    pick = leaf_rows[next(iter(leaf_rows))]
    for k in ("ms", "device_ms"):
        best = leaf_rows[rank[k][0]][k]
        say(f"[whisper] (a) encoder self-attention: {k} pick {pick[k]:.4f}, "
            f"fastest of {len(leaf_rows)} leaves {best:.4f} "
            f"({pick[k] / best:.2f}x)")
    return err


def _leaves(node):
    """The tensors of a parameter tree."""
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _nbytes(node) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(node))


def _median_line(host_s, dev_pairs) -> str:
    """Medians and ranges of host seconds and (start, end) event pairs."""
    host = sorted(1e3 * t for t in host_s)
    dev = sorted(s.elapsed_time(e) for s, e in dev_pairs)
    return (f"host {host[len(host) // 2]:.3f} ms median ({host[0]:.3f}-"
            f"{host[-1]:.3f}), device {dev[len(dev) // 2]:.3f} ms median "
            f"({dev[0]:.3f}-{dev[-1]:.3f}) over {len(dev)}")


def _timed(fn):
    """(host seconds to the return, (start, end) CUDA events) of fn()."""
    s_ = torch.cuda.Event(enable_timing=True)
    e_ = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s_.record()
    fn()
    e_.record()
    return time.perf_counter() - t0, (s_, e_)


def phase_whisper(gen) -> dict:
    """(b) whisper-large-v3 at full width and depth through
    ``build_serve_steps``: 4 requests, 1500 seeded frames each and 16-token
    prompts, greedy ``MAX_NEW`` new tokens (the first from the prefill, the
    rest from decode steps replayed from one CUDA graph); encode and
    prefill run eagerly.  Every launch counter is set to 0 just before the
    path and read just after.  Returns the path's record as
    :func:`phase_serve` does."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.models import encode, init_cache, init_model
    from repro_torch.runtime import (build_serve_steps, greedy_sample,
                                     warm_steps_dispatch)
    from repro_torch.runtime.graph import CudaGraph, StepGraphs

    cfg = get_config("whisper_large_v3")
    B, S, L = (WHISPER_RUN[k] for k in ("batch", "prompt_len", "max_len"))
    S_enc, d, f = cfg.encoder.seq_len, cfg.d_model, cfg.d_ff
    nh, nk, hd, V = cfg.heads, cfg.kv_heads, cfg.hd, cfg.vocab
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in _leaves(params))
    say(f"[whisper] (b) {cfg.name}: {cfg.encoder.layers} encoder + "
        f"{cfg.layers} decoder layers, d_model {d}, {nh} heads of {hd}, "
        f"vocab {V}, {cfg.dtype}; {nparam / 1e9:.3f} B parameters, "
        f"{_nbytes(params) / 1e9:.3f} GB made in "
        f"{time.perf_counter() - t0:.3f} s")
    # reckonings from the config (not measurements): the cross cache a row,
    # the bytes a decode tick must read (the decoder's weights but the
    # cross K/V projections, the lm_head, the cross cache and the self
    # cache at half the new tokens), and the encoder's flops
    attn_w = 2 * (d * nh * hd + nh * hd * d)          # q and o, bf16
    kv_w = 2 * 2 * d * nk * hd
    tick_bytes = (cfg.layers * (2 * attn_w + kv_w + 2 * 3 * d * f)
                  + 2 * d * V
                  + 2 * 2 * cfg.layers * B * (S_enc + S + MAX_NEW // 2)
                  * nk * hd)
    enc_flops = cfg.encoder.layers * (
        2 * B * S_enc * (2 * d * nh * hd + 2 * d * nk * hd + 3 * d * f)
        + 4 * B * nh * S_enc * S_enc * hd)
    say(f"[whisper] (b) reckoned from the config, not measured: ck/cv "
        f"{2 * 2 * cfg.layers * S_enc * nk * hd / 1e6:.1f} MB a row; a "
        f"decode tick at {B} rows reads {tick_bytes / 1e9:.3f} GB, "
        f"{1e3 * tick_bytes / _roofline().HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; "
        f"encoding {B} rows is {enc_flops / 1e12:.2f} TFLOP, "
        f"{1e3 * enc_flops / _roofline().PEAK_FLOPS[torch.bfloat16]:.3f} ms at the "
        f"dense bf16 peak")

    t0 = time.perf_counter()
    picks = warm_steps_dispatch(cfg, **WHISPER_RUN)
    stats = get_default_cache().stats
    cold0 = stats.cold_builds
    say(f"[whisper] (b) warm-up: {len(picks)} kernel picks frozen in "
        f"{time.perf_counter() - t0:.1f} s")
    prefill_step, decode_one = build_serve_steps(cfg)
    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, V, (B, S)), dtype=torch.int32,
                           device=DEV)
    frames = torch.randn((B, S_enc, d), generator=gen, device=DEV).to(
        torch.bfloat16)
    cache = init_cache(cfg, B, L, device=DEV)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    idx = torch.zeros((B,), dtype=torch.int32, device=DEV)

    def prefill_body():
        last, _ = prefill_step(params, prompts, cache, enc_embeds=frames)
        tok.copy_(greedy_sample(last))
        idx.fill_(S)

    def decode_body():
        logits, _ = decode_one(params, tok, cache, idx)
        tok.copy_(greedy_sample(logits))
        idx.add_(1)

    # one eager run of each body sizes the split workspaces, then the
    # decode step is captured once
    prefill_body()
    decode_body()
    torch.cuda.synchronize()
    graphs = StepGraphs(functools.partial(CudaGraph,
                                          torch.cuda.graph_pool_handle()))
    t0 = time.perf_counter()
    step = graphs.capture("decode", decode_body)
    torch.cuda.synchronize()
    say(f"[whisper] (b) decode step captured in "
        f"{time.perf_counter() - t0:.3f} s")

    kernels = _counters(SERVE_KERNELS)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()
    t0 = time.perf_counter()
    pre_host, pre_ev = _timed(prefill_body)
    out = [tok.clone()]
    tick_host, tick_ev = [], []
    for _ in range(MAX_NEW - 1):
        h, ev = _timed(step)
        tick_host.append(h)
        tick_ev.append(ev)
        out.append(tok.clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    shapes = {n: dict(k.shapes) for n, k in kernels.items()}
    cold = stats.cold_builds - cold0
    toks = torch.cat(out, 1).tolist()

    # the same tokens from eager decode steps after a fresh prefill
    prefill_body()
    eager = [tok.clone()]
    for _ in range(MAX_NEW - 1):
        decode_body()
        eager.append(tok.clone())
    eager = torch.cat(eager, 1).tolist()
    for b in range(B):
        say(f"[whisper] (b) request {b}: prompt {S} tokens, 1500 frames -> "
            f"{toks[b]} (eager decode: {eager[b]})")
    ntok = B * MAX_NEW
    say(f"[whisper] (b) {B} requests, {ntok} tokens in {wall:.3f} s: "
        f"{ntok / wall:.2f} tokens/s; 1 prefill (encode included, eager), "
        f"{step.replays} decode graph replays; launches "
        f"{json.dumps(launches)}; cold dispatch builds after warm-up: "
        f"{cold}")
    # K1: the encoder's q, k, v, o and MLP; the prefill's self q, k, v, o,
    # cross q, k, v, o and MLP; a decode step's self q, k, v, o, cross q, o
    # and MLP; an lm_head a step.  K2: one a layer for the encoder, two (self
    # and cross) a decoder layer a step
    want_mm = (cfg.encoder.layers * 7 + cfg.layers * 11 + 1
               + (MAX_NEW - 1) * (cfg.layers * 9 + 1))
    want_fa = cfg.encoder.layers + 2 * cfg.layers * MAX_NEW
    if step.replays != MAX_NEW - 1:
        raise AssertionError(f"{step.replays} decode graph replays")
    if (launches["matmul_h100"], launches["flash_attention_h100"]) != (
            want_mm, want_fa) or launches["ssd_scan_h100"] \
            or launches["matmul_h100_batched"]:
        raise AssertionError(f"whisper launches {launches}, expected K1 "
                             f"{want_mm} and K2 {want_fa}")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    if toks != eager or not all(0 <= t < V for row in toks for t in row):
        raise AssertionError("whisper: the replayed decode's tokens differ "
                             "from an eager decode's, or are not tokens")

    # the times: the counted run's prefill and decode ticks, and encode
    # and prefill again three times each, uncounted
    enc_runs = [_timed(lambda: encode(params, cfg, frames))
                for _ in range(3)]
    pre_runs = [(pre_host, pre_ev)] + [_timed(prefill_body)
                                       for _ in range(2)]
    torch.cuda.synchronize()
    say(f"[whisper] (b) encode ({B} x {S_enc} frames, eager): "
        f"{_median_line([h for h, _ in enc_runs], [e for _, e in enc_runs])}")
    say(f"[whisper] (b) prefill (encode, cross K/V and {S}-token prompts, "
        f"eager): {_median_line([h for h, _ in pre_runs], [e for _, e in pre_runs])}")
    say(f"[whisper] (b) decode tick (one graph replay): "
        f"{_median_line(tick_host, tick_ev)}")
    idx.fill_(S)
    say(f"[whisper] (b) {tick_profile(step.graph.replay)}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    say(f"[whisper] (b) peak device memory (weights, cache, workspaces, "
        f"graph, encoder activations): {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    # the lengths phase 9's timing of these signatures reads: every frame
    # for the encoder and the cross-attention, the prompts for their own
    # attention, a decode row halfway through its new tokens
    for sig in shapes["flash_attention_h100"]:
        rows, sq, page, causal = sig[1], sig[4], sig[7], sig[12]
        PAGED_LENS[sig] = (((page,) if not causal else (S,) if sq > 1
                            else (S + MAX_NEW // 2,)) * rows)
    graphs.release()
    del graphs, step, params, cache, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": cfg.name, "wall_ms": 1e3 * wall, "launches": launches,
            "shapes": shapes, "peak_gib": peak, "tokens": toks}


def phase_steps_parity() -> None:
    """(c) The f32 smoke config of every arch through the non-paged steps
    (``build_serve_steps``, the default bf16 cache, a (B,) cache index) on
    the card and on the CPU (the plain versions) from the same weights:
    equal greedy tokens.  Prompts of 28 tokens and 8 new ones wrap hymba's
    ring of 32."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import init_cache, init_model
    from repro_torch.runtime import build_serve_steps, greedy_sample
    B, S, L = 2, 28, 40
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        params = {"cpu": init_model(cfg, seed=7, device="cpu")}
        if cfg.qkv_bias:          # init makes them zero: plant non-zero ones
            g = torch.Generator().manual_seed(7)
            for lp in params["cpu"]["layers"]:
                for name in ("bq", "bk", "bv"):
                    lp["attn"][name].normal_(generator=g)
        params[DEV] = _to(params["cpu"], DEV)
        rng = np.random.default_rng(7)
        toks = rng.integers(0, cfg.vocab, (B, S))
        extra = {}
        if cfg.encoder is not None:
            extra["enc_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
        elif cfg.frontend == "stub":
            extra["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, 8, cfg.d_model)).astype(np.float32))
        prefill_step, decode_one = build_serve_steps(cfg)
        got = {}
        for dev in ("cpu", DEV):
            cache = init_cache(cfg, B, L, device=dev)
            last, _ = prefill_step(params[dev], toks, cache,
                                   **{k: v.to(dev) for k, v in extra.items()})
            tok = greedy_sample(last)
            out = [tok]
            idx = torch.full((B,), S, dtype=torch.int32, device=dev)
            for _ in range(MAX_NEW - 1):
                logits, _ = decode_one(params[dev], tok, cache, idx)
                tok = greedy_sample(logits)
                out.append(tok)
                idx += 1
            got[dev] = torch.cat(out, 1).tolist()
        say(f"[whisper] (c) {cfg.name} f32, non-paged steps: cpu plain "
            f"{got['cpu']}, cuda kernels {got[DEV]}")
        if got["cpu"] != got[DEV]:
            raise AssertionError(f"{cfg.name}: the non-paged steps' tokens "
                                 "differ between the card and the CPU")


# ---------------------------------------------------------------------------
# Phase 13: training on the card
# ---------------------------------------------------------------------------

#: K2b's signatures in 13 (a): (label, rows, h, hk, sq, page, d, causal,
#: window, the rows' lengths or None for full rows).
BWD_SIGNATURES = (
    ("llama3-8b training", 4, 32, 8, 1024, 1024, 128, True, None, None),
    ("whisper encoder", 2, 20, 20, 1500, 1500, 64, False, None, None),
    ("cross-attention", 2, 20, 20, 64, 1500, 64, False, None, None),
    ("ragged lengths", 4, 32, 8, 256, 256, 128, True, None,
     (256, 100, 0, 17)),
    ("window 256", 2, 32, 8, 1024, 1024, 128, True, 256, None),
)
#: K2b against its plain version and autograd: a share of each gradient's
#: largest element (module docstring).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: {K2b signature: the rows' lengths it is checked, timed and bound at}
BWD_LENS = {}
#: 13 (b): llama3-8b at full width, its depth cut to what one card holds.
TRAIN_LAYERS = 4
TRAIN_RUN = dict(seq=1024, batch=8, microbatches=2, steps=6, ckpt_at=3,
                 lr=1e-4)
#: 13 (c): whisper-large-v3 at full width, 4 + 4 layers.
WHISPER_TRAIN = dict(layers=4, batch=2, seq=64, steps=2, lr=3e-4)
#: 13 (d): the f32 smoke configs, card against CPU, at 32 tokens (40 for
#: the SSM and hybrid configs: past their chunk of 16 and hymba's window
#: of 32).
TRAIN_PARITY = ("llama3_8b", "granite_3_8b", "yi_6b", "qwen1p5_4b",
                "chameleon_34b", "whisper_large_v3", "mamba2_130m",
                "hymba_1p5b", "llama4_scout_17b_a16e", "kimi_k2_1t_a32b")
TRAIN_KERNELS = ("matmul_h100", "transpose_h100", "flash_attention_h100",
                 "flash_attention_bwd_h100", "ssd_scan_h100",
                 "ssd_scan_bwd_h100", "matmul_h100_batched",
                 "transpose_h100_batched")
#: K3b's keys in 13 (f): (label, rows, seq, heads, hd, state, state0
#: given, dS_final given), b and c shared across heads as the model passes
#: them; the first two are (g)'s and (h)'s microbatches.
SSD_BWD_SIGNATURES = (
    ("mamba2-130m training", 4, 1024, 24, 64, 128, False, False),
    ("hymba-1.5b training", 2, 2048, 25, 64, 16, False, False),
    ("ragged seq 1000, state0 and dS_final", 2, 1000, 24, 64, 128, True,
     True),
    ("seq 1, state0 and dS_final", 4, 1, 24, 64, 128, True, True),
)
#: 13 (g): mamba2-130m at full width and depth; (h): hymba-1.5b at full
#: width, its depth cut as llama3-8b's is, 2048 tokens a row so that the
#: window of 1024 binds.
MAMBA_TRAIN = dict(seq=1024, batch=8, microbatches=2, steps=4, ckpt_at=2,
                   lr=1e-4)
#: 13 (i): the MoE configs whose experts' training keys K1's and K4's
#: batched entries are checked and timed at, one microbatch of 1 x 1024
#: tokens (one routing group: C = capacity(1024, E, k, 1.25) rows an
#: expert): llama4-scout's, the keys (j) launches, and kimi-k2's, held out
#: (its full width trains on no single card).  (config, held out).
MOE_BWD_CONFIGS = (("llama4_scout_17b_a16e", False),
                   ("kimi_k2_1t_a32b", True))
#: 13 (j): llama4-scout at full width, 1 of 48 layers (4.1 B parameters,
#: 66.3 GB of state at 16 B a parameter), 2 rows of 1024 tokens in 2
#: microbatches; no checkpoint: the state has no second copy on the card.
LLAMA4_LAYERS = 1
LLAMA4_TRAIN = dict(seq=1024, batch=2, microbatches=2, steps=4, ckpt_at=None,
                    lr=1e-4, note="no checkpoint and no bit-for-bit restart: "
                    "a 66 GB state has no second copy on the card")
HYMBA_LAYERS = 4
HYMBA_TRAIN = dict(seq=2048, batch=4, microbatches=2, steps=2, ckpt_at=None,
                   lr=1e-4)


def held_rel(name: str, got: torch.Tensor, want: torch.Tensor,
             tol: float) -> float:
    """Max |got - want|; raises unless every element is within ``tol`` of
    ``want``'s largest element (and ``tol`` of itself)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol * scale):
        raise AssertionError(f"{name}: max_abs_err {err:.3e} outside "
                             f"{tol} of the largest element {scale:.3e}")
    return err


def bwd_case(sig, gen, *, timed: bool):
    """K2b at (rows, h, hk, sq, page, d, bq, bkv, causal, window, dtype),
    the wrapper's ``shapes`` key, each row at its length in ``BWD_LENS``:
    o from K2's paged plain version; held against K2b's plain version and
    against ``torch.autograd`` of K2's paged plain version (``BWD_TOL``),
    a row of length 0 all zeros, two launches bit for bit; timed eagerly
    and as device time beside the plain version and SDPA's backward (a
    yardstick: ``torch.autograd.grad`` of SDPA over the same inputs and
    mask) when ``timed``."""
    from repro_torch.kernels.flash_attention import flash_attention_paged_plain
    from repro_torch.kernels.flash_attention_bwd import (
        _masks, flash_attention_bwd_h100, flash_attention_bwd_plain)
    R, h, hk, sq, page, d, bq, bkv, causal, window, dtype = sig
    lens = BWD_LENS[sig]
    q = torch.randn((R, h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((R, page, hk, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((R, page, hk, d), generator=gen, device=DEV).to(dtype)
    do = torch.randn((R, h, sq, d), generator=gen, device=DEV).to(dtype)
    tl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    tables = torch.arange(R, dtype=torch.int32, device=DEV)[:, None]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    o = flash_attention_paged_plain(qg, kg, vg, tables, tl, bq=16, bkv=64,
                                    kv_chunk=4096, causal=causal,
                                    window=window)
    auto = torch.autograd.grad(o, (qg, kg, vg), do)
    o = o.detach()
    del qg, kg, vg
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)

    def launch():
        return flash_attention_bwd_h100(q, k, v, o, do, tl, **kw)

    got, again = launch(), launch()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K2b {sig}: two launches differ")
    want = flash_attention_bwd_plain(q, k, v, o, do, tl, **kw)
    tol = BWD_TOL[dtype]
    names = ("dq", "dk", "dv")
    row = {"err": max(held_rel(f"K2b {sig} {n}", g, w, tol)
                      for n, g, w in zip(names, got, want)),
           "autograd_err": max(held_rel(f"K2b {sig} {n} against autograd",
                                        g, a, tol)
                               for n, g, a in zip(names, got, auto))}
    for b, n in enumerate(lens):
        if n == 0:
            for name, g in zip(names, got):
                exact(f"K2b {sig} row {b} of length 0 {name}", g[b],
                      torch.zeros_like(g[b]))
    del got, again, want, auto
    if timed:
        time_into(row, "ms", launch, 5)
        row["device_ms"] = graph_ms(launch, 5)
        time_into(row, "plain_ms", lambda: flash_attention_bwd_plain(
            q, k, v, o, do, tl, **kw), 2)
        qs = q.detach().requires_grad_()
        ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
        extra = {}
        if sdpa_gqa():
            extra["enable_gqa"] = h != hk
        else:
            ks, vs = (x.repeat_interleave(h // hk, 1) for x in (ks, vs))
        ks, vs = ks.requires_grad_(), vs.requires_grad_()
        full = all(n == page for n in lens) and window is None
        if full and (not causal or sq == page):
            mkw = {"is_causal": causal}
        else:
            mkw = {"attn_mask": _masks(tl, sq, page, causal, window)}
        out = F.scaled_dot_product_attention(qs, ks, vs, **mkw, **extra)
        time_into(row, "library_ms", lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), 5)
        row["bound_ms"] = max(bound_terms_ms("flash_attention_bwd_h100",
                                             sig))
    return row


CASES["flash_attention_bwd_h100"] = bwd_case


#: K3b against its plain version and autograd: a share of each gradient's
#: largest element (module docstring); da and d(state0) are f32 whatever
#: the inputs' type.
SSD_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def ssd_bwd_case(sig, gen, *, timed: bool):
    """K3b at (rows, seq, heads, hd, state, chunk, shared, state0 given,
    dS_final given, dtype), the wrapper's ``shapes`` key, on inputs
    shaped as the model makes them (x, b, c, dy in the compute type, b and
    c shared across heads when ``shared``, the decay in (0.05, 0.95), the
    states f32): held against the plain version and against
    ``torch.autograd`` of K3's plain version (``SSD_BWD_TOL``), two
    launches bit for bit; timed eagerly and as device time on copies of
    the inputs cold to the L2 (``_cold_copies``), beside the plain version
    and the bound, when ``timed``.  No single PyTorch call computes it:
    ``library_ms`` is None."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.ssd_scan_bwd import (ssd_scan_bwd_h100,
                                                  ssd_scan_bwd_plain)
    R, S, H, hd, n, chunk, shared, with_state, with_dsf, dtype = sig

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=DEV).to(dt)

    x, dy = randn(R, S, H, hd), randn(R, S, H, hd)
    a = torch.sigmoid(randn(R, S, H, dt=torch.float32)) * 0.9 + 0.05
    bc = (R, S, n) if shared else (R, S, H, n)
    b, c = randn(*bc), randn(*bc)
    s0 = randn(R, H, n, hd, dt=torch.float32) if with_state else None
    dsf = randn(R, H, n, hd, dt=torch.float32) if with_dsf else None

    def launch(x=x, a=a, b=b, c=c, dy=dy):
        return ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, chunk=chunk)

    got, again = launch(), launch()
    torch.cuda.synchronize()
    if not with_state and not (got[4] is None and again[4] is None):
        raise AssertionError(f"K3b {sig}: a d(state0) without a state0")
    got, again = got[:4 + with_state], again[:4 + with_state]
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"K3b {sig}: two launches differ")
    want = ssd_scan_bwd_plain(x, a, b, c, s0, dy, dsf, chunk=chunk)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, a, b, c) + ((s0,) if with_state else ())]
    y, sf = ssd_scan_plain(*leaves[:4], leaves[4] if with_state else None,
                           chunk=chunk, bd=32)
    loss = (y.float() * dy.float()).sum()
    if with_dsf:
        loss = loss + (sf * dsf).sum()
    auto = list(torch.autograd.grad(loss, leaves))
    del y, sf, loss, leaves
    names = ("dx", "da", "db", "dc", "dstate0")
    f32 = SSD_BWD_TOL[torch.float32]
    tols = [SSD_BWD_TOL[dtype], f32, SSD_BWD_TOL[dtype], SSD_BWD_TOL[dtype],
            f32]
    row = {"err": max(held_rel(f"K3b {sig} {nm}", g, w, t)
                      for nm, g, w, t in zip(names, got, want, tols)),
           "autograd_err": max(held_rel(f"K3b {sig} {nm} against autograd",
                                        g, w, t)
                               for nm, g, w, t in zip(names, got, auto,
                                                      tols))}
    del got, again, want, auto
    if timed:
        cold = _cold_copies((x, a, b, c, dy),
                            sum(t.numel() * t.element_size()
                                for t in (x, a, b, c, dy)))
        time_into(row, "ms", lambda: launch(*next(cold)), 5)
        row["device_ms"] = graph_ms(lambda: launch(*next(cold)), 5)
        del cold
        time_into(row, "plain_ms", lambda: ssd_scan_bwd_plain(
            x, a, b, c, s0, dy, dsf, chunk=chunk), 2)
        row["library_ms"] = None
        row["bound_ms"] = max(bound_terms_ms("ssd_scan_bwd_h100", sig))
        row["bound_f32_ms"] = ssd_bwd_f32_bound_ms(sig)
    return row


CASES["ssd_scan_bwd_h100"] = ssd_bwd_case


#: The K2b keys whose every leaf 13 (a) times in bf16: the labels of
#: ``BWD_SIGNATURES`` rows.
BWD_LEAF_ROWS = ("llama3-8b training", "whisper encoder")
BWD_KERNELS = ("fa_bwd_lse_kernel", "fa_bwd_dq_tc_kernel",
               "fa_bwd_dkdv_tc_kernel")


def bwd_kernel_us(launch, calls: int = 5, names=BWD_KERNELS):
    """[lse, dQ, dK/dV] device µs a call of K2b's bf16 body (or of the
    kernels ``names``) under ``torch.profiler``, over ``calls`` calls after
    3 warm-up calls; None unless the profiler recorded each kernel once a
    call."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            launch()
        torch.cuda.synchronize()
    out = []
    for kn in names:
        evs = [e for e in prof.key_averages() if kn in e.key]
        if sum(e.count for e in evs) != calls:
            return None
        out.append(sum(getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0) for e in evs) / calls)
    return out


def bwd_leaf_rows(label, R, h, hk, sq, page, d, causal, window, gen
                  ) -> float:
    """Every leaf of K2b's tree at one key, bf16, full rows: each held
    against the plain version (``BWD_TOL``), two launches bit for bit,
    timed as CUDA-graph device time and each of its three kernels under
    ``torch.profiler``; printed with the napkin's rank beside the card's.
    Returns the largest error."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels.flash_attention import flash_attention_paged_plain
    from repro_torch.kernels.flash_attention_bwd import (
        FAMILY, flash_attention_bwd_h100, flash_attention_bwd_plain)
    dtype = torch.bfloat16
    q = torch.randn((R, h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((R, page, hk, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((R, page, hk, d), generator=gen, device=DEV).to(dtype)
    do = torch.randn((R, h, sq, d), generator=gen, device=DEV).to(dtype)
    tl = torch.full((R,), page, dtype=torch.int32, device=DEV)
    tables = torch.arange(R, dtype=torch.int32, device=DEV)[:, None]
    o = flash_attention_paged_plain(q, k, v, tables, tl, bq=16, bkv=64,
                                    kv_chunk=4096, causal=causal,
                                    window=window)
    want = flash_attention_bwd_plain(q, k, v, o, do, tl, bq=16, bkv=16,
                                     causal=causal, window=window)
    ranked = rank_candidates(FAMILY, H100_SXM, {
        "SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk})
    rows, err = {}, 0.0
    for cand in ranked:
        kw = dict(bq=cand.assignment["bq"], bkv=cand.assignment["bkv"],
                  causal=causal, window=window)

        def launch():
            return flash_attention_bwd_h100(q, k, v, o, do, tl, **kw)

        got, again = launch(), launch()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K2b leaf {label} {kw}: two launches "
                                 f"differ")
        e = max(held_rel(f"K2b leaf {label} {kw} {n}", g, w,
                         BWD_TOL[dtype])
                for n, g, w in zip(("dq", "dk", "dv"), got, want))
        err = max(err, e)
        del got, again
        rows[(kw["bq"], kw["bkv"])] = {
            "err": e, "device_ms": graph_ms(launch, 5), "score": cand.score,
            "us": bwd_kernel_us(launch)}
    by_card = sorted(rows, key=lambda x: rows[x]["device_ms"])
    for i, (leaf, row) in enumerate(rows.items()):
        if row["us"] is None:
            split = "the profiler missed some of its launches"
        else:
            lse_us, dq_us, kv_us = row["us"]
            split = (f"lse {lse_us / 1e3:.4f}, dq {dq_us / 1e3:.4f}, dkdv "
                     f"{kv_us / 1e3:.4f} under the profiler; the lse "
                     f"recompute {100 * lse_us / dq_us:.1f} % of the dQ "
                     f"kernel's time")
        say(f"[train] (a) K2b leaf {label} bq {leaf[0]} bkv {leaf[1]}"
            f"{' (pick)' if i == 0 else ''}: device_ms "
            f"{row['device_ms']:.4f} ({split}), err {row['err']:.3e}; "
            f"napkin score "
            f"{row['score']:.4g} rank {i + 1}, card rank "
            f"{by_card.index(leaf) + 1} of {len(rows)}")
    pick, best = rows[next(iter(rows))], rows[by_card[0]]
    say(f"[train] (a) K2b {label}: device_ms pick {pick['device_ms']:.4f}, "
        f"fastest of {len(rows)} leaves {best['device_ms']:.4f} "
        f"({pick['device_ms'] / best['device_ms']:.2f}x)")
    return err


def phase_train_k2b(gen) -> tuple:
    """(a) K2b through the pick of each signature's key in bf16 and f32,
    then every leaf at the keys of ``BWD_LEAF_ROWS`` in bf16; returns
    (largest error against the plain version, {sig: row})."""
    from repro_torch.kernels import ops
    err, rows = 0.0, {}
    for label, R, h, hk, sq, page, d, causal, window, lens in BWD_SIGNATURES:
        pick = ops.select("flash_attention_bwd_h100", {
            "SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk}).assignment
        for dtype in (torch.bfloat16, torch.float32):
            sig = (R, h, hk, sq, page, d, pick["bq"], pick["bkv"], causal,
                   window, dtype)
            BWD_LENS[sig] = tuple(lens or (page,) * R)
            row = bwd_case(sig, gen, timed=True)
            rows[sig] = row
            err = max(err, row["err"])
            say(f"[train] (a) K2b {label}, rows {R}, {h} over {hk} heads, "
                f"sq {sq}, keys {page} (lengths {BWD_LENS[sig]}), d {d}, "
                f"causal {causal}, window {window}, {dtype}, pick bq "
                f"{pick['bq']} bkv {pick['bkv']}: {fmt(row)} "
                f"autograd_err {row['autograd_err']:.3e}; two launches "
                f"equal bit for bit")
            torch.cuda.empty_cache()
    return max(err, in_child(_bwd_leaf_child, "K2b's leaf tables")), rows


def in_child(target, what: str) -> float:
    """``target(src, errs)`` in a fresh process; returns the largest error
    it puts on ``errs``.  The leaf tables run so: late in a whole run
    torch.profiler has recorded a few of a session's kernels or none
    (PERF.md §7), where a new process records them all."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    errs = ctx.Queue()
    child = ctx.Process(target=target,
                        args=(str(Path(__file__).resolve().parent / "src"),
                              errs))
    child.start()
    child.join()
    if child.exitcode != 0:
        raise AssertionError(f"{what}: the process exited {child.exitcode}")
    return errs.get(timeout=60)


def _child_gen(src: str):
    """A leaf-table process's set-up: the port's sources on the path, TF32
    off, a seeded generator on the card."""
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    return gen


def _bwd_leaf_child(src: str, errs) -> None:
    """The process of 13 (a)'s leaf tables: ``bwd_leaf_rows`` at each key
    of ``BWD_LEAF_ROWS``; puts the largest error on ``errs``."""
    gen = _child_gen(src)
    err = 0.0
    for label, R, h, hk, sq, page, d, causal, window, _ in BWD_SIGNATURES:
        if label in BWD_LEAF_ROWS:
            err = max(err, bwd_leaf_rows(label, R, h, hk, sq, page, d,
                                         causal, window, gen))
            torch.cuda.empty_cache()
    errs.put(err)


def _k3b_leaf_child(src: str, errs) -> None:
    """The process of 13 (f)'s leaf tables: ``k3b_leaf_rows`` at (g)'s and
    (h)'s keys and at the keys of ``K3B_HELD_OUT``; puts the largest error
    on ``errs``."""
    gen = _child_gen(src)
    err = 0.0
    keys = [k[:6] for k in SSD_BWD_SIGNATURES[:2]] + list(K3B_HELD_OUT)
    for label, R, S, H, hd, n in keys:
        err = max(err, k3b_leaf_rows(label, R, S, H, hd, n, gen))
        torch.cuda.empty_cache()
    errs.put(err)


def _train_counts(cfg, mb: int) -> dict:
    """Launches a train step makes, a microbatch each: each K1 product of
    the forward (a layer's 4 of attention, 5 of the SSM block, 3 of the
    MLP and the MoE router, and the lm_head; whisper's encoder layers and
    cross-attention too) and its dA and dB, two K4 transposes a product,
    one K2 and one K2b call (three kernels in bf16, two in f32:
    ``launches_a_call``) an attention core, one K3 and one K3b call (three
    kernels) an SSD core; an MoE layer's three expert products on K1's
    batched entry, their dA and dB there too, and two K4b transposes a
    product.  Under ``remat="full"`` a block's forward runs again in the
    backward: its forward launches count twice (the lm_head's once)."""
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.kernels.flash_attention_bwd import launches_a_call
    from repro_torch.models.transformer import has_attn, has_mlp, has_ssm
    fwd = 2 if cfg.remat == "full" else 1
    moe = cfg.block == "attn_moe"
    per_layer = (4 * has_attn(cfg) + 5 * has_ssm(cfg) + 3 * has_mlp(cfg)
                 + moe)
    prods = per_layer * cfg.layers
    cores = cfg.layers if has_attn(cfg) else 0
    scans = cfg.layers if has_ssm(cfg) else 0
    experts = 3 * cfg.layers if moe else 0
    if cfg.encoder is not None:
        prods += 7 * cfg.encoder.layers + 4 * cfg.layers
        cores += cfg.encoder.layers + cfg.layers
    return {"matmul_h100": ((fwd + 2) * prods + 3) * mb,
            "transpose_h100": 2 * (prods + 1) * mb,
            "flash_attention_h100": fwd * cores * mb,
            "flash_attention_bwd_h100":
                launches_a_call(getattr(torch, cfg.dtype)) * cores * mb,
            "ssd_scan_h100": fwd * scans * mb,
            "ssd_scan_bwd_h100": ssd_scan_bwd.LAUNCHES_A_CALL * scans * mb,
            "matmul_h100_batched": (fwd + 2) * experts * mb,
            "transpose_h100_batched": 2 * experts * mb}


def _step_timed(step_fn, params, opt_state, batch, step) -> tuple:
    """One train step: (params, opt_state, metrics as floats, host s,
    CUDA-event ms)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    params, opt_state, m = step_fn(params, opt_state, batch, step)
    end.record()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    return (params, opt_state, {k: float(v) for k, v in m.items()}, host,
            start.elapsed_time(end))


def _profile_step(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``: (a line of device ms by
    kernel group (K1, K4, K2, K2b, K3, K3b, NCCL's collectives, the rest)
    and the rest's largest kernels, {group: device ms})."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"K1": ("matmul_kernel",), "K4": ("transpose_",),
              "K2": ("flash_kernel", "combine_kernel"),
              "K2b": ("fa_bwd_",),
              "K3": ("ssd_step_kernel", "ssd_tc_kernel", "ssd_fma_kernel"),
              "K3b": ("ssd_bwd_",), "NCCL": ("nccl",)}
    sums = {g: 0.0 for g in list(groups) + ["other"]}
    other = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if not (e.count and t):
            continue
        g = next((g for g, keys in groups.items()
                  if any(s in e.key for s in keys)), "other")
        sums[g] += t / 1e3
        if g == "other":
            other[e.key[:50]] = other.get(e.key[:50], 0.0) + t / 1e3
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return (f"device ms by kernel (profiler, one step): total "
            f"{sum(sums.values()):.1f}; "
            + ", ".join(f"{g} {t:.1f}" for g, t in sums.items())
            + "; largest other: " + "; ".join(f"{n} {t:.1f}"
                                              for n, t in top)), sums


def _model_flops(cfg, rows: int, seq: int) -> float:
    """A train step's model flops over ``rows`` rows of ``seq`` tokens: 6
    flops a token per weight of every product (forward, dA, dB; an MoE
    layer's router and the k experts that a token routes to, not the
    capacity's padding rows, nor remat's second forward), the
    causal attention's 4·h·d a pair its window leaves visible, 3 times
    (forward, K2b's 2.5 rounded up by its recomputed scores), and the SSD
    recurrence's 5·state·hd a step and head, 3 times (forward, backward
    twice the forward, as for a product)."""
    from repro_torch.models.transformer import has_attn, has_mlp, has_ssm
    d, hd, nh, nk = cfg.d_model, cfg.hd, cfg.heads, cfg.kv_heads
    per_layer = 0
    if has_attn(cfg):
        per_layer += d * (nh + 2 * nk) * hd + nh * hd * d
    if has_mlp(cfg):
        per_layer += 3 * d * cfg.d_ff
    if cfg.block == "attn_moe":        # the router and the k experts a token
        m = cfg.moe
        per_layer += d * m.num_experts + m.top_k * 3 * d * m.d_ff_expert
    scan = 0.0
    if has_ssm(cfg):
        s = cfg.ssm
        di = s.heads * s.head_dim
        per_layer += 2 * d * di + 2 * d * s.state + d * s.heads
        scan = 3 * 5.0 * s.state * s.head_dim * s.heads * rows * seq
    weights = cfg.layers * per_layer + d * cfg.vocab
    window = cfg.window or seq
    pairs = sum(min(i + 1, window) for i in range(seq)) if has_attn(cfg) \
        else 0
    return (6.0 * weights * rows * seq
            + 3 * 4.0 * nh * hd * pairs * rows * cfg.layers
            + scan * cfg.layers)


def _train_lens(shapes) -> None:
    """Every row of a training launch at its full length: the lengths the
    timing of its K2 and K2b signatures reads."""
    for sig in shapes["flash_attention_h100"]:
        PAGED_LENS.setdefault(sig, (sig[7],) * sig[1])
    for sig in shapes["flash_attention_bwd_h100"]:
        BWD_LENS.setdefault(sig, (sig[4],) * sig[0])


def _count_reset(kernels) -> None:
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()


def phase_train_llama(gen) -> dict:
    """(b) llama3-8b at full width, ``TRAIN_LAYERS`` of 32 layers, on
    ``TRAIN_RUN``: :func:`train_path`."""
    from repro_torch.configs import get_config
    return train_path("(b)", get_config("llama3_8b"), TRAIN_LAYERS,
                      TRAIN_RUN)


def _widths(cfg) -> str:
    """A config's widths, for a path's first line."""
    out = f"d {cfg.d_model}"
    if cfg.block != "ssm":
        out += (f", {cfg.heads} over {cfg.kv_heads} heads of {cfg.hd}"
                + (f", window {cfg.window}" if cfg.window else ""))
    if cfg.ssm is not None:
        s = cfg.ssm
        out += (f", SSD {s.heads} heads of {s.head_dim}, state {s.state}")
    if cfg.d_ff:
        out += f", ffn {cfg.d_ff}"
    return out + f", vocab {cfg.vocab}"


def train_path(tag: str, full_cfg, layers, run, mesh=None) -> dict:
    """A training main path at full width, ``layers`` of the config's
    layers (None for all): bf16 compute, f32 masters and AdamW state,
    ``run``'s steps on ``SyntheticLM``, every kernel through the dispatch's
    frozen picks (0 cold after ``warm_train_dispatch``); launches a step
    against :func:`_train_counts`; tokens/s, model flops and peak memory;
    with ``run["ckpt_at"]`` a checkpoint after that many steps, restored,
    and the next steps replayed bit for bit; one more step under the
    profiler, its loss equal.  Every launch counter is set to 0 just
    before the path and read just after.  With ``mesh`` the step is the
    mesh's (``build_train_step(..., mesh=)``, the launcher's under
    torchrun), the warm set its keys and the state the rank's part
    (``launch.specs.rank_state``, built leaf by leaf).
    Returns the path's record."""
    import tempfile
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, tree_leaves, warmup_cosine
    from repro_torch.runtime import build_train_step, warm_train_dispatch

    from repro_torch.kernels.workspace import free_unheld
    cfg = full_cfg.scaled(layers=layers) if layers else full_cfg
    depth = (f"{cfg.layers} of {full_cfg.layers} layers (reduced: depth "
             f"only)" if layers else f"{cfg.layers} layers (nothing "
             f"reduced)")
    # every path grows its own split workspaces: the peaks of two paths
    # of one run compare
    torch.cuda.synchronize()
    free_unheld()
    gc.collect()
    torch.cuda.empty_cache()
    stats = get_default_cache().stats
    t0 = time.perf_counter()
    picks = warm_train_dispatch(cfg, global_batch=run["batch"],
                                seq=run["seq"],
                                microbatches=run["microbatches"], mesh=mesh)
    say(f"[train] {tag} warm_train_dispatch: {len(picks)} (family, key) "
        f"pairs frozen in {time.perf_counter() - t0:.2f} s")
    cold0 = stats.cold_builds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the launcher's schedule (launch/train.py)
    opt = adamw(warmup_cosine(run["lr"], 10, run["steps"]))
    if mesh is None:
        params = init_train_state(cfg, seed=0, device=DEV)
        opt_state = opt.init(params)
    else:
        # the launcher's state on a mesh: the rank's part, leaf by leaf
        from repro_torch.launch.specs import rank_state
        params, opt_state, _ = rank_state(cfg, mesh, opt, seed=0,
                                          device=DEV)
    step_fn = build_train_step(cfg, opt, microbatches=run["microbatches"],
                               mesh=mesh)
    n = sum(t.numel() for t in tree_leaves(params))
    state_bytes = _nbytes(params) + _nbytes(opt_state)
    state_gb = state_bytes / 1e9
    say(f"[train] {tag} {cfg.name} at full width ({_widths(cfg)}), "
        f"{depth}, bf16 compute, f32 masters: {n / 1e9:.3f} B parameters; "
        f"state (masters and AdamW's two moments) {state_gb:.2f} GB, with "
        f"f32 gradients {16 * n / 1e9:.2f} GB reckoned")
    ds = SyntheticLM(DataConfig(cfg.vocab, run["seq"], run["batch"],
                                seed=0))
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in ds.batch_at(s).items()}
               for s in range(run["steps"])]
    batch_bytes = _nbytes(batches[0])
    kernels = _counters(TRAIN_KERNELS)
    want = _train_counts(cfg, run["microbatches"])
    ckpt_at = run.get("ckpt_at")
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep=1)
    losses, host, dev_ms = [], [], []
    first = None
    _count_reset(kernels)
    t_run = time.perf_counter()
    for step in range(run["steps"]):
        if step == ckpt_at:
            t0 = time.perf_counter()
            ckpt.save_async(step, (params, opt_state))
            say(f"[train] {tag} checkpoint of step {step}: host copy "
                f"{time.perf_counter() - t0:.2f} s (written in the "
                f"background)")
        c0 = {n_: k.launches for n_, k in kernels.items()}
        params, opt_state, m, h, ev = _step_timed(step_fn, params, opt_state,
                                                  batches[step], step)
        got = {n_: k.launches - c0[n_] for n_, k in kernels.items()}
        if got != want:
            raise AssertionError(f"{cfg.name} step {step} launches {got}, "
                                 f"expected {want}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"{cfg.name} step {step}: non-finite {m}")
        losses.append(m["loss"])
        host.append(h)
        dev_ms.append(ev)
        if step == 0:
            first = m
        say(f"[train] {tag} step {step}: loss {m['loss']!r} nll "
            f"{m['nll']!r} grad_norm {m['grad_norm']!r}; host "
            f"{1e3 * h:.1f} ms, CUDA events {ev:.1f} ms")
    wall = time.perf_counter() - t_run
    launches = {n_: k.launches for n_, k in kernels.items()}
    shapes = {n_: dict(k.shapes) for n_, k in kernels.items()}
    _train_lens(shapes)
    cold = stats.cold_builds - cold0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    tokens = run["batch"] * run["seq"]
    med = sorted(dev_ms[1:])[len(dev_ms[1:]) // 2]
    flops = _model_flops(cfg, run["batch"], run["seq"])
    say(f"[train] {tag} {run['steps']} steps of {run['batch']} x "
        f"{run['seq']} tokens, {run['microbatches']} microbatches: "
        f"{wall:.2f} s; median step (after the first) {med:.1f} ms of "
        f"CUDA-event time, {tokens / med * 1e3:.1f} tokens/s; model flops "
        f"{flops / 1e12:.2f} T a step, {flops / med / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / (med * 1e-3) / _roofline().PEAK_FLOPS[torch.bfloat16]:.2f} % "
        f"of the bf16 dense peak (989 TFLOP/s); peak device memory "
        f"{peak:.2f} GB (torch.cuda.max_memory_allocated; "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved) against "
        f"{16 * n / 1e9:.2f} GB of resident state reckoned (parameters, "
        f"gradients and AdamW's two moments, 16 B a parameter); launches a "
        f"step {json.dumps(want)}; launches {json.dumps(launches)}; cold "
        f"dispatch builds after warm-up: {cold}")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    if not losses[-1] < losses[0]:
        say(f"[train] {tag} note: loss did not fall over {run['steps']} "
            f"steps ({losses[0]!r} -> {losses[-1]!r})")

    if run.get("note"):
        say(f"[train] {tag} {run['note']}")
    if ckpt_at is not None:
        # restart: restore the checkpoint and replay the steps after it
        t0 = time.perf_counter()
        step0, restored = ckpt.restore_latest((params, opt_state))
        restore_s = time.perf_counter() - t0
        if step0 != ckpt_at:
            raise AssertionError(f"restored step {step0}")
        params, opt_state = restored
        del restored
        gc.collect()
        torch.cuda.empty_cache()
        replay = []
        for step in range(step0, run["steps"] - 1):
            params, opt_state, m, _, _ = _step_timed(
                step_fn, params, opt_state, batches[step], step)
            replay.append(m["loss"])
        if replay != losses[step0:run["steps"] - 1]:
            raise AssertionError(f"replayed losses {replay} differ from "
                                 f"{losses[step0:run['steps'] - 1]}")
        say(f"[train] {tag} restart: checkpoint of step {step0} restored "
            f"in {restore_s:.2f} s (read, CRC32, to the card); steps "
            f"{step0}..{run['steps'] - 2} replayed: losses {replay} equal "
            f"the uninterrupted run's bit for bit")
        last = run["steps"] - 1
    else:
        last = run["steps"]
        batches.append({k: torch.from_numpy(v).to(DEV)
                        for k, v in ds.batch_at(last).items()})
    out = {}

    def profiled():
        out["m"] = step_fn(params, opt_state, batches[last], last)[2]

    line, kernel_ms = _profile_step(profiled)
    say(f"[train] {tag} step {last} under torch.profiler: {line}")
    if ckpt_at is not None and float(out["m"]["loss"]) != losses[last]:
        raise AssertionError("the profiled step's loss differs")
    if not math.isfinite(float(out["m"]["loss"])):
        raise AssertionError("the profiled step's loss is not finite")
    del params, opt_state, batches, out
    import shutil
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": f"{cfg.name} training", "wall_ms": 1e3 * wall,
            "launches": launches, "shapes": shapes, "steps": run["steps"],
            "step_ms": med, "peak_gb": peak, "kernel_ms": kernel_ms,
            "profiled_ms": sum(kernel_ms.values()), "first": first,
            "per_step": want, "cold": cold,
            "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "cfg": cfg, "run": run, "state_bytes": state_bytes,
            "batch_bytes": batch_bytes}


def phase_train_whisper(gen, mesh=None, tag: str = "(c)", steps=None
                        ) -> dict:
    """(c) whisper-large-v3 at full width, ``WHISPER_TRAIN``'s layers of
    32 + 32, rows of 1500 seeded frames and 64-token prompts: finite losses
    and step times.  Counters as in (b).  The frames come from a generator
    of their own, so a second run draws the same; with ``mesh`` the step
    is the mesh's and the state the rank's part (as in :func:`train_path`),
    ``steps`` of them (``WHISPER_TRAIN``'s by default)."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, constant
    from repro_torch.runtime import build_train_step, warm_train_dispatch
    import dataclasses
    run = WHISPER_TRAIN
    steps = steps or run["steps"]
    base_cfg = get_config("whisper_large_v3")
    cfg = base_cfg.scaled(layers=run["layers"], encoder=dataclasses.replace(
        base_cfg.encoder, layers=run["layers"]))
    stats = get_default_cache().stats
    warm_train_dispatch(cfg, global_batch=run["batch"], seq=run["seq"],
                        mesh=mesh)
    cold0 = stats.cold_builds
    from repro_torch.kernels.workspace import free_unheld
    torch.cuda.synchronize()
    free_unheld()          # as train_path: the path grows its workspaces
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt = adamw(constant(run["lr"]))
    if mesh is None:
        params = init_train_state(cfg, seed=0, device=DEV)
        opt_state = opt.init(params)
    else:
        from repro_torch.launch.specs import rank_state
        params, opt_state, _ = rank_state(cfg, mesh, opt, seed=0,
                                          device=DEV)
    step_fn = build_train_step(cfg, opt, mesh=mesh)
    ds = SyntheticLM(DataConfig(cfg.vocab, run["seq"], run["batch"],
                                seed=0))
    frames = torch.Generator(device=DEV)
    frames.manual_seed(5)
    state_bytes = _nbytes(params) + _nbytes(opt_state)
    kernels = _counters(TRAIN_KERNELS)
    want = _train_counts(cfg, 1)
    _count_reset(kernels)
    first, dev_ms = None, []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in ds.batch_at(step).items()}
        batch["enc_embeds"] = torch.randn(
            (run["batch"], cfg.encoder.seq_len, cfg.d_model), generator=frames,
            device=DEV).to(getattr(torch, cfg.dtype))
        c0 = {n_: k.launches for n_, k in kernels.items()}
        params, opt_state, m, h, ev = _step_timed(step_fn, params, opt_state,
                                                  batch, step)
        got = {n_: k.launches - c0[n_] for n_, k in kernels.items()}
        if got != want or not math.isfinite(m["loss"]):
            raise AssertionError(f"whisper step {step}: launches {got} "
                                 f"(expected {want}), metrics {m}")
        first = first or m
        dev_ms.append(ev)
        batch_bytes = _nbytes(batch)
        say(f"[train] {tag} {cfg.name}, {cfg.encoder.layers} + {cfg.layers} "
            f"of 32 + 32 layers (reduced: depth only), {run['batch']} rows "
            f"of 1500 frames and {run['seq']} tokens, step {step}: loss "
            f"{m['loss']!r} grad_norm {m['grad_norm']!r}; host "
            f"{1e3 * h:.1f} ms, CUDA events {ev:.1f} ms")
    wall = time.perf_counter() - t0
    launches = {n_: k.launches for n_, k in kernels.items()}
    shapes = {n_: dict(k.shapes) for n_, k in kernels.items()}
    _train_lens(shapes)
    cold = stats.cold_builds - cold0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    say(f"[train] {tag} launches {json.dumps(launches)}; cold dispatch "
        f"builds after warm-up: {cold}; peak device memory {peak:.2f} GB")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": f"{cfg.name} training", "wall_ms": 1e3 * wall,
            "launches": launches, "shapes": shapes, "steps": steps,
            "first": first, "per_step": want, "cold": cold, "peak_gb": peak,
            "step_ms": sorted(dev_ms[1:])[len(dev_ms[1:]) // 2],
            "cfg": cfg, "run": dict(run, microbatches=1),
            "state_bytes": state_bytes, "batch_bytes": batch_bytes}


def phase_train_parity(archs=TRAIN_PARITY) -> None:
    """(d) One f32 train step (AdamW, microbatches 2) of each smoke config
    of ``archs`` on the card against the CPU plain versions from the
    same state: the loss at rtol 1e-5, grad_norm at 1e-4 (sums in another
    order); the updated parameters within 1e-6, but for at most one
    element in a thousand, which may differ by up to 2·lr where its
    gradient rounds to the other sign (AdamW moves every element by about
    ±lr whatever the gradient's size).  Then kimi-k2's smoke config with
    its own optimizer and accumulators (Adafactor, bf16) at the tolerances
    of the CPU test against JAX: grad_norm at 1e-2 (a gradient near a bf16
    rounding boundary rounds to a neighbour), the loss, nll and aux loss
    at 1e-5, the parameters as above."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_train_state
    from repro_torch.optim import constant, make_optimizer, tree_leaves
    from repro_torch.runtime import build_train_step
    lr = 1e-3
    steps = ([(arch, "adamw", torch.float32) for arch in archs]
             + [("kimi_k2_1t_a32b", "adafactor", torch.bfloat16)])
    for arch, optimizer, grad_dtype in steps:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        rng = np.random.default_rng(5)
        seq = 40 if cfg.ssm is not None else 32
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, seq)),
                 "labels": rng.integers(0, cfg.vocab, (4, seq))}
        if cfg.encoder is not None:
            batch["enc_embeds"] = rng.standard_normal(
                (4, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
        out = {}
        for dev in ("cpu", DEV):
            params = _to(init_train_state(cfg, seed=2, device="cpu"), dev)
            opt = make_optimizer(optimizer, constant(lr))
            tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            params, _, m = build_train_step(
                cfg, opt, microbatches=2, grad_dtype=grad_dtype)(
                params, opt.init(params), tb, 0)
            out[dev] = ({k: float(v) for k, v in m.items()},
                        [p.detach().cpu() for p in tree_leaves(params)])
        (gm, gp), (wm, wp) = out[DEV], out["cpu"]
        flips = total = 0
        worst = 0.0
        for g, w in zip(gp, wp):
            diff = (g - w).abs()
            worst = max(worst, float(diff.max()))
            flips += int((diff > 1e-6).sum())
            total += diff.numel()
        bf16 = grad_dtype == torch.bfloat16
        ok = (all(math.isclose(gm[k], wm[k], rel_tol=1e-5, abs_tol=1e-7)
                  for k in ("loss", "nll", "moe_aux"))
              and math.isclose(gm["grad_norm"], wm["grad_norm"],
                               rel_tol=1e-2 if bf16 else 1e-4)
              and worst <= 2 * lr + 1e-6 and flips <= total / 1000)
        kind = (f"{optimizer}, {str(grad_dtype)[6:]} accumulators"
                if bf16 else "f32")
        say(f"[train] (d) {cfg.name} {kind}, one step on the card against "
            f"the CPU: loss {gm['loss']!r} vs {wm['loss']!r}, moe_aux "
            f"{gm['moe_aux']!r} vs {wm['moe_aux']!r}, grad_norm "
            f"{gm['grad_norm']!r} vs {wm['grad_norm']!r}, parameters: "
            f"largest difference {worst:.3e}, {flips} of {total} past 1e-6")
        if not ok:
            raise AssertionError(f"{cfg.name}: the card's train step differs "
                                 "from the CPU's")


def k4b_case(sig, gen, *, timed: bool, plain_timed: bool = True):
    """K4's batched entry at (E, M, N, bm, bn, s, cached, dtype), the
    wrapper's ``shapes`` key: two launches and the plain version bit for
    bit; when ``timed``, eagerly and as device time on copies of the input
    cold to the L2 (as :func:`transpose_case`), beside the byte bound and
    ``a.transpose(1, 2).contiguous()`` (a yardstick), and the plain
    version when ``plain_timed``."""
    from repro_torch.kernels.transpose import (transpose_batched_plain,
                                               transpose_h100_batched)
    E, M, N, bm, bn, s, cached, dtype = sig
    a = torch.randn((E, M, N), generator=gen, device=DEV, dtype=dtype)
    kw = dict(bm=bm, bn=bn, s=s, cached=cached)
    got = transpose_h100_batched(a, **kw)
    again = transpose_h100_batched(a, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"K4b {sig}: two launches differ")
    del again
    row = {"err": exact(f"K4b {sig}", got, transpose_batched_plain(a, **kw))}
    del got
    torch.cuda.empty_cache()
    if not timed:
        return row
    big = a.numel() * a.element_size() >= BIG_OUTPUT
    reps, cold = (2 if big else _k4_graph_reps(a)), _cold_launches(a)
    kernel = cold(lambda x: transpose_h100_batched(x, **kw))
    library = cold(lambda x: x.transpose(1, 2).contiguous())
    time_into(row, "ms", kernel, 2 if big else 10)
    row["device_ms"] = graph_ms(kernel, reps)
    time_into(row, "library_ms", library, 2 if big else 10)
    row["library_device_ms"] = graph_ms(library, reps)
    if plain_timed:
        time_into(row, "plain_ms",
                  cold(lambda x: transpose_batched_plain(x, **kw)), 1)
    row["bound_ms"] = max(bound_terms_ms("transpose_h100_batched", sig))
    torch.cuda.empty_cache()
    return row


CASES["transpose_h100_batched"] = k4b_case


def moe_bwd_keys(arch: str) -> tuple:
    """(K1b signatures, K4b signatures) of an MoE config's expert products
    in a train step over one routing group of 1024 tokens, in bf16, at the
    picks of their per-expert keys: the forward and dA of each product
    (the up projection's forward key is the down projection's dA key and
    back), dB, and the transposes of each product's weights and
    activations."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.moe import capacity
    cfg = get_config(arch)
    m = cfg.moe
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    C = capacity(1024, E, m.top_k, m.capacity_factor)
    bf16 = torch.bfloat16
    k1b = []
    for M, N, K in ((C, f, d), (C, d, f), (d, f, C), (f, d, C)):
        data = {"M": M, "N": N, "K": K}
        k1b.append((E,) + _mm_sig(data, ops.select("matmul_h100", data),
                                  bf16))
    k4b = []
    for M, N in ((d, f), (C, d), (f, d), (C, f)):
        cand = ops.select("transpose_h100", {"M": M, "N": N})
        k4b.append((E, M, N) + _format(ops.FAMILIES["transpose_h100"], cand)
                   + (bf16,))
    return k1b, k4b


def phase_train_moe_kernels(gen) -> tuple:
    """(i) K1's and K4's batched entries at each key of
    ``MOE_BWD_CONFIGS`` (:func:`moe_bwd_keys`): :func:`batched_case`
    and :func:`k4b_case`, each timed, the plain version timed at the keys
    the path (j) runs (the held-out keys' plain versions are checked, not
    timed); returns (largest K1b error, {sig: row}, largest K4b error,
    {sig: row})."""
    k1_err = k4_err = 0.0
    k1_rows, k4_rows = {}, {}
    for arch, held_out in MOE_BWD_CONFIGS:
        k1b, k4b = moe_bwd_keys(arch)
        what = "held out" if held_out else "(j)'s"
        for sig in k1b:
            row = batched_case(sig, gen, timed=True,
                               plain_timed=not held_out)
            k1_rows[sig] = row
            k1_err = max(k1_err, row["err"])
            say(f"[train] (i) K1b {arch} {what} key E {sig[0]} (M, N, K) "
                f"{sig[1:4]}, pick {sig[4:10]}: {fmt(row)}; two launches "
                f"equal bit for bit; device time "
                f"{100 * row['bound_ms'] / row['device_ms']:.1f} % of the "
                f"bound, torch.bmm (bf16 out) "
                f"{row['library_device_ms'] / row['device_ms']:.3f} x its "
                f"device time")
        for sig in k4b:
            row = k4b_case(sig, gen, timed=True, plain_timed=not held_out)
            k4_rows[sig] = row
            k4_err = max(k4_err, row["err"])
            say(f"[train] (i) K4b {arch} {what} key E {sig[0]} (M, N) "
                f"{sig[1:3]}, pick {sig[3:7]}: {fmt(row)}; bit for bit, "
                f"two launches equal; device time "
                f"{100 * row['bound_ms'] / row['device_ms']:.1f} % of the "
                f"byte bound, a.transpose(1, 2).contiguous() "
                f"{row['library_device_ms'] / row['device_ms']:.3f} x its "
                f"device time")
    return k1_err, k1_rows, k4_err, k4_rows


def router_bits_once(gen) -> None:
    """(j)'s router product, (T, E, d) = (1024, 16, 5120) in bf16 through
    ``ops.matmul``, launched twice on the same inputs: equal bit for bit
    (a split pick sums its splits in a fixed order), so the forward that
    ``remat="full"`` runs again in the backward routes the same tokens."""
    from repro_torch.kernels import ops
    x = torch.randn((1024, 5120), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    w = torch.randn((5120, 16), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    one, two = ops.matmul(x, w), ops.matmul(x, w)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError("the router's K1 launches differ")
    pick = dict(ops.select("matmul_h100", {"M": 1024, "N": 16,
                                           "K": 5120}).assignment)
    say(f"[train] (j) the router's K1 product (1024, 16, 5120), pick "
        f"{pick}: two launches equal bit for bit")


def phase_train_llama4(gen) -> dict:
    """(j) llama4-scout at full width, ``LLAMA4_LAYERS`` of 48 layers, on
    ``LLAMA4_TRAIN``: :func:`train_path` (K1b and K4b among its counted
    kernels), after :func:`router_bits_once`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.workspace import free_unheld
    router_bits_once(gen)
    # the 66 GB state and its transients leave a few GB of the card: the
    # split workspaces earlier phases grew (2.4 GB after (i)) go first
    torch.cuda.synchronize()
    freed = free_unheld()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"[train] (j) device memory before the path: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved, "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free (split workspaces "
        f"of {freed / 1e9:.2f} GB dropped)")
    return train_path("(j)", get_config("llama4_scout_17b_a16e"),
                      LLAMA4_LAYERS, LLAMA4_TRAIN)


#: 13 (e): the leaves of K4 timed beside its pick at each training
#: signature, as launch formats (bm, bn, s, cached): 1024, 512 and 256
#: threads a block at 16-byte loads, 8-byte loads, and a wide short tile.
K4_TRAIN_LEAVES = ((32, 32, 8, True), (16, 32, 8, True), (8, 32, 8, True),
                   (16, 64, 8, True), (32, 32, 4, True), (16, 32, 4, True),
                   (8, 64, 4, True), (4, 256, 8, True))


def k4_leaves(sig, gen, label: str) -> dict:
    """K4 at ``sig`` = (M, N, bm, bn, s, cached, dtype), its pick: the pick
    timed as :func:`transpose_case` times it, then the pick and every leaf
    of ``K4_TRAIN_LEAVES`` on one input, each bit for bit and as cold
    device time, with the napkin's rank (H100_SXM) beside the card's.
    Prints one line after ``label``; returns the pick's row with
    ``leaves`` {format: device ms}, ``napkin`` (the formats by score) and
    ``first_over_fastest``."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.kernels.transpose import transpose_h100, transpose_plain
    M, N, dtype = sig[0], sig[1], sig[-1]
    row = transpose_case(sig, gen, timed=True)
    scored = _feasible_formats(ops.FAMILIES["transpose_h100"], H100_SXM,
                               {"M": M, "N": N})
    pick = sig[2:6]
    forms = [pick] + [f for f in K4_TRAIN_LEAVES if f != pick]
    a = torch.randn((M, N), generator=gen, device=DEV).to(dtype)
    cold = _cold_launches(a)
    dev = {}
    for bm, bn, s, cached in forms:
        kw = dict(bm=bm, bn=bn, s=s, cached=cached)
        # new bits each leaf (the sign flipped), so that an output block
        # the allocator hands back from the last leaf cannot already hold
        # the transpose
        a.neg_()
        exact(f"K4 leaf {(bm, bn, s, cached)} at {(M, N)}",
              transpose_h100(a, **kw), transpose_plain(a, **kw))
        dev[(bm, bn, s, cached)] = graph_ms(
            cold(lambda x: transpose_h100(x, **kw)), _k4_graph_reps(a))
    del a, cold
    by_score = sorted(forms, key=lambda f: -scored[f].score)
    by_dev = sorted(forms, key=lambda f: dev[f])
    leaves = "; ".join(
        f"{f[:3]}{'' if f[3] else ' uncached'} {dev[f]:.4f} "
        f"({by_score.index(f) + 1} / {by_dev.index(f) + 1})"
        for f in by_score)
    row.update(leaves=dev, napkin=by_score,
               first_over_fastest=dev[by_score[0]] / dev[by_dev[0]])
    say(f"{label}: pick {pick[:3]}: ms {row['ms']:.4f}, device_ms "
        f"{row['device_ms']:.4f}; byte bound {row['bound_ms']:.4f} ms, "
        f"{100 * row['bound_ms'] / row['device_ms']:.1f} % of it; "
        f"a.t().contiguous() {row['library_ms']:.4f} ms, device "
        f"{row['library_device_ms']:.4f}; a.clone() device "
        f"{row['copy_device_ms']:.4f}, "
        f"{100 * row['bound_ms'] / row['copy_device_ms']:.1f} % of the "
        f"bound; leaves by napkin score, device "
        f"ms (napkin rank / card rank): {leaves}; the napkin's first at "
        f"{row['first_over_fastest']:.3f} x the card's fastest")
    torch.cuda.empty_cache()
    return row


def phase_train_k4(paths, gen) -> dict:
    """(e) K4 at each launch signature of the training paths, bf16:
    launches a step, then :func:`k4_leaves` at the pick.  Returns
    {signature: the pick's row}, which the timing of the training
    signatures keeps."""
    per_step, owner = {}, {}
    for p in paths:
        for sig, n in p["shapes"]["transpose_h100"].items():
            per_step[sig] = per_step.get(sig, 0) + n / p["steps"]
            owner.setdefault(sig, p["name"])
    rows = {}
    for sig in sorted(per_step, key=lambda k: (owner[k], k[:2])):
        rows[sig] = k4_leaves(
            sig, gen, f"[train] (e) K4 {owner[sig]} {sig[:2]} {sig[-1]}: "
                      f"{per_step[sig]:g} launches a step")
    return rows


#: K3b's bf16 body's three kernels, as the profiler names them.
SSD_BWD_KERNELS = ("ssd_bwd_walk_tc_kernel", "ssd_bwd_chunk_tc_kernel",
                   "ssd_bwd_heads_kernel")
#: Keys held out of the napkin's fit (``kernels/ssd_scan_bwd.py``), whose
#: leaves 13 (f) times beside the two training keys': (label, rows, seq,
#: heads, hd, state).
K3B_HELD_OUT = (
    ("mamba2-130m, 2 rows of 2048 (held out)", 2, 2048, 24, 64, 128),
    ("hymba-1.5b, 4 rows of 1024 (held out)", 4, 1024, 25, 64, 16),
    ("ragged seq 1000 (held out)", 2, 1000, 24, 64, 128),
)


def k3b_leaf_rows(label, R, S, H, hd, n, gen) -> float:
    """Every leaf of K3b's tree at one key, bf16, b and c shared, no state
    given, and each chunk the bf16 body takes outside the tree (128: the
    tree stops at the f32 body's 64): each held against the plain
    version (``SSD_BWD_TOL``), two launches bit for bit, timed as CUDA-graph
    device time on copies cold to the L2 and each of its three kernels under
    ``torch.profiler``; printed with the napkin's rank beside the card's
    and the pick's time over the fastest leaf's.  Returns the largest
    error."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels.ssd_scan_bwd import (
        FAMILY, MAX_CHUNK_TC, format_error, ssd_scan_bwd_h100,
        ssd_scan_bwd_plain)
    dtype = torch.bfloat16
    x, dy = (torch.randn((R, S, H, hd), generator=gen, device=DEV).to(dtype)
             for _ in range(2))
    a = torch.sigmoid(torch.randn((R, S, H), generator=gen,
                                  device=DEV)) * 0.9 + 0.05
    b, c = (torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    ranked = rank_candidates(FAMILY, H100_SXM, {"SQ": S, "HD": hd,
                                                "STATE": n})
    leaves = [(cand.assignment["chunk"], cand.score) for cand in ranked]
    outside = [(ck, None) for ck in (MAX_CHUNK_TC,)
               if ck not in dict(leaves) and ck <= S
               and format_error(R, S, H, hd, n, ck, H, dtype) is None]
    cold = _cold_copies((x, a, b, c, dy), sum(
        t.numel() * t.element_size() for t in (x, a, b, c, dy)))
    rows, err = {}, 0.0
    f32 = SSD_BWD_TOL[torch.float32]
    for chunk, score in leaves + outside:
        kw = {"chunk": chunk}

        def launch(x=x, a=a, b=b, c=c, dy=dy):
            return ssd_scan_bwd_h100(x, a, b, c, None, dy, None, **kw)

        got, again = launch()[:4], launch()[:4]
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"K3b leaf {label} {kw}: two launches "
                                 f"differ")
        want = ssd_scan_bwd_plain(x, a, b, c, None, dy, None, **kw)[:4]
        tols = (SSD_BWD_TOL[dtype], f32, SSD_BWD_TOL[dtype],
                SSD_BWD_TOL[dtype])
        e = max(held_rel(f"K3b leaf {label} {kw} {i}", g, w, t)
                for i, (g, w, t) in enumerate(zip(got, want, tols)))
        err = max(err, e)
        del got, again, want
        rows[chunk] = {
            "err": e, "device_ms": graph_ms(lambda: launch(*next(cold)), 5),
            "score": score,
            "us": bwd_kernel_us(launch, names=SSD_BWD_KERNELS)}
    tree = [ck for ck, _ in leaves]
    by_card = sorted(tree, key=lambda k: rows[k]["device_ms"])
    best = rows[by_card[0]]["device_ms"]
    for chunk, row in rows.items():
        split = ("the profiler missed some of its launches"
                 if row["us"] is None else
                 "walk {:.4f}, chunks {:.4f}, heads {:.4f} under the "
                 "profiler".format(*(u / 1e3 for u in row["us"])))
        if chunk in tree:
            i = tree.index(chunk)
            rank = (f"napkin score {row['score']:.4g} rank {i + 1}, card "
                    f"rank {by_card.index(chunk) + 1} of {len(tree)}")
        else:
            rank = (f"outside the tree, {row['device_ms'] / best:.2f}x the "
                    f"fastest leaf")
        say(f"[train] (f) K3b leaf {label} chunk {chunk}"
            f"{' (pick)' if chunk == tree[0] else ''}: device_ms "
            f"{row['device_ms']:.4f} ({split}), err {row['err']:.3e}; "
            f"{rank}")
    say(f"[train] (f) K3b {label}: device_ms pick "
        f"{rows[tree[0]]['device_ms']:.4f}, fastest of {len(tree)} leaves "
        f"{best:.4f} ({rows[tree[0]]['device_ms'] / best:.2f}x)")
    return err


def phase_train_k3b(gen) -> tuple:
    """(f) K3b through the pick of each key of ``SSD_BWD_SIGNATURES`` in
    bf16 (the tensor-core body) and f32 (the FMA body) (:func:`ssd_bwd_case`),
    the first's device time over the second's; then, in a process of its
    own, every leaf at (g)'s and (h)'s keys and the held-out keys in bf16
    (:func:`k3b_leaf_rows`); returns (largest error against the plain
    version, {sig: row})."""
    from repro_torch.kernels import ops
    err, rows = 0.0, {}
    for label, R, S, H, hd, n, ws, wd in SSD_BWD_SIGNATURES:
        pick = ops.select("ssd_scan_bwd_h100", {
            "SQ": S, "HD": hd, "STATE": n}).assignment
        by_type = {}
        for dtype in (torch.bfloat16, torch.float32):
            sig = (R, S, H, hd, n, pick["chunk"], True, ws, wd, dtype)
            row = ssd_bwd_case(sig, gen, timed=True)
            rows[sig] = by_type[dtype] = row
            err = max(err, row["err"])
            say(f"[train] (f) K3b {label}, rows {R}, seq {S}, {H} heads of "
                f"{hd}, state {n}, {dtype}, pick chunk {pick['chunk']}: "
                f"{fmt(row)} autograd_err "
                f"{row['autograd_err']:.3e}; two launches equal bit for "
                f"bit; device time "
                f"{row['bound_ms'] / row['device_ms']:.4f} of the bound, "
                f"{row['bound_f32_ms'] / row['device_ms']:.4f} of the f32 "
                f"bound")
            torch.cuda.empty_cache()
        tc, fma = by_type[torch.bfloat16], by_type[torch.float32]
        say(f"[train] (f) K3b {label}: the bf16 body (tensor cores) "
            f"{tc['device_ms']:.4f} ms of device time, the f32 FMA body "
            f"{fma['device_ms']:.4f} (f32 inputs), ratio "
            f"{tc['device_ms'] / fma['device_ms']:.3f}")
    return max(err, in_child(_k3b_leaf_child, "K3b's leaf tables")), rows


def phase_train(gen) -> tuple:
    """Phase 13, on split workspaces of its own (no engine's graph holds
    them): (a) K2b; (b) llama3-8b training; (c) whisper-large-v3 training;
    (d) the smoke configs' train steps, card against CPU; (f) K3b; (g)
    mamba2-130m training; (h) hymba-1.5b training; (i) K1b and K4b at the
    MoE training keys; (j) llama4-scout training.  Returns (K2b's largest
    error, K2b's rows, the five training paths' records, K3b's largest
    error, K3b's rows, (i)'s errors and rows)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.workspace import scratch
    with scratch():
        t0 = time.perf_counter()
        err, rows = phase_train_k2b(gen)
        say(f"[train] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths = [phase_train_llama(gen)]
        say(f"[train] (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.append(phase_train_whisper(gen))
        say(f"[train] (c) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_train_parity()
        say(f"[train] (d) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ssd_err, ssd_rows = phase_train_k3b(gen)
        say(f"[train] (f) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.append(train_path("(g)", get_config("mamba2_130m"), None,
                                MAMBA_TRAIN))
        say(f"[train] (g) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.append(train_path("(h)", get_config("hymba_1p5b"),
                                HYMBA_LAYERS, HYMBA_TRAIN))
        say(f"[train] (h) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        moe = phase_train_moe_kernels(gen)
        say(f"[train] (i) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.append(phase_train_llama4(gen))
        say(f"[train] (j) {time.perf_counter() - t0:.1f} s")
        for p in paths[2:4]:
            share = {n: p["kernel_ms"][n] / p["profiled_ms"]
                     for n in ("K3", "K3b")}
            say(f"[train] {p['name']}: median step {p['step_ms']:.1f} ms "
                f"(CUDA events), peak {p['peak_gb']:.2f} GB; share of the "
                f"profiled step's device time: " + ", ".join(
                    f"{n} {100 * v:.1f} %" for n, v in share.items()))
        p = paths[4]
        # the profiler names K1's batched launches as K1's (one kernel) and
        # K4b's as K4's
        share = {n: p["kernel_ms"][n] / p["profiled_ms"]
                 for n in ("K1", "K4", "K2", "K2b", "other")}
        say(f"[train] {p['name']}: median step {p['step_ms']:.1f} ms "
            f"(CUDA events), peak {p['peak_gb']:.2f} GB; share of the "
            f"profiled step's device time: " + ", ".join(
                f"{n} {100 * v:.1f} %" for n, v in share.items()))
        torch.cuda.synchronize()
    return err, rows, paths, ssd_err, ssd_rows, moe


# ---------------------------------------------------------------------------
# Phase 14: multi-device at world size 1 (the mesh, the a2a schedule)
# ---------------------------------------------------------------------------

#: 14 (b): the MoE smoke configs under ``moe_a2a``, ten f32 steps each.
MULTI_PARITY = ("llama4_scout_17b_a16e", "kimi_k2_1t_a32b")
MULTI_STEPS = 10


def phase_multi_group(gen):
    """(a) NCCL at world size 1 on a ``file://`` store in a temporary
    directory, the mesh (1, 1) over ("data", "model"); one all-to-all and
    one all-reduce over its a2a group, each bit for bit (at one rank both
    give their input back).  Returns (the mesh, the store's directory)."""
    import tempfile
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    store = tempfile.mkdtemp(prefix="repro_torch_store_")
    t0 = time.perf_counter()
    init_distributed(init_method=f"file://{store}/init", rank=0,
                     world_size=1, backend="nccl")
    mesh = make_mesh((1, 1), ("data", "model"))
    group = mesh.group(("data", "model"))
    x = torch.randn((16 * 80, 5120), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=group)
    y = x.float()
    tdist.all_reduce(y, group=group)
    torch.cuda.synchronize()
    ok = torch.equal(out, x) and torch.equal(y, x.float())
    say(f"[multi] (a) NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} "
        f"at world size {tdist.get_world_size()} (backend "
        f"{tdist.get_backend()}, file:// store), mesh {mesh}: "
        f"all_to_all_single of (1280, 5120) bf16 and all_reduce of it in "
        f"f32 over the a2a group bit for bit: {ok}; "
        f"{time.perf_counter() - t0:.2f} s with the communicator")
    if not ok:
        raise AssertionError("a collective at world size 1 changed its input")
    return mesh, store


def phase_multi_parity() -> None:
    """(b) The MoE smoke configs under ``moe_a2a``, f32 (compute and
    masters), each with its full config's optimizer (llama4's AdamW,
    kimi's Adafactor): ``MULTI_STEPS`` steps of the mesh's step (2 microbatches,
    4 x 32 tokens) on the card over the NCCL mesh, and the same on the CPU
    over a gloo mesh of the same process, from one init.  13 (d)'s
    tolerances: loss, nll and aux at rtol 1e-5 and grad_norm at 1e-4 each
    step; the parameters within 1e-6 but for one element in a thousand,
    which may differ by 2·lr a step (AdamW's sign flips)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_train_state
    from repro_torch.optim import constant, make_optimizer, tree_leaves
    from repro_torch.runtime import build_train_step
    lr = 1e-3
    meshes = {"cpu": make_mesh((1, 1), ("data", "model"), backend="gloo"),
              DEV: make_mesh((1, 1), ("data", "model"))}
    for arch in MULTI_PARITY:
        cfg = get_smoke_config(arch).scaled(
            dtype="float32", param_dtype="float32", perf_flags=("moe_a2a",),
            optimizer=get_config(arch).optimizer)
        rng = np.random.default_rng(7)
        batches = [{k: rng.integers(0, cfg.vocab, (4, 32))
                    for k in ("tokens", "labels")}
                   for _ in range(MULTI_STEPS)]
        out = {}
        for dev in ("cpu", DEV):
            params = _to(init_train_state(cfg, seed=2, device="cpu"), dev)
            opt = make_optimizer(cfg.optimizer, constant(lr))
            state = opt.init(params)
            step_fn = build_train_step(cfg, opt, microbatches=2,
                                       mesh=meshes[dev])
            ms = []
            for i, b in enumerate(batches):
                tb = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                params, state, m = step_fn(params, state, tb, i)
                ms.append({k: float(v) for k, v in m.items()})
            out[dev] = ms, [p.detach().cpu() for p in tree_leaves(params)]
        (gm, gp), (wm, wp) = out[DEV], out["cpu"]
        worst, flips, total = 0.0, 0, 0
        for g, w in zip(gp, wp):
            diff = (g - w).abs()
            worst = max(worst, float(diff.max()))
            flips += int((diff > 1e-6).sum())
            total += diff.numel()
        ok = all(math.isclose(a[k], b[k], rel_tol=1e-5, abs_tol=1e-7)
                 for a, b in zip(gm, wm) for k in ("loss", "nll", "moe_aux")
                 ) and all(math.isclose(a["grad_norm"], b["grad_norm"],
                                        rel_tol=1e-4) for a, b in zip(gm, wm))
        ok = ok and worst <= 2 * lr * MULTI_STEPS + 1e-6 \
            and flips <= total / 1000
        loss_gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(gm, wm))
        say(f"[multi] (b) {cfg.name} moe_a2a, {cfg.optimizer}, "
            f"{MULTI_STEPS} f32 steps of the mesh's step, card (NCCL) "
            f"against CPU (gloo): losses {gm[0]['loss']!r} -> "
            f"{gm[-1]['loss']!r} vs {wm[0]['loss']!r} -> "
            f"{wm[-1]['loss']!r}, largest relative loss gap {loss_gap:.2e},"
            f" moe_aux {gm[-1]['moe_aux']!r} vs {wm[-1]['moe_aux']!r}, "
            f"grad_norm {gm[-1]['grad_norm']!r} vs {wm[-1]['grad_norm']!r};"
            f" parameters: largest difference {worst:.3e}, {flips} of "
            f"{total} past 1e-6")
        if not ok:
            raise AssertionError(f"{cfg.name}: the mesh's step on the card "
                                 "differs from the CPU's")


def a2a_event_ms(mesh, gen, reps: int = 20) -> float:
    """CUDA-event ms of one ``all_to_all`` over the a2a group of (c)'s
    dispatched tensor, (16, 80, 5120) bf16 (E experts, C rows a group, d),
    the median of ``reps`` calls."""
    from repro_torch.distributed.comm import all_to_all
    x = torch.randn((16, 80, 5120), generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    group = mesh.group(("data", "model"))
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        all_to_all(x, group)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def phase_multi_llama4(mesh, gen, ref: dict) -> dict:
    """(c) llama4-scout at full width, 1 of 48 layers, ``moe_a2a`` through
    the launcher's step over the NCCL mesh: (j)'s run (``LLAMA4_TRAIN``,
    the same seed) by :func:`train_path`, after the split workspaces are
    dropped as before (j).  Step 0's loss and grad_norm held to (j)'s at
    rtol 1e-5 and 1e-4 (13 (d)'s; at one rank the routing is (j)'s, so
    they should be equal bit for bit, which is printed); the step's time,
    peak memory and launches beside (j)'s; 0 cold builds; the all-to-all's
    time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.workspace import free_unheld
    torch.cuda.synchronize()
    free_unheld()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"[multi] (c) device memory before the path: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free (NCCL's "
        f"communicator started in (a))")
    cfg = get_config("llama4_scout_17b_a16e").scaled(
        perf_flags=("moe_a2a",))
    rec = train_path("(14 c)", cfg, LLAMA4_LAYERS, LLAMA4_TRAIN, mesh=mesh)
    got, want = rec["first"], ref["first"]
    bits = got["loss"] == want["loss"] and \
        got["grad_norm"] == want["grad_norm"]
    a2a_ms = a2a_event_ms(mesh, gen)
    nccl = rec["kernel_ms"].get("NCCL", 0.0)
    say(f"[multi] (c) step 0 through moe_a2a: loss {got['loss']!r}, "
        f"grad_norm {got['grad_norm']!r}; 13 (j)'s dense step 0: loss "
        f"{want['loss']!r}, grad_norm {want['grad_norm']!r}; bit for bit: "
        f"{bits}")
    say(f"[multi] (c) median step {rec['step_ms']:.1f} ms of CUDA-event "
        f"time against (j)'s {ref['step_ms']:.1f} ms; peak {rec['peak_gb']:.2f}"
        f" GB allocated ({rec['reserved_gb']:.2f} GB reserved) against "
        f"(j)'s {ref['peak_gb']:.2f} GB ({ref['reserved_gb']:.2f} GB); "
        f"launches a step {json.dumps(rec['per_step'])} against (j)'s "
        f"{json.dumps(ref['per_step'])}; cold builds {rec['cold']}; NCCL's "
        f"kernels in the profiled step {nccl:.3f} ms of device time; one "
        f"all-to-all of (16, 80, 5120) bf16 {a2a_ms:.4f} ms (CUDA events, "
        f"median of 20)")
    if not (math.isclose(got["loss"], want["loss"], rel_tol=1e-5)
            and math.isclose(got["grad_norm"], want["grad_norm"],
                             rel_tol=1e-4)):
        raise AssertionError("(c)'s step 0 differs from (j)'s")
    if rec["per_step"] != ref["per_step"] or rec["cold"]:
        raise AssertionError("(c)'s launches or cold builds differ")
    return rec


#: 14 (e): 13 (b)'s llama3-8b run (its batch, full width, 4 of 32
#: layers) through the mesh step; no checkpoint (13 (b) holds the restart).
MESH_LLAMA_RUN = dict(TRAIN_RUN, steps=3, ckpt_at=None)
#: 14 (g): the abstract meshes whose rank keys are warmed and launched.
RANK_MESHES = ((1, 4), (1, 8))
#: 14 (g), (j): (config, layers, mesh, perf flags) of the four-card cells
#: the layout sizes (``Layout.rank_bytes()`` on the meta device; nothing
#: allocated).
CELL_SIZES = (("llama3_8b", None, (1, 4), ()),
              ("llama4_scout_17b_a16e", 4, (4, 1), ("moe_a2a",)),
              ("kimi_k2_1t_a32b", 1, (4, 1), ("moe_a2a",)))
#: 14 (j)'s cells: the SSD-hybrid and whisper under tensor parallelism,
#: kimi-k2's dense MoE layer under expert parallelism.
BLOCK_CELL_SIZES = (("hymba_1p5b", None, (1, 4), ()),
                    ("whisper_large_v3", None, (1, 4), ()),
                    ("kimi_k2_1t_a32b", 1, (4, 1), ()))
#: 14 (h), (i): 13 (g)'s, (h)'s and (j)'s runs through the mesh step, two
#: steps each, no checkpoint (13 (g) holds the restart).
MESH_MAMBA_RUN = dict(MAMBA_TRAIN, steps=2, ckpt_at=None)
MESH_HYMBA_RUN = dict(HYMBA_TRAIN, steps=2)
MESH_LLAMA4_RUN = dict(LLAMA4_TRAIN, steps=2)
#: 14 (j): a dense MoE rank of (4, 1): 8 rows of 1024 tokens in 2
#: microbatches, one row (one routing group) a rank a microbatch: the
#: groups shard over ``data``.
EP_RUN = dict(batch=8, seq=1024, microbatches=2)
#: 14 (j): (config, layers, run, abstract meshes, the families whose
#: launch signatures are timed) of the keys a four-card rank launches.
BLOCK_KEYS = (
    ("mamba2_130m", None, MAMBA_TRAIN, ((1, 4), (1, 8)),
     ("ssd_scan_h100", "ssd_scan_bwd_h100")),
    ("hymba_1p5b", HYMBA_LAYERS, HYMBA_TRAIN, ((1, 4), (1, 8)),
     ("ssd_scan_h100", "ssd_scan_bwd_h100")),
    ("whisper_large_v3", WHISPER_TRAIN["layers"],
     dict(WHISPER_TRAIN, microbatches=1), ((1, 4), (1, 8)),
     ("flash_attention_h100", "flash_attention_bwd_h100")),
    ("llama4_scout_17b_a16e", LLAMA4_LAYERS, EP_RUN, ((4, 1),),
     ("matmul_h100_batched", "transpose_h100_batched")),
    ("kimi_k2_1t_a32b", 1, EP_RUN, ((4, 1),), ("matmul_h100_batched",)))


def same_as_one_card(tag: str, rec: dict, ref: dict, what: str) -> None:
    """(e), (f): a mesh path against the one-card path ``ref`` of the same
    run: step 0's loss and grad_norm bit for bit, the launches a step, 0
    cold builds and the peak allocated within 0.1 GB; the step's time
    beside it."""
    got, want = rec["first"], ref["first"]
    bits = got["loss"] == want["loss"] and \
        got["grad_norm"] == want["grad_norm"]
    gap = rec["peak_gb"] - ref["peak_gb"]
    say(f"[multi] {tag} step 0 through the mesh step: loss {got['loss']!r},"
        f" grad_norm {got['grad_norm']!r}; {what}'s: loss "
        f"{want['loss']!r}, grad_norm {want['grad_norm']!r}; bit for bit: "
        f"{bits}; median step {rec['step_ms']:.1f} ms of CUDA-event time "
        f"against {what}'s {ref['step_ms']:.1f} ms; peak "
        f"{rec['peak_gb']:.2f} GB allocated against {ref['peak_gb']:.2f} "
        f"({gap:+.3f}); launches a step {json.dumps(rec['per_step'])} "
        f"against {json.dumps(ref['per_step'])}; cold builds {rec['cold']}")
    if not bits:
        raise AssertionError(f"{tag}'s step 0 differs from {what}'s")
    if rec["per_step"] != ref["per_step"] or rec["cold"]:
        raise AssertionError(f"{tag}'s launches or cold builds differ")
    if abs(gap) > 0.1:
        raise AssertionError(f"{tag}'s peak is {gap:+.3f} GB off {what}'s")


def layout_line(cfg, mesh) -> str:
    """What a mesh's layout does to ``cfg``'s state: the parameter leaves
    whose specs name the batch axes (FSDP) and ``model``, the
    optimizer-state leaves whose specs name the batch axes, and
    ``Layout.rank_bytes()`` against the whole state."""
    from repro_torch.distributed import sharding as dist
    from repro_torch.launch.specs import abstract_state, state_layout
    from repro_torch.optim import constant, make_optimizer
    opt = make_optimizer(cfg.optimizer, constant(1e-4))
    p_meta, o_meta = abstract_state(cfg, opt)
    lay = state_layout(cfg, mesh, p_meta, o_meta)
    batch = set(dist.batch_axes(mesh))

    def axes(spec):
        return {a for e in spec for a in dist.entry_axes(e)}
    fsdp = sum(1 for p, sp in lay.specs.items() if p[0] == 0
               and axes(sp) & batch and "moe" not in p)
    tp = sum(1 for p, sp in lay.specs.items() if p[0] == 0
             and "model" in axes(sp) and "moe" not in p)
    zero = sum(1 for p, sp in lay.specs.items() if p[0] == 1
               and axes(sp) & batch)
    whole = sum(int(np.prod(sh)) * lay.itemsizes[p]
                for p, sh in lay.shapes.items())
    return (f"{cfg.name} ({cfg.layers} layers, {cfg.optimizer}) on {mesh}: "
            f"{fsdp} parameter leaves over the batch axes (FSDP), {tp} over "
            f"model, {zero} optimizer-state leaves over the batch axes "
            f"(ZeRO-1 or FSDP); "
            f"a rank holds {lay.rank_bytes() / 1e9:.2f} of "
            f"{whole / 1e9:.2f} GB (parameters "
            f"{lay.part(0).rank_bytes() / 1e9:.2f}, optimizer state "
            f"{lay.part(1).rank_bytes() / 1e9:.2f})")


def phase_multi_llama3(mesh, ref: dict) -> dict:
    """(e) 13 (b)'s llama3-8b run (full width, 4 of 32 layers, its batch)
    through the mesh step over the NCCL mesh, its tensor parallelism and
    ZeRO-1 on the (1, 1) mesh (every spec whole at one rank):
    :func:`same_as_one_card` against 13 (b), after the split
    workspaces are dropped as before 13 (b) (they grow inside both)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.workspace import free_unheld
    torch.cuda.synchronize()
    free_unheld()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3_8b")
    say(f"[multi] (e) {layout_line(cfg.scaled(layers=TRAIN_LAYERS), mesh)}")
    rec = train_path("(14 e)", cfg, TRAIN_LAYERS, MESH_LLAMA_RUN, mesh=mesh)
    same_as_one_card("(e)", rec, ref, "13 (b)")
    return rec


def _rank_launches(op, gen, cfg=None, rows: int = 4, heads=None,
                   experts=None) -> None:
    """What the model launches for a traced forward key of a train step,
    as ``layers.proj``, ``layers._rows_attention``, ``layers.ssm_block``
    and ``moe.experts_swiglu`` launch it while autograd records: K1 at
    (M, N, K) bf16 through ``MatmulFn`` and its backward (K1's dA and dB,
    K4's transposes), and at an expert site over ``experts`` experts
    through ``BatchedMatmulFn`` (K1's and K4's batched entries); K2 at
    (SQ, HD, GROUP, HK) through ``AttentionFn`` over ``rows`` rows, and
    K2b: causal over SQ keys (``cfg``'s window), non-causal in whisper's
    encoder and over its 1500 frames in the cross-attention; K3 at (SQ,
    HD, STATE) over ``heads`` heads through ``SsdScanFn``, and K3b."""
    from repro_torch.kernels.autograd import (AttentionFn, BatchedMatmulFn,
                                              MatmulFn, SsdScanFn)
    d = op.data_dict()
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV,
                           dtype=bf16).requires_grad_()

    fwd = [s for s in op.sites
           if not s.endswith((".dA", ".dB", ".wT", ".xT", ".bwd"))]
    if op.family == "matmul_h100":
        M, N, K = d["M"], d["N"], d["K"]
        if any(".moe.expert_" in s for s in fwd):
            BatchedMatmulFn.apply(randn(experts, M, K),
                                  randn(experts, K, N)).sum().backward()
        if any(".moe.expert_" not in s for s in fwd):
            MatmulFn.apply(randn(M, K), randn(K, N)).backward(torch.ones(
                (M, N), device=DEV, dtype=torch.float32))
    elif op.family == "ssd_scan_h100":
        S, hd, n = d["SQ"], d["HD"], d["STATE"]
        a = torch.rand((rows, S, heads), generator=gen, device=DEV)
        a = (0.05 + 0.9 * a).requires_grad_()
        y, _ = SsdScanFn.apply(randn(rows, S, heads, hd), a,
                               randn(rows, S, n), randn(rows, S, n), None,
                               None, None, None)
        y.float().sum().backward()
    else:
        S = d["SQ"]
        h, hk = d["GROUP"] * d["HK"], d["HK"]
        kinds = {(".xattn." not in s and ".encode." not in s,
                  cfg.encoder.seq_len if ".xattn." in s else S)
                 for s in fwd} if cfg is not None else {(True, S)}
        for causal, sk in sorted(kinds):
            window = cfg.window if cfg is not None and causal else None
            q = randn(rows, h, S, d["HD"])
            k, v = randn(rows, sk, hk, d["HD"]), randn(rows, sk, hk, d["HD"])
            lens = torch.full((rows,), sk, dtype=torch.int32, device=DEV)
            AttentionFn.apply(q, k, v, None, lens, causal,
                              window).sum().backward()


def phase_multi_keys(gen) -> dict:
    """(g) The keys a four-card rank launches: llama3-8b at full width,
    13 (b)'s batch, on the abstract meshes ``RANK_MESHES`` (a rank of
    model 4 and 8); ``warm_train_dispatch(mesh=)`` freezes the rank's
    keys, every traced forward key is launched as the model launches it
    (its backward too) with no cold build, and every launch signature is
    then held against its plain version at its tolerance on cold inputs
    and timed beside ``torch.matmul``, ``a.t().contiguous()`` or SDPA
    (:data:`CASES`).  Then ``Layout.rank_bytes()`` of the four-card
    cells (:data:`CELL_SIZES`).  These launches check kernels: no main
    path's.  Returns {name: {sig: row}}."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.plans.trace import trace_train_warm_set
    from repro_torch.runtime import warm_train_dispatch
    cfg = get_config("llama3_8b").scaled(layers=TRAIN_LAYERS)
    kernels = _counters(("matmul_h100", "transpose_h100",
                         "flash_attention_h100", "flash_attention_bwd_h100"))
    stats = get_default_cache().stats
    sigs = {n: {} for n in kernels}
    run = dict(global_batch=TRAIN_RUN["batch"], seq=TRAIN_RUN["seq"],
               microbatches=TRAIN_RUN["microbatches"])
    for shape in RANK_MESHES:
        mesh = abstract_mesh(shape, ("data", "model"))
        t0 = time.perf_counter()
        warm_train_dispatch(cfg, mesh=mesh, **run)
        ops_ = trace_train_warm_set(cfg, mesh=mesh, **run)
        fwd = [op for op in ops_ if any(
            not s.endswith((".dA", ".dB", ".wT", ".xT", ".bwd"))
            for s in op.sites)]
        cold0 = stats.cold_builds
        _count_reset(kernels)
        for op in fwd:
            _rank_launches(op, gen)
        torch.cuda.synchronize()
        cold = stats.cold_builds - cold0
        for n, k in kernels.items():
            for sig, c in k.shapes.items():
                sigs[n][sig] = sigs[n].get(sig, 0) + c
        keys = sorted(f"{op.family.replace('_h100', '')} "
                      f"{dict(op.data)}" for op in fwd)
        say(f"[multi] (g) mesh {shape}: {len(ops_)} (family, key) pairs "
            f"traced and frozen, {len(fwd)} forward keys launched with "
            f"their backwards in {time.perf_counter() - t0:.2f} s; cold "
            f"builds {cold}; forward keys: {'; '.join(keys)}")
        if cold:
            raise AssertionError(f"(g) {shape}: {cold} cold builds")
    _count_reset(kernels)
    _train_lens(sigs)
    rows = {}
    for n, by_sig in sigs.items():
        rows[n] = {}
        for sig in sorted(by_sig, key=str):
            row = CASES[n](sig, gen, timed=True)
            rows[n][sig] = row
            say(f"[multi] (g) {n} {sig[:-1]}: {fmt(row)}")
            torch.cuda.empty_cache()
    _count_reset(kernels)
    cell_lines("(g)", CELL_SIZES)
    return rows


def cell_lines(tag: str, cells) -> None:
    """:func:`layout_line` of each four-card cell of ``cells``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import abstract_mesh
    for arch, layers, shape, flags in cells:
        c = get_config(arch)
        c = c.scaled(layers=layers, perf_flags=flags) if layers else \
            c.scaled(perf_flags=flags)
        cell = abstract_mesh(shape, ("data", "model"))
        say(f"[multi] {tag} four-card cell: {layout_line(c, cell)}")


def phase_multi_blocks(gen, mesh, refs: list) -> list:
    """(h) 13 (g)'s mamba2-130m, (h)'s hymba-1.5b and (c)'s
    whisper-large-v3 runs through the mesh step over the NCCL mesh, two
    steps each; (i) 13 (j)'s llama4-scout run (no ``moe_a2a``: the dense
    MoE layer's expert-parallel code) through it: each by
    :func:`same_as_one_card` against its phase 13 record (``refs``:
    phase 13's training paths, in order (b), (c), (g), (h), (j)).
    Returns the four records."""
    from repro_torch.configs import get_config
    recs = []
    for arch, layers, run, ref, what in (
            ("mamba2_130m", None, MESH_MAMBA_RUN, refs[2], "13 (g)"),
            ("hymba_1p5b", HYMBA_LAYERS, MESH_HYMBA_RUN, refs[3], "13 (h)")):
        t0 = time.perf_counter()
        rec = train_path("(14 h)", get_config(arch), layers, run, mesh=mesh)
        same_as_one_card(f"(h) {arch}", rec, ref, what)
        say(f"[multi] (h) {arch} {time.perf_counter() - t0:.1f} s")
        recs.append(rec)
    t0 = time.perf_counter()
    rec = phase_train_whisper(gen, mesh=mesh, tag="(14 h)")
    same_as_one_card("(h) whisper_large_v3", rec, refs[1], "13 (c)")
    say(f"[multi] (h) whisper_large_v3 {time.perf_counter() - t0:.1f} s")
    recs.append(rec)
    t0 = time.perf_counter()
    rec = train_path("(14 i)", get_config("llama4_scout_17b_a16e"),
                     LLAMA4_LAYERS, MESH_LLAMA4_RUN, mesh=mesh)
    same_as_one_card("(i)", rec, refs[4], "13 (j)")
    say(f"[multi] (i) {time.perf_counter() - t0:.1f} s")
    recs.append(rec)
    return recs


def phase_multi_block_keys(gen) -> dict:
    """(j) The keys a four-card rank of this slice's blocks launches
    (:data:`BLOCK_KEYS`): each config at full width on its abstract
    meshes, ``warm_train_dispatch(mesh=)`` freezing the rank's keys, every
    traced forward key launched as the model launches it (its backward
    too; an SSD scan at the rank's heads, ``layers.ssm_tp_plan``; the
    experts at the rank's E / data of them) with no cold build; then each
    launch signature of the families the config names held against its
    plain version at its tolerance on cold inputs and timed beside its
    library call.  Then ``Layout.rank_bytes()`` of
    :data:`BLOCK_CELL_SIZES`.  These launches check kernels: no main
    path's.  Returns {name: {sig: row}}."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.layers import ssm_tp_plan
    from repro_torch.plans.trace import trace_train_warm_set
    from repro_torch.runtime import warm_train_dispatch
    import dataclasses
    kernels = _counters(TRAIN_KERNELS)
    stats = get_default_cache().stats
    rows = {n: {} for n in kernels}
    for arch, layers, run, shapes, timed in BLOCK_KEYS:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.scaled(layers=layers)
        if cfg.encoder is not None:
            cfg = cfg.scaled(encoder=dataclasses.replace(cfg.encoder,
                                                         layers=layers))
        kw = dict(global_batch=run["batch"], seq=run["seq"],
                  microbatches=run["microbatches"])
        for shape in shapes:
            mesh = abstract_mesh(shape, ("data", "model"))
            t0 = time.perf_counter()
            warm_train_dispatch(cfg, mesh=mesh, **kw)
            ops_ = trace_train_warm_set(cfg, mesh=mesh, **kw)
            fwd = [op for op in ops_ if any(
                not s.endswith((".dA", ".dB", ".wT", ".xT", ".bwd"))
                for s in op.sites)]
            t, n = shape[1], shape[0]
            heads = experts = None
            if cfg.ssm is not None:
                plan = ssm_tp_plan(cfg, t, 0)
                heads = plan["h1"] - plan["h0"] if plan else cfg.ssm.heads
            if cfg.moe is not None:
                E = cfg.moe.num_experts
                experts = E // n if E % n == 0 else E
            R = run["batch"] // run["microbatches"] // n
            cold0 = stats.cold_builds
            _count_reset(kernels)
            for op in fwd:
                _rank_launches(op, gen, cfg, rows=R, heads=heads,
                               experts=experts)
            torch.cuda.synchronize()
            cold = stats.cold_builds - cold0
            sigs = {name: dict(k.shapes) for name, k in kernels.items()}
            _count_reset(kernels)
            _train_lens(sigs)
            keys = sorted(f"{op.family.replace('_h100', '')} "
                          f"{dict(op.data)}" for op in fwd
                          if op.family != "matmul_h100"
                          or any(".moe." in s for s in op.sites))
            say(f"[multi] (j) {cfg.name} on {shape}: {len(ops_)} (family, "
                f"key) pairs traced and frozen, {len(fwd)} forward keys "
                f"launched with their backwards in "
                f"{time.perf_counter() - t0:.2f} s"
                + (f", SSD heads a rank {heads} of {cfg.ssm.heads}"
                   if heads else "")
                + (f", experts a rank {experts} of {cfg.moe.num_experts}"
                   if experts else "")
                + f"; cold builds {cold}; keys beside K1's: "
                + "; ".join(keys))
            if cold:
                raise AssertionError(f"(j) {cfg.name} {shape}: {cold} cold "
                                     "builds")
            for name in timed:
                for sig in sorted(sigs[name], key=str):
                    if sig not in rows[name]:
                        rows[name][sig] = CASES[name](sig, gen, timed=True)
                        say(f"[multi] (j) {cfg.name} {name} {sig[:-1]}: "
                            f"{fmt(rows[name][sig])}")
                        torch.cuda.empty_cache()
    cell_lines("(j)", BLOCK_CELL_SIZES)
    return rows


def phase_multi(gen, refs: list, kimi_tokens) -> tuple:
    """Phase 14, on split workspaces of its own: (a) the NCCL group and
    mesh; (b) the MoE smoke configs' mesh step, card against CPU; (c)
    llama4-scout's training through the a2a at full width, on the layout
    the mesh step realises (FSDP over the batch axes, ZeRO-1), which (f)
    holds to (j); (e) llama3-8b's training through the mesh step, held to
    13 (b); (g) a four-card rank's keys; (h) the SSD, hybrid and whisper
    training paths and (i) llama4-scout's dense MoE one through the mesh
    step, held to phase 13's (``refs``: its training paths (b), (c), (g),
    (h), (j)); (j) a four-card rank's keys of those blocks; (d) kimi-k2
    served from padded expert storage, its tokens phase 8's.  Returns
    ((c)'s, (e)'s, (h)'s and (i)'s training path records, (d)'s serve
    path record, (g)'s and (j)'s rows)."""
    import shutil
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.kernels.workspace import scratch
    with scratch():
        t0 = time.perf_counter()
        mesh, store = phase_multi_group(gen)
        say(f"[multi] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_multi_parity()
        say(f"[multi] (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        llama4_ref, llama3_ref = refs[4], refs[0]
        llama4 = phase_multi_llama4(mesh, gen, llama4_ref)
        say(f"[multi] (c) {time.perf_counter() - t0:.1f} s")
        # (f): (c) ran llama4-scout under its FSDP rules and ZeRO-1 (the
        # mesh step realises every spec): held to (j)
        cfg = get_config("llama4_scout_17b_a16e").scaled(
            layers=LLAMA4_LAYERS, perf_flags=("moe_a2a",))
        say(f"[multi] (f) {layout_line(cfg, mesh)}")
        same_as_one_card("(f)", llama4, llama4_ref, "13 (j)")
        t0 = time.perf_counter()
        llama3 = phase_multi_llama3(mesh, llama3_ref)
        say(f"[multi] (e) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        keys = phase_multi_keys(gen)
        say(f"[multi] (g) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        blocks = phase_multi_blocks(gen, mesh, refs)
        say(f"[multi] (h), (i) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, by_sig in phase_multi_block_keys(gen).items():
            keys.setdefault(name, {}).update(by_sig)
        say(f"[multi] (j) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve = phase_serve("kimi_k2_1t_a32b", NEW_KW, NEW_LENS, layers=1,
                        padded=True)
    same = serve["tokens"] == kimi_tokens
    say(f"[multi] (d) kimi-k2 from 512 stored experts: tokens equal phase "
        f"8's, request for request: {same}; peak {serve['peak_gib']:.2f} "
        f"GiB; {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("padded storage changed kimi-k2's tokens")
    tdist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)
    return [llama4, llama3] + blocks, serve, keys


# ---------------------------------------------------------------------------
# Phase 15: the dry run against the card; the serve steps over a mesh
# ---------------------------------------------------------------------------

#: 15 (c): llama4-scout under ``moe_a2a`` on a rank of (pod, data, model)
#: = (2, 2, 1): 14 (j)'s run (one routing group a rank a microbatch), the
#: groups over ("data", "model") and every pod routing them all.
POD_MESH = (2, 2, 1)
#: 15 (d): llama3-8b at full width (32 layers) through the non-paged
#: steps, one card and the mesh (1, 1): prompts, cache, decode steps.
MESH_SERVE_RUN = dict(batch=4, prompt_len=16, max_len=64, steps=8)


def _dry_shape(run: dict):
    from repro_torch.models.config import ShapeConfig
    return ShapeConfig("phase-15", run["seq"], run["batch"], "train")


def _dry_line(tag: str, name: str, rec: dict) -> str:
    r, c = rec["roofline"], rec["collectives"]
    by_op = ", ".join(f"{op} {b / 1e9:.4f}" for op, b in
                      r["collective_bytes_by_op"].items()) or "none"
    return (f"[dryrun] {tag} {name} on {rec['devices']} rank(s): "
            f"argument_bytes {rec['memory']['argument_bytes']} "
            f"({rec['memory']['argument_bytes'] / 1e9:.2f} GB), flops "
            f"{rec['cost']['flops']:.4g}, bytes {rec['cost']['bytes_accessed']:.4g}; "
            f"collective GB a step by op (ring model) {by_op} "
            f"({c['weighted_bytes'] / 1e9:.4f} in all, "
            f"{r['collective_run']}); roofline on h100_sxm (datasheet): "
            f"compute {1e3 * r['compute_s']:.3f} ms, memory "
            f"{1e3 * r['memory_s']:.3f} ms, collective "
            f"{1e3 * r['collective_s']:.3f} ms, bound "
            f"{1e3 * r['bound_s']:.3f} ms")


def phase_dry_training(refs: list) -> None:
    """(a) Each training path phases 13 and 14 run at world size 1 (13
    (b), (c), (g), (h), (j); ``refs``) through the dry run on the mesh (1,
    1): its ``argument_bytes`` equal the bytes of the state and the batch
    the card held, and each family's launches a step equal phase 13's
    counters (exact; a failure raises); the roofline's bound beside the
    measured step, the measured peak beside ``argument_bytes``."""
    from repro_torch.launch.dryrun import cell_record
    for ref in refs:
        cfg, run = ref["cfg"], ref["run"]
        rec = cell_record(cfg, _dry_shape(run), (1, 1),
                          microbatches=run.get("microbatches", 1))
        held = ref["state_bytes"] + ref["batch_bytes"]
        got = {f: row["launches"] for f, row in
               rec["cost"]["by_family"].items()}
        want = {f: n for f, n in ref["per_step"].items() if n}
        say(_dry_line("(a)", ref["name"], rec))
        say(f"[dryrun] (a) {ref['name']}: argument_bytes "
            f"{rec['memory']['argument_bytes']} against {held} held "
            f"(state {ref['state_bytes']}, batch {ref['batch_bytes']}); "
            f"launches a step {json.dumps(got)} against phase 13's "
            f"{json.dumps(want)}; bound {1e3 * rec['roofline']['bound_s']:.2f}"
            f" ms against the measured median step {ref['step_ms']:.2f} ms "
            f"({100 * 1e3 * rec['roofline']['bound_s'] / ref['step_ms']:.1f}"
            f" %); peak allocated {ref['peak_gb']:.2f} GB "
            f"(torch.cuda.max_memory_allocated) beside argument_bytes "
            f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB")
        if rec["memory"]["argument_bytes"] != held:
            raise AssertionError(f"(a) {ref['name']}: argument_bytes "
                                 f"{rec['memory']['argument_bytes']} != "
                                 f"{held} held on the card")
        if got != want:
            raise AssertionError(f"(a) {ref['name']}: the dry run's "
                                 f"launches {got} != phase 13's {want}")


def phase_dry_cells() -> None:
    """(b) The four-card cells (:data:`CELL_SIZES`,
    :data:`BLOCK_CELL_SIZES`) through the dry run at their phase 14 runs:
    rank bytes (equal to :func:`layout_line`'s ``Layout.rank_bytes()``),
    collective bytes a step by op and the roofline's terms: the
    prediction the four-card benchmark will test."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_record, mesh_of
    from repro_torch.launch.specs import abstract_state, state_layout
    from repro_torch.optim import constant, make_optimizer
    import dataclasses
    runs = {"llama3_8b": TRAIN_RUN, "hymba_1p5b": HYMBA_TRAIN,
            "whisper_large_v3": dict(WHISPER_TRAIN, microbatches=1)}
    for arch, layers, shape, flags in CELL_SIZES + BLOCK_CELL_SIZES:
        cfg = get_config(arch).scaled(perf_flags=flags)
        if layers:
            cfg = cfg.scaled(layers=layers)
            if cfg.encoder is not None:
                cfg = cfg.scaled(encoder=dataclasses.replace(
                    cfg.encoder, layers=layers))
        run = runs.get(arch, EP_RUN)
        rec = cell_record(cfg, _dry_shape(run), shape,
                          microbatches=run["microbatches"])
        opt = make_optimizer(cfg.optimizer, constant(1e-4))
        p_meta, o_meta = abstract_state(cfg, opt)
        mesh = mesh_of(shape)
        state = state_layout(cfg, mesh, p_meta, o_meta).rank_bytes()
        # the rank's rows: int32 tokens and labels, whisper's bf16 frames
        rows = run["batch"] // mesh.axis_size(
            [a for a in ("pod", "data") if a in mesh.axis_names])
        batch = 2 * 4 * rows * run["seq"] + (
            2 * rows * cfg.encoder.seq_len * cfg.d_model
            if cfg.encoder is not None else 0)
        say(_dry_line("(b)", f"{cfg.name} ({cfg.layers} layers"
                      f"{', ' + ','.join(flags) if flags else ''}) {shape}",
                      rec)
            + f"; rank bytes {state} ({state / 1e9:.2f} GB, "
            f"Layout.rank_bytes()) and the rank's batch {batch}")
        if rec["memory"]["argument_bytes"] != state + batch:
            raise AssertionError(f"(b) {cfg.name} {shape}: argument_bytes "
                                 f"{rec['memory']['argument_bytes']} is not "
                                 f"the layout's {state} and the batch's "
                                 f"{batch}")


def phase_dry_pod_keys(gen) -> dict:
    """(c) The keys a rank of :data:`POD_MESH` launches for llama4-scout
    (full width, ``LLAMA4_LAYERS`` layers) under ``moe_a2a``, warmed on
    the abstract mesh: every traced forward key launched as the model
    launches it (its backward too; the experts at the rank's E_l of the
    16, the router at the rank's tokens of the whole batch) with no cold
    build, then each K1b launch signature held against its plain version
    and timed.  These launches check kernels: no main path's.  Returns
    {name: {sig: row}}."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.moe import a2a_padded_experts
    from repro_torch.plans.trace import trace_train_warm_set
    from repro_torch.runtime import warm_train_dispatch
    cfg = get_config("llama4_scout_17b_a16e").scaled(
        layers=LLAMA4_LAYERS, perf_flags=("moe_a2a",))
    mesh = abstract_mesh(POD_MESH, ("pod", "data", "model"))
    kw = dict(global_batch=EP_RUN["batch"], seq=EP_RUN["seq"],
              microbatches=EP_RUN["microbatches"])
    kernels = _counters(TRAIN_KERNELS)
    stats = get_default_cache().stats
    t0 = time.perf_counter()
    warm_train_dispatch(cfg, mesh=mesh, **kw)
    ops_ = trace_train_warm_set(cfg, mesh=mesh, **kw)
    fwd = [op for op in ops_ if any(
        not s.endswith((".dA", ".dB", ".wT", ".xT", ".bwd"))
        for s in op.sites)]
    n_dev = POD_MESH[1] * POD_MESH[2]
    experts = -(-a2a_padded_experts(cfg) // n_dev)
    shards = POD_MESH[0] * POD_MESH[1]
    R = EP_RUN["batch"] // EP_RUN["microbatches"] // shards
    cold0 = stats.cold_builds
    _count_reset(kernels)
    for op in fwd:
        _rank_launches(op, gen, cfg, rows=R, experts=experts)
    torch.cuda.synchronize()
    cold = stats.cold_builds - cold0
    sigs = {name: dict(k.shapes) for name, k in kernels.items()}
    _count_reset(kernels)
    _train_lens(sigs)
    keys = sorted(f"{op.family.replace('_h100', '')} {dict(op.data)}"
                  for op in fwd if any(".moe." in s for s in op.sites))
    say(f"[dryrun] (c) {cfg.name} under moe_a2a on {POD_MESH} (pod, data, "
        f"model): {len(ops_)} (family, key) pairs traced and frozen, "
        f"{len(fwd)} forward keys launched with their backwards in "
        f"{time.perf_counter() - t0:.2f} s, experts a rank {experts} of "
        f"{cfg.moe.num_experts}; cold builds {cold}; MoE keys: "
        + "; ".join(keys))
    if cold:
        raise AssertionError(f"(c) {POD_MESH}: {cold} cold builds")
    rows = {"matmul_h100_batched": {}}
    for sig in sorted(sigs["matmul_h100_batched"], key=str):
        row = CASES["matmul_h100_batched"](sig, gen, timed=True)
        rows["matmul_h100_batched"][sig] = row
        say(f"[dryrun] (c) matmul_h100_batched {sig[:-1]}: {fmt(row)}")
        torch.cuda.empty_cache()
    if not rows["matmul_h100_batched"]:
        raise AssertionError("(c) no K1b launch at the pod mesh's keys")
    return rows


def phase_dry_serve() -> None:
    """(d) llama3-8b at full width (32 layers, bf16 weights) through the
    non-paged steps on one card and through ``build_serve_steps(cfg,
    mesh)`` over an NCCL mesh (1, 1) (a communicator of its own):
    ``MESH_SERVE_RUN``'s prefill and decode logits bit for bit, the same
    launches, 0 cold builds after ``warm_steps_dispatch``.  Every launch
    counter is set to 0 just before each run and read just after."""
    import shutil
    import tempfile
    import torch.distributed as tdist
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import init_train_state
    from repro_torch.models.transformer import init_cache
    from repro_torch.runtime.steps import (build_serve_steps, greedy_sample,
                                           rank_cache, warm_steps_dispatch)
    run = MESH_SERVE_RUN
    cfg = get_config("llama3_8b").scaled(param_dtype="bfloat16")
    store = tempfile.mkdtemp(prefix="repro_torch_store_")
    init_distributed(init_method=f"file://{store}/init", rank=0,
                     world_size=1, backend="nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        params = init_train_state(cfg, seed=0, device=DEV)
        B, S, L = run["batch"], run["prompt_len"], run["max_len"]
        warm_steps_dispatch(cfg, batch=B, prompt_len=S, max_len=L)
        tokens = torch.randint(0, cfg.vocab, (B, S), device=DEV,
                               generator=torch.Generator(device=DEV)
                               .manual_seed(11), dtype=torch.int32)
        kernels = _counters(SERVE_KERNELS)
        stats = get_default_cache().stats
        out = {}
        for tag, m in (("one card", None), ("mesh (1, 1)", mesh)):
            pre, dec = build_serve_steps(cfg, m)
            cache = (init_cache(cfg, B, L, device=DEV) if m is None else
                     rank_cache(cfg, m, B, L, device=DEV))
            cold0 = stats.cold_builds
            _count_reset(kernels)
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = pre(params, tokens, cache)
                steps = [logits]
                tok = greedy_sample(logits)
                for i in range(run["steps"]):
                    logits, cache = dec(params, tok, cache,
                                        torch.tensor(S + i, device=DEV))
                    steps.append(logits)
                    tok = greedy_sample(logits)
            torch.cuda.synchronize()
            launches = {n: k.launches for n, k in kernels.items()}
            out[tag] = (torch.stack(steps), launches,
                        stats.cold_builds - cold0,
                        time.perf_counter() - t0)
            del cache
        (a, la, ca, sa), (b, lb, cb, sb) = out["one card"], \
            out["mesh (1, 1)"]
        same = torch.equal(a, b)
        say(f"[dryrun] (d) {cfg.name} at full width ({cfg.layers} layers, "
            f"bf16 weights): prefill of {B} x {S} and {run['steps']} decode "
            f"steps, one card against the mesh (1, 1) serve steps: logits "
            f"bit for bit {same}; launches {json.dumps(la)} against "
            f"{json.dumps(lb)}; cold builds {ca} and {cb}; wall "
            f"{sa:.2f} and {sb:.2f} s")
        if not same or la != lb or ca or cb:
            raise AssertionError("(d) the mesh serve steps differ from the "
                                 "one-card steps")
        if not all(lb[n] for n in ("matmul_h100", "flash_attention_h100")):
            raise AssertionError(f"(d) a kernel of the path did not launch: "
                                 f"{lb}")
        del params
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_dryrun(gen, refs: list) -> dict:
    """Phase 15: (a) phase 13's training paths (``refs``) against their
    dry runs, (b) the four-card cells' dry runs, (c) a pod mesh's keys
    under ``moe_a2a``, (d) the mesh serve steps.  Returns (c)'s rows."""
    t0 = time.perf_counter()
    phase_dry_training(refs)
    say(f"[dryrun] (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dry_cells()
    say(f"[dryrun] (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = phase_dry_pod_keys(gen)
    say(f"[dryrun] (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dry_serve()
    say(f"[dryrun] (d) {time.perf_counter() - t0:.1f} s")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({src / 'repro_torch'})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False     # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)

    phase_device()
    phase_build()
    t0 = time.perf_counter()
    errs = {"matmul_h100": phase_k1(gen)}
    errs["matmul_h100_batched"], batched_rows = phase_k1_batched(gen)
    say(f"[K1] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs["flash_attention_h100"] = phase_k2(gen)
    say(f"[K2] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs["ssd_scan_h100"] = phase_k3(gen)
    say(f"[K3] phase {time.perf_counter() - t0:.1f} s")
    cases = phase_cases(gen)
    errs.update(cases["errs"])
    t0 = time.perf_counter()
    phase_parity()
    say(f"[parity] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = []
    for arch, serve_kw, prompt_lens in PATHS:
        paths.append(phase_serve(
            arch, serve_kw, prompt_lens,
            depths=(1, 2) if arch == "llama3_8b" else (1,),
            traced=arch == "llama3_8b"))
    for arch, layers in NEW_PATHS:
        paths.append(phase_serve(arch, NEW_KW, NEW_LENS, layers=layers))
    say(f"[serve] phase {time.perf_counter() - t0:.1f} s; peak device "
        f"memory a path, GiB: " + ", ".join(
            f"{p['name']} {p['peak_gib']:.2f}" for p in paths))
    engine = _group_shapes(paths)
    t0 = time.perf_counter()
    rows = phase_shapes(engine, gen,
                        timed={"matmul_h100_batched": batched_rows})
    phase_host_cost(gen)
    say(f"[shapes] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_options()
    say(f"[options] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_tune(engine, rows, gen, paths[len(PATHS) - 1]["tokens"])
    say(f"[tune] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs["flash_attention_h100"] = max(errs["flash_attention_h100"],
                                       phase_whisper_k2(gen))
    paths.append(phase_whisper(gen))
    phase_steps_parity()
    # phase 9's timing of whisper's launch signatures it has not timed
    for name, row in phase_shapes(_group_shapes(paths[-1:]), gen,
                                  timed=rows, before="phase 9").items():
        rows[name].update(row)
    say(f"[whisper] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (errs["flash_attention_bwd_h100"], bwd_rows, train_paths,
     errs["ssd_scan_bwd_h100"], ssd_bwd_rows, moe) = phase_train(gen)
    k1b_err, k1b_rows, errs["transpose_h100_batched"], k4b_rows = moe
    errs["matmul_h100_batched"] = max(errs["matmul_h100_batched"], k1b_err)
    t1 = time.perf_counter()
    n_new = len(PATHS) + len(NEW_PATHS)
    multi_train, multi_serve, multi_rows = phase_multi(
        gen, train_paths, paths[n_new - 1]["tokens"])
    for name, by_sig in multi_rows.items():
        errs[name] = max([errs.get(name, 0.0)]
                         + [r["err"] for r in by_sig.values()])
    multi_s = time.perf_counter() - t1
    say(f"[multi] phase {multi_s:.1f} s")
    t0 += multi_s
    t1 = time.perf_counter()
    for name, by_sig in phase_dryrun(gen, train_paths).items():
        errs[name] = max([errs.get(name, 0.0)]
                         + [r["err"] for r in by_sig.values()])
    dry_s = time.perf_counter() - t1
    say(f"[dryrun] phase {dry_s:.1f} s")
    t0 += dry_s
    train = _group_shapes(train_paths + multi_train, TRAIN_KERNELS)
    t1 = time.perf_counter()
    k4_rows = phase_train_k4(train_paths, gen)
    say(f"[train] (e) {time.perf_counter() - t1:.1f} s")
    # phase 14's paths are main paths too: (c) and (e) among the training
    # paths, (d) among the engine paths
    train_paths.extend(multi_train)
    paths.append(multi_serve)
    # the training paths' signatures timed as phase 9 times a pick (K2b's
    # of 13 (a), K4's of phase 6 and 13 (e) keep their rows)
    timed = {**rows, "transpose_h100": {**cases["rows"]["transpose_h100"],
                                        **k4_rows},
             "flash_attention_bwd_h100": bwd_rows,
             "ssd_scan_bwd_h100": ssd_bwd_rows,
             "matmul_h100_batched": {**rows["matmul_h100_batched"],
                                     **k1b_rows},
             "transpose_h100_batched": k4b_rows}
    for name, row in phase_shapes(train, gen, timed=timed,
                                  before="phase 6, 9, 12 or 13 (a), (e), "
                                         "(f) or (i)").items():
        rows.setdefault(name, {}).update(row)
    train_sums = launch_sums(train, rows)
    say(f"[train] kernel time over the training paths' launches: "
        f"{_sums_line(train_sums)}")
    say(f"[train] phase {time.perf_counter() - t0:.1f} s")
    # the three first engine paths, the six dense and MoE ones, whisper,
    # phase 14 (d)'s padded kimi-k2, and all
    groups = {"mamba2, hymba, llama3": paths[:len(PATHS)],
              "six new": paths[len(PATHS):n_new],
              "whisper": paths[n_new:n_new + 1],
              "padded kimi": paths[n_new + 1:], "all": paths}
    launches, shapes = {}, {}
    for group, members in groups.items():
        launches[group] = {n: sum(p["launches"][n] for p in members)
                           for n in SERVE_KERNELS}
        shapes[group] = _group_shapes(members)
    for path in paths:
        say(f"[shapes] {path['name']} ({path['wall_ms']:.1f} ms wall), "
            f"kernel time over its launches: "
            f"{_sums_line(launch_sums(path['shapes'], rows))}")
    sums = {g: launch_sums(shapes[g], rows) for g in groups}
    for group in groups:
        say(f"[shapes] main paths, {group}: {_sums_line(sums[group])}")
    totals = sums["all"]
    paths_shapes = shapes
    launches, shapes = launches["all"], shapes["all"]
    case_sums = launch_sums(cases["shapes"], cases["rows"])
    say(f"[cases] kernel time over the case-study path's launches: "
        f"{_sums_line(case_sums)}")
    launches.update(cases["launches"])
    shapes.update(cases["shapes"])
    for name, row in cases["rows"].items():
        rows.setdefault(name, {}).update(row)
    totals.update(case_sums)
    # the training paths (phase 13 (b) and (c)) are main paths of K1, K2,
    # K4 and K2b: their launches and sums go into the kernels' lines
    for name in TRAIN_KERNELS:
        launches[name] = launches.get(name, 0) + sum(
            p["launches"][name] for p in train_paths)
        merged = dict(shapes.get(name, {}))
        for sig, n in train[name].items():
            merged[sig] = merged.get(sig, 0) + n
        shapes[name] = merged
        before = totals.get(name)
        totals[name] = dict(train_sums[name]) if before is None else {
            k: (None if v is None or train_sums[name][k] is None
                else v + train_sums[name][k]) for k, v in before.items()}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        err = max([errs[name]] + [r["err"] for r in rows[name].values()])
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"],
               "bound_by": "bytes" if _bytes_bound(name, shapes)
               else "operations",
               "library_ms": t["library_ms"]}
        by_paths = {}
        if name in SERVE_KERNELS:
            # the three engine paths of PR 19, the six of PR 20 and
            # whisper's non-paged steps, each apart
            by_paths = {
                g: {"launches": sum(paths_shapes[g][name].values()),
                    **{k: sums[g][name][k] for k in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms")}}
                for g in ("mamba2, hymba, llama3", "six new", "whisper",
                          "padded kimi")}
        if name in TRAIN_KERNELS:
            by_paths["training"] = {
                "launches": sum(p["launches"][name] for p in train_paths),
                **{k: train_sums[name][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms",
                    "library_ms")}}
        if by_paths:
            row["by_paths"] = by_paths
        kernels.append(row)
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _group_shapes(paths, names=SERVE_KERNELS) -> dict:
    """{kernel: {signature: launches}} summed over ``paths``."""
    out = {n: {} for n in names}
    for p in paths:
        for n in names:
            for sig, k in p["shapes"][n].items():
                out[n][sig] = out[n].get(sig, 0) + k
    return out


def _bytes_bound(name, shapes) -> bool:
    """Whether bytes, not operations, bound the kernel's launches on the
    main paths, summed over them."""
    byte_ms = op_ms = 0.0
    for sig, n in shapes[name].items():
        b_ms, o_ms = bound_terms_ms(name, sig)
        byte_ms += n * b_ms
        op_ms += n * o_ms
    return byte_ms >= op_ms


if __name__ == "__main__":
    sys.exit(main())
