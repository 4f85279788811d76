#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card, in phases.

  python3 chip_smoke.py            # from the root of a checkout
  python3 chip_smoke.py --phases 1,8   # those phases only, no result line

1. Prints the card's name and power limit; builds the CUDA kernels from
   src/repro_torch/csrc with nvcc (all sources at once) and times the build;
   prints ``flash_ptxas`` and ``hop_ptxas`` (registers and spill bytes of
   every flash, ignorance and quantize kernel instantiation, from
   ``-Xptxas=-v``) and fails if one spills, or unless ``cuobjdump -sass``
   finds tensor-core instructions (HGMMA or HMMA) in the flash_attention
   library.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's sizes, at both sides of each boundary of the launch plans
   and beyond, bit for bit, two runs identical: the ignorance update (one
   cluster launch; its unnormalized mode in w_new and the partials), and
   the wire channel's quantize-dequant (vectors and score blocks; one
   launch), int4 pack and unpack, and the int4 codec's fused encode
   (quantize with the pack as its epilogue) and decode (unpack with the
   dequantize), also from offset views of the wire.  Prints each plan
   (``ignorance_plans``,
   ``quantize_plans``: cluster size and CTAs), checks, by capturing one
   call into a CUDA graph and counting its nodes, that the update at
   n = 42000, the quantize-dequant and the int4 encode at 42000 and
   [18000, 10] and the int4 decode at 42000 are one device kernel a call,
   and times kernel (call ms and device ms), plain version
   and bound (``kernel_table``, ``quantize_table``; ``int4_wire_table``
   beside the parent route: quantize then pack, unpack then a cast and a
   product) and an empty kernel launched the same way (``launch_floor``,
   plain and as a cluster of 8); times the copy of a hop's channel draws
   to the card.
3. Runs the session CLI path (blob3, tree agents) with the metered and the
   mesh-ring transport: the kernels' launch counts equal the hop count, the
   ledger equals the Fig.-4 formula, and a session paused after 2 rounds
   and resumed ends with an ignorance vector bit-identical to an
   uninterrupted run.
4. Full size, MIMIC-III surrogate (paper Fig. 3): 15000 rows (10500 train),
   agents of 3 and 13 features, depth-4 trees, 10 rounds; the same session
   on the CPU (plain version) must agree.
5. Full size, Fashion-MNIST surrogate halves (paper Fig. 5): 60000 images
   (42000 train), 2 agents of 392 pixels, 300-step logistic regression, 5
   rounds; ASCII must beat the single agent.
6. MIMIC size through the wire channel, the session CLI's transports
   (--codec int8; --codec int4 --serve-codec int8; --codec topk;
   --dp-epsilon 1 --accountant rdp; a --byte-budget that walks the ladder
   to int4 and ends exhausted), each on the card and on the CPU with the
   same channel draws: ledgers equal and equal to the wire_bits formulas,
   stop rounds and predictions equal, alphas within rtol 1e-5, quantize
   launches = int-codec hops and score blocks.
7. Fashion at full width with --codec int8 --serve-codec int4 on the card:
   ledger = wire_bits, the first alpha = phase 5's, the int4 and int8
   codecs' encode -> decode (int4: the fused wire kernels, one launch
   each) of a real hop's w equal their roundtrip within one step; accuracy
   beside phase 5's.
8. The model zoo's kernels against their plain versions on the card at
   the dense models' shapes: qwen3-0.6b (B 4, H 16, KV 8, D 128),
   h2o-danube-3-4b (B 2, H 32, KV 8, D 120, a window of 128 that bites at
   S 512) and gemma-7b (B 2, H = KV = 16, D 256); float32 (within 2e-5
   max|v|) and bfloat16 (within 2^-7 max|v|), two runs the same bits,
   with the model's strided layouts: flash attention at S = T = 512, a
   ragged S = T = 500, right-aligned S 500 < T 512, a window of 128; flash
   decode against a cache of 576 at pos 0, 511, 575, fp and int8, with and
   without a window, and on the same inputs the split kernel on its own
   plan (``flash_decode.split_plan``, through ``flash_decode._launch``,
   not counted) in both modes, its lse within 1e-3 of the plain
   version's.  Checks that the decode at the serve shape takes the
   cluster kernel (``flash_decode.decode_plan``) with a block or more on
   each SM.  Prints ``flash_table`` (bf16, per model):
   call ms (CUDA events), device_ms (torch.profiler's kernel durations a
   call, L2 warm) and device_ms_cold (the same over copies of the inputs
   that exceed the 50 MB L2), plain version, bound, and
   F.scaled_dot_product_attention's call and device ms (the library
   yardstick; a boolean mask for a window or a cache position).
9. Full-width serve, qwen3-0.6b (28 layers, bf16, random weights) through
   ``repro_torch.launch.serve --no-reduced --use_flash``: batch 4, prompt
   512, SERVE_GEN tokens (16), once plain and once with --kv_quant; one
   flash_attention launch per layer per prefill and one flash_decode
   launch per layer per decode step.  Then, on the same weights and tokens, teacher-forced
   against use_flash=False (the einsum attention) with the weights in
   float32: the float32 flash path within 1e-4 max|logits| (1e-3 with the
   int8 cache) at every step, and the bf16 flash path no further from it
   than 1.25 x the bf16 einsum path (two bf16 evaluations of 28 random
   layers differ by ~4 % of max|logits|, see PERF.md).  Prints prefill ms,
   decode ms per step, tokens/s and peak device memory.
10. The weighted-CE kernels against their plain versions on the card:
   qwen3-0.6b's training logits [8, 256, 151936] bf16 and the 100m
   preset's [8, 256, 32000] float32, handed over as the loss hands them
   (B * S rows, weight 0 at each last position), and the ragged (2040,
   1000) and (7, 3) in both dtypes: loss and lse within rtol 1e-5,
   dlogits within 2^-7 max|dlogits| (bf16) and 1e-5 max|dlogits|
   (float32), two runs the same bits.  Prints ``ce_table``: kernel (call
   and device ms), plain version, F.cross_entropy (forward; backward
   through autograd) and bound ms at the two training shapes.
11. Full-width training, qwen3-0.6b (28 layers, bf16, 596049920 params,
   random weights) through ``repro_torch.launch.train``: batch 8, seq 256,
   20 steps; every loss finite, one launch of each weighted-CE kernel per
   step; prints step ms, tokens/s, peak device memory, loss first -> last
   and a ``train_profile`` line (torch.profiler over two steps).  On the
   trained weights and a fresh batch, the kernel loss and its gradients
   against the plain loss's on the same logits (loss rtol 1e-5, global
   gradient norm rtol 1e-2).  Then ``--preset 100m --steps 300`` (float32,
   the reference example's run): its loss falls.
12. The paper's other learners, on the card, through the session:
   (a) the Fashion halves at full width with the paper's 3-layer network
   (MLP(128, 64), 200 full-batch steps, 5 rounds): ASCII beats the single
   agent, launches = hops; prints the session's seconds, ms a fit, peak
   device memory and the accuracies beside phase 5's logistic run, and
   ``mlp_fit_profile`` (one fit under torch.profiler); one fit on the card
   and on the CPU from the same draws: logits within 3x the CPU's own
   spread, read in the same run as the largest distance of the CPU's fit
   on each of two row permutations from its fit in order (AdamW's
   normalized steps carry the libraries' last-ulp sums into the
   trajectory), predictions parted only at near-ties; the same card fit
   with TF32 matmuls on is the control, and must fall outside that limit.
   (b) Fig. 3's forest on the blob
   (RandomForest(8 trees, depth 4), 4 agents, 8 rounds): the card's
   session is the CPU's bit for bit (ledger, alphas, predictions, w).
   (c) examples/heterogeneous_agents.py: tree + logistic + MLP agents with
   the CV stop; ASCII beats the single tree.  (d) a NeuralBackbone agent at
   qwen3-0.6b's layer width cut to 2 layers and 10 steps, beside three
   trees; one backbone fit on the card and on the CPU: logits within
   5e-4 max|logit|; the same card fit with the backbone computed in bf16
   is the control, and must fall outside that limit.
13. The control plane at MIMIC size through the session CLI's transport
   and scheduler builders (the CLI has no MIMIC dataset): --controller
   resid; --controller entropy
   --serve-controller margin; --scheduler budget-aware with a
   --byte-budget that walks the ladder to int4 and ends exhausted;
   --variant async --codec int8.  Each on the card and on the CPU with the
   same draws: rung sequences, round orders, ledgers, stop rounds and
   predictions equal, alphas within rtol 1e-5; quantize launches = the
   int-coded hops and blocks (read off the ledger's bits), the async
   merges one unnormalized ignorance launch a positive alpha.  Then the
   same four configs (the budget 30000 bytes) through ``cli.run`` itself
   on its default blob3: the card's line and w equal the CPU's, launches
   as above, and a run paused after 2 rounds and resumed from its
   checkpoint ends with the uninterrupted run's w, bit for bit.
14. The compiled backend (``Protocol(backend="compiled")``,
   ``core.compiled``: the session as one fixed-shape program with no host
   read, its ledger replayed; ``fleet_run``: F sessions in one vmapped
   program).  (a) Fashion at full width with the paper's MLP(128, 64), 200
   steps, COMPILED_FASHION_ROUNDS (3) rounds, compiled against eager on
   the card: components, stop
   round, predictions equal, w bit-equal; the session's seconds, ms a fit
   and peak memory for both.  (b) MIMIC size, LogisticRegression agents
   (``--steps`` MIMIC_STEPS, COMPILED_MIMIC_ROUNDS (5) rounds), built
   through the CLI's parse_args and
   check_args with --backend compiled: fp32, phase 6's five channels,
   --controller resid, --controller entropy, --scheduler budget-aware
   under the budget; compiled = eager on the card: ledgers, rungs, round
   orders, stop rounds, predictions exact, w bit-equal (the async
   variant under --backend compiled: phase 18(a)).  (c) Fleets: 32 MIMIC
   int8 sessions (keys 0..31) and 2 Fashion-MLP sessions (2 rounds) on
   shared data;
   every Fashion session and 2 of the 32 MIMIC ones (0 and 31) against
   compiled_session with the same key (bit-equal; an MLP session may
   part only at a hop that rounding decides: w and alphas bit-equal
   before it, its fits within 12(a)'s limit, every parted prediction a
   near-tie, held-out predictions agreeing >= 0.999); one batched
   ignorance launch a hop; sessions per second for the fleet, for those
   compiled_session calls and for as many eager sessions.  (d) The
   batched ignorance kernel against its plain version and against F single launches, bit for bit, at
   [32, 15000], [8, 42000], n above 2^16 and rows above the grid's 65535;
   its call and device ms beside the bytes bound and the launch floor
   (``batched_table``); and the fleet's int4 decode at an odd n (the
   row-strided launch) against its plain version.  (e) One compiled
   session and one fleet under torch.cuda.set_sync_debug_mode("error"),
   after a warm-up: no host read inside the program.
15. The prediction service: the compiled serve step
   (``core.compiled.serve_session`` / ``serve_batch``) and the serve
   engine (``repro_torch.serve``).  (a) MIMIC size, LogisticRegression
   agents (SERVE_STEPS steps), five serve channels (--serve-codec int8; int4
   with DP epsilon 1 and RDP; a byte budget whose serve walk ships fp32,
   fp16, int8 and then exhausts; --serve-controller margin; entropy),
   ``Protocol.predict_distributed`` compiled against eager on the 4500
   held-out rows, four calls and one with max_round 4: predictions, the
   shipped blocks, ledgers, skips, exhaustion, link spend and DP releases
   bit for bit; block quantize launches = one a non-head agent and int
   rung of the serve ladder (compiled), one an int-coded block (eager).
   (b) The engine: 8 resident MIMIC int8 sessions (fit keys 0-7), a cache
   of 4 (spills and restores), batches of 8, 4 tenants, 256 requests of
   1024 held-out rows drawn from seed 0, a flush every 32; prints
   ``serve_engine`` (requests/s, request_seconds p50/p99, batches, slots,
   pads, cache hits, spills, restores); one batched block quantize a
   bucket; every request = a standalone ``predict_distributed(request=
   rid)`` on its session (predictions, bits, releases); one more flush
   of 32 under torch.profiler (``serve_engine_profile``: wall and device
   ms, the device's idle share, device ms by kind of kernel).  Then 4 DP
   sessions behind a byte cap of 5 requests and an epsilon cap, allowing
   degrade and not: accept and degrade, accept and deny, each engine's
   decisions, counters and outcomes = a sequential replay of its stream.
   (c) The batched block quantize (``quantize_dequant_block_rows``, one
   launch for a bucket's blocks) = its plain version = the vmap rule = B
   lone launches, bit for bit, int8 and int4, at [8, 1024, 2], [8, 4500,
   2] and [8, 1024, 10]; one device kernel a call; ``block_rows_table``
   (call and device ms, plain, B lone launches, bound, launch floor).  (d)
   ``serve_batch`` of 8 slots on inputs already on the card under
   ``torch.cuda.set_sync_debug_mode("error")``: no host read.
16. Scenarios and protocol variants (``repro_torch.scenarios``).  (a)
   MIMIC at full size (n = 15000, agents of 3 and 13 features, depth-4
   trees, 10 rounds), ASCII under the churn, noniid and subsample presets
   and under ``--variant async`` with clock_skew (0, 2): card = CPU bit
   for bit (participants, components, alphas, ledger, predictions); one
   ignorance launch a participating hop (one unnormalized launch a
   positive alpha in the async merge).  (b) MIMIC Assisted Learning
   ([10500, 2] residuals) through the CLI's make_transport: int8, int4
   with DP epsilon 1, a byte budget that walks fp32 -> int4 and exhausts;
   card = CPU ledgers, the ledger = wire_bits, residuals within 1e-5 of
   max|R|; one block quantize an int-coded shipped hop.  (c) Fashion
   FedAvg at full width (42000 rows, 2 x 392 pixels, FEDAVG_ROUNDS
   rounds of the paper's 5) with
   LogisticRegression (d = 3930) and MLP(128, 64) (d = 59210), each
   FEDAVG_STEPS local steps a round, under fp32, int8, int4, DP epsilon 1 with
   subsampled-rdp under the subsample preset, and a byte budget: the
   card's one-program FedAvg = its eager FedAvg bit for bit (g, history,
   ledger, rungs, skips, releases, exhaustion); quantize launches = the
   int-coded shipped uplinks eager, slots x int rungs compiled; each
   accuracy beside phase 5's ASCII; the int4 encode -> decode of a real
   uplink = its roundtrip (one launch each).  (d) One FedAvg program
   under ``torch.cuda.set_sync_debug_mode("error")``: no host read.
   Prints session seconds eager and compiled, ms a round, peak memory.
17. Telemetry (``repro_torch.telemetry``).  (a) MIMIC at full size
   (n = 15000, agents of 3 and 13 features, depth-4 trees, 10 rounds)
   eager, and MIMIC LogisticRegression(steps=SERVE_STEPS) agents compiled
   with --controller resid, --serve-codec int8 and DP epsilon 1, each fitted
   and served once untimed without ``Telemetry()``, then three times with
   it and three times without, the order alternating (off, on, on, off,
   off, on), and with it on the CPU: w, ledger, alphas, DP releases, predictions and kernel
   launches equal with telemetry on and off, the card's counter series =
   the CPU's, the span tree well formed (session -> round -> hop and
   serve eager; session, replay and serve compiled), the trace, snapshot
   and .prom pass ``repro_torch.telemetry.check`` and the trace reloads
   the registry.  (b) That compiled session with ``Telemetry(live=True)``
   = its dark run, its ``live_*`` series = the replay-booked ones; the
   same program under ``torch.cuda.set_sync_debug_mode("error")``; a
   fleet of 8 MIMIC int8 sessions dark, live and live under sync debug
   mode: bit-equal, the live sums = the sessions' bits priced from the
   dark fleet's result; the device operations (every kernel, copy and
   memset, torch.profiler's count) of one dark and one live session
   program (that configuration at one logistic step a fit) and
   ``serve_batch``.  (c) 15(b)'s engine cut to 64 requests,
   dark three times and with ``Telemetry(live=True)`` streaming a trace
   three times, alternating as (a): every request equal,
   launches equal, flush/flush_wave/bucket_dispatch spans,
   ``live_serve_requests_total`` = the requests delivered, one tap copy a
   bucket; a live ``serve_batch`` of 8 under sync debug mode = the dark
   one.  (d) The session CLI on blob3 with --profile-dir and --trace: the
   profiler's trace has the span names as ranges.  Prints
   ``telemetry_table``: seconds of each run with telemetry on and off,
   the overhead of the medians and the spread of each side (no bound),
   ``span_seconds`` p50 of session, round, hop and flush_wave, the tap
   copies of a session, a fleet and the engine beside the device
   operations a live program adds, and each part's seconds.
18. The rest of the compiled backend, MIMIC at full size (n = 15000,
   agents of 3 and 13 features, LogisticRegression(steps=MIMIC_STEPS);
   ASYNC_ROUNDS, SWEEP_ROUNDS and CONTROL_ROUNDS rounds).  (a) The async-stale lowering (``core.compiled.
   async_session`` through ``Protocol(backend="compiled")``) against the
   eager async run on the card under the reference's five async channels
   (plain, int8, DP epsilon 2 clip 0.1, and on the (int8, int4) ladder a
   budget that finishes and one that runs dry mid-session, both caps
   rescaled from ``payload_costs(n)``): components, alphas, history, w,
   ledgers, release rungs, skips, exhaustion, DP releases and
   predictions bit for bit; launches: one unnormalized ignorance update
   a positive alpha eager, a (round, agent) compiled, quantize a coded
   release eager, a round and int rung compiled; eager and compiled
   seconds; the async program (tight budget and DP) under
   ``torch.cuda.set_sync_debug_mode("error")``: no host read.  (b)
   ``quant_sweep_run`` on an int8 plan at qmax [127, 31, 7], SWEEP_ROUNDS
   (5) rounds, with equal keys and the serve axis on the 4500 held-out rows: each row =
   ``compiled_session`` + ``serve_session`` of the static plan at its
   range (int8, a 6-bit ``QuantCodec`` built for it, int4) and = the
   eager run, bit for bit, the fits' params within Queue 3's logistic
   tolerance (atol 1e-5 + rtol 1e-5); one quantize launch a hop and one
   block launch a non-head agent whether the sweep holds 1 or 3 ranges;
   ``codec_sweep_rows`` (bits a element from ``quant_bits_per_element``,
   interchange and serve bits, accuracy).  (c) ``control_sweep_run``:
   the reference's four (cut, beta) configs on an (fp16, int4)
   controller, and four session caps on (int8, int4) (None, one that
   finishes, two that run dry, one of them before the last round): each
   row = the static compile bit for bit, ``TRACE_COUNTS ==
   {"control_sweep": 1}`` a sweep; ``live=True`` = dark, the taps'
   counters = the static runs' replayed ledgers, one tap copy a round.
   (d) The quantize kernels with the range as a device operand
   (``quantize_dequant_rows`` with a tensor qmax at [3, 15000], qmax
   [127, 31, 7]; ``quantize_dequant_block_rows`` at the serve axis's
   [3, 4500, 2] with those ranges and at [8, 1024, 2] with eight) = their
   plain versions = lone launches at the float range, bit for bit, two
   runs identical, one device kernel a call;
   ``qmax_rows_table`` (call and device ms, plain, bytes bound at 3.35
   TB/s, launch floor) beside the card's name and power limit.
19. The rest of the model zoo at full width, random bf16 weights from
   CUDA generators (``ZOO_SERVE``).  (a) Serve through
   ``repro_torch.launch.serve``'s ``run``: granite-moe-1b-a400m,
   mamba2-130m, minicpm3-4b, internvl2-2b (its 256 patch embeddings
   prepended) and whisper-tiny (1500 frames) at their published depth,
   batch 4, prompt 512, 32 tokens; qwen3-moe-235b-a22b cut to 2 layers of
   94 and jamba-v0.1-52b to one pattern unit of 8 layers of 32, batch 1,
   prompt 256, 16 tokens.  The GQA families with use_flash and without,
   each with the bf16 and the int8 cache: flash_attention launches =
   attention layers a prefill (whisper: its encoder's, self and cross),
   flash_decode launches = attention layers x decode steps; minicpm3 (MLA)
   and mamba2 on the einsum path.  Then, for the GQA families, flash
   against einsum teacher-forced on the run's tokens at 2 layers (jamba:
   its unit; whisper: all of it), in bf16 and with the weights in float32
   (cast up in place), each with both caches (int8: both from the einsum
   path's quantized prefill cache): float32 within 1e-4 max|logits| (1e-3
   int8), greedy choices equal but at near-ties, bf16
   flash no further from float32 than 1.25 x bf16 einsum on the mean over
   the prefill and the steps (``zoo_bf16`` prints each step's).  (b) One
   full-width MoE layer of granite and qwen3-moe in float32 at 512
   tokens: grouped = dense within 1e-5 max|y|, two grouped runs the same
   bits, the router's indices on the card = the CPU's but at near-ties.
   (c) mamba2 in float32, chunk 128: a prefill of 384 then 128 decode
   steps = a prefill of 512 at every step within 1e-4 max|logits| (the
   state handoff).  (d) Card = CPU, float32 einsum path, prefill and 4
   steps within 1e-4 max|logits| (``ZOO_CPU``: mamba2 and whisper at full
   width, granite, internvl2 and minicpm3 cut to 2 layers, jamba and
   qwen3-moe at ``reduced()``).  (e) Training through
   ``repro_torch.launch.train``, granite and mamba2 at full width, 3
   steps, batch 4, seq 256: losses and aux finite, one launch of each
   weighted-CE kernel a step, the kernel loss = the plain loss on the same
   logits (rtol 1e-5); and an ASCII session with a NeuralBackbone agent at
   each one's width cut to 2 layers beside three trees (as 12(d)):
   ignorance launches = hops, one fit on the card = the CPU's within 5e-4
   max|logit|.  Prints ``zoo_table`` (per arch: params, each path's
   prefill ms, decode ms a step, tokens/s, peak GiB and flash launches;
   the float32 comparisons; training step ms, tokens/s, peak and CE
   launches) beside the card's name and power limit.
20. The multi-device layer over NCCL at world size 1: a one-rank ``nccl``
   group on the card (``init_process_group`` on a ``HashStore`` with the
   card's ``device_id``), destroyed at the end, so no other phase sees
   it.  (a) ``ops.ignorance_update(group=)`` and ``make_ring_interchange``
   on a (1, 1) mesh at n = 15000 and 42000 give ``ops.ignorance_update``'s
   bits, one unnormalized launch (one device kernel, counted as phase 2
   counts) and one all-reduce a hop.  (b) Phase 4's MIMIC session through
   ``MeshRingTransport(mesh=)`` = without a mesh: components, alphas, stop
   round, history, w and predictions bit for bit.  (c)
   ``fleet_run(shard_axis="data")`` of 8 MIMIC int8 logistic sessions, 2
   rounds = ``fleet_run``, every leaf bit for bit.  (d) One MoE layer of
   granite-moe-1b-a400m and of qwen3-moe-235b-a22b at batch 4 x 512
   tokens: ``ep_a2a`` at D = 1 (no token dropped, asserted) against the
   grouped path, float32 within 1e-5 of max|y| and aux equal; bf16 no
   further from the float32 grouped y than 1.25 x the bf16 grouped path
   (19(a)'s bf16 rule).  (e) ``Trainer(mesh=)`` on qwen3-0.6b at full
   width, batch 8, seq 256, 2 AdamW steps = the mesh-less Trainer's
   losses and parameters bit for bit, under
   ``torch.use_deterministic_algorithms`` (the mesh-less run twice, to
   show it repeats its bits).  Prints ``dist_table`` (the NCCL version,
   each check's error, launches and seconds).
21. Tensor parallelism's kernel modes and plumbing (one card: NCCL places
   no two ranks on one device, so the TP program across ranks runs only
   on the CPU's gloo worlds, tests/test_torch_tp.py).  (a) The vocab-shard
   weighted CE at qwen3-0.6b's full width: 2048 x 151936 bf16 logits cut
   into 16 column views of 9496 (row stride V, no copy), each shard's
   (lse, gold) by ``ops.weighted_ce_shard_fwd`` combined by
   ``tp.combine_ce`` and its dlogits by ``ops.weighted_ce_shard_bwd``: the
   loss and lse within rtol 1e-5 of the whole-vocab kernel and of the
   plain version, the dlogits as phase 10 holds them (elementwise 2^-7,
   row sums 0); one launch of each shard kernel a shard, the forward's the
   staged kernel (``weighted_ce.shard_fwd_plan``).  (b) The
   length-shard ``flash_decode`` at decode_32k's per-data-shard geometry
   (B 8, H 16, KV 8, D 128, S 32768 bf16, the model's [B, S, KV, D] cache
   views) cut into 16 chunks of 2048 at pos 32767, 20000 (chunks past it)
   and 4096 (a chunk's first row): each chunk's lse within 1e-3 of the
   plain shard mode's (-inf exactly past pos) and its o within 2^-6 of
   its max|o|; ``tp.merge_partials`` of the chunks' (o, lse) within 2^-6
   max|ref| of the whole-cache kernel and of the plain version; one
   launch a chunk that holds a valid position, every one the cluster
   kernel (``flash_decode.decode_plan``), one device kernel a chunk (no
   merge launch); SDPA over each chunk (o alone, no lse) timed beside it
   as a yardstick.  (c) Plumbing
   only: the steps under a (1, 1) mesh over a one-rank NCCL group =
   the mesh-less steps bit for bit, qwen3-0.6b full width bf16 with
   use_flash: prefill and 4 decode steps at batch 4 (the heads layout)
   and at batch 1 (the cache split along its positions over (data,
   model): ``flash_decode_shard`` and a one-rank merge), and one AdamW
   ``Trainer(mesh=)`` step under deterministic algorithms.  (d)
   ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
   train_4k`` and ``decode_32k`` on the card's host (a fake world of 256
   ranks), started before (a) and run beside (a)-(c): their seconds and
   roofline terms.  Prints ``tp_table`` (device
   ms: the 16 shards' launches, and the whole kernel's, each a CUDA graph
   replayed between CUDA events, and a shard's share of the 16; the
   bound a shard; errors; seconds).

Every phase prints one line; a failed phase makes the run exit 1, and then
the last line is not printed.  Before the last line it prints the card's
line again and one JSON object describing each kernel.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits 2 when torch sees no CUDA device, and fails to import the port when
run outside a checkout.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core rate
SMOKE_DIR = os.path.join(ROOT, "build", "chip_smoke")
# phase 14's and 18's MIMIC logistic agents' steps (the CLI's default is
# 150): a step took ~2 ms of host time on an H100 80GB HBM3 at 700 W
# (PERF.md), so at 50 the phase's MIMIC sessions and fleets take about a
# minute there; at 25 a fleet session and a sweep row part from their
# single runs at near-ties
MIMIC_STEPS = 50
# phases 15's and 17's (the serve path's and telemetry's sessions): 50
# until phase 19 came, when the whole script took 1244 s on a slower host
# of that card; at 25 both phases hold every check
SERVE_STEPS = 25
# phase 14(c)'s Fashion-MLP fleet's rounds (the session's 5 cut to 2: its
# 8 sessions three ways took ~100 s at 3 rounds, and phases 16 and 17
# took the script past 800 s)
FASHION_FLEET_ROUNDS = 2
# phase 14(c)'s fleet sizes and the MIMIC fleet's sessions held against
# compiled_session and eager runs (Fashion 8 and 8 of 32 MIMIC ones took
# 99 s on an H100 80GB HBM3 at 700 W; cut for phase 18; Fashion 4 and 4
# of 32 took 60 s, and the whole script 1200 s on a slower host: cut to
# 2 and 2)
FASHION_FLEET, MIMIC_FLEET, MIMIC_HELD = 2, 32, (0, 31)
# phase 12(d)'s backbone steps (its CPU fit took 57 s at 20; cut to 10
# for phase 18, to 6 for phase 19: 28 s at 10 on a slower host; to 3 when
# the whole script passed 1200 s on a slower host: 20 s at 6)
BACKBONE_STEPS = 3
# phase 9's generated tokens (64 until phase 19, 32 until the whole script
# passed 1200 s on a slower host: its four teacher-forced paths decode
# every one twice)
SERVE_GEN = 16
# phase 9's decode steps under torch.profiler (8 until the script passed
# 1200 s: the profiler's tables of 28 layers' launches cost seconds a step)
PROFILE_STEPS = 4
# phase 11's 100m preset steps (300 until the script passed 1200 s: 20 s)
PRESET_STEPS = 150
# phase 16(c)'s FedAvg rounds (the paper's 5 cut to 3: its twenty
# sessions took ~150 s, and phase 17 would take the script past 800 s)
FEDAVG_ROUNDS = 3
# phase 16(c)'s local steps a round (logistic 300 and the paper's MLP 200
# until the whole script passed 1200 s on a slower host; the budget's
# rounds and every check are the same at any step count)
FEDAVG_STEPS = 100
# the rounds of phase 14(a)'s Fashion MLP sessions (the session's 5), 14(b)'s
# nine MIMIC configs, 18(b)'s sweep and 14(e)'s sync-checked session (10),
# 18(a)'s async channels and 18(c)'s control sweep (10: the tight budget
# and the tightest cap still run dry before the last round), and 15(b)'s
# engine sessions (10): cut when the whole script passed 1200 s on a
# slower host; each check holds one backend or route to the other,
# whatever the rounds
COMPILED_FASHION_ROUNDS, COMPILED_MIMIC_ROUNDS, SWEEP_ROUNDS = 3, 5, 5
SYNC_CHECK_ROUNDS, ASYNC_ROUNDS, CONTROL_ROUNDS = 3, 7, 7
ENGINE_FIT_ROUNDS = 5
# phase 19(a)'s serve cells: arch -> (layers kept, batch, prompt, tokens
# generated, halved when the whole script passed 1200 s on a slower
# host); None keeps the published depth.  qwen3-moe (94 layers) and
# jamba (32) fit one 80 GB card only cut in depth: 2 layers (~6.2 B
# params, ~12.4 GB in bf16) and one pattern unit of 8 (~13 B, ~26 GB)
ZOO_SERVE = {"granite-moe-1b-a400m": (None, 4, 512, 16),
             "mamba2-130m": (None, 4, 512, 16),
             "minicpm3-4b": (None, 4, 512, 16),
             "internvl2-2b": (None, 4, 512, 16),
             "whisper-tiny": (None, 4, 512, 16),
             "qwen3-moe-235b-a22b": (2, 1, 256, 8),
             "jamba-v0.1-52b": (8, 1, 256, 8)}
# phase 19(d)'s card = CPU cells: arch -> layers kept ("reduced":
# reduced(); the CPU runs them too)
ZOO_CPU = {"mamba2-130m": None, "whisper-tiny": None,
           "granite-moe-1b-a400m": 2, "internvl2-2b": 2, "minicpm3-4b": 2,
           "jamba-v0.1-52b": "reduced", "qwen3-moe-235b-a22b": "reduced"}
# phase 19(e): the archs trained and fitted as ASCII backbones, the train
# steps, and the backbone fits' steps (a CPU fit of granite's 32 dense
# experts at full width costs ~1 s a step; 3 backbone steps until the
# whole script passed 1200 s on a slower host)
ZOO_TRAIN = ("granite-moe-1b-a400m", "mamba2-130m")
ZOO_TRAIN_STEPS = 3
ZOO_BACKBONE_STEPS = 2


def _cuda_time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the call captured into a CUDA
    graph (its launches back to back, no host time between them), the
    graph replayed ``reps`` times between two CUDA events.  For a call of
    many short launches, where torch.profiler's window may drop some."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _counters() -> dict:
    """Each kernel of the main path by its JSON name: the wrapper that
    counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ignorance as ig
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import weighted_ce as wce
    return {"ignorance_update": ig.ignorance_update,
            "ignorance_update_unnormalized": ig.ignorance_update_unnormalized,
            "ignorance_update_batched": ig.ignorance_update_batched,
            "quantize_dequant_tiles": q.quantize_dequant_tiles,
            "quantize_dequant_block": q.quantize_dequant_block,
            "quantize_dequant_block_rows": q.quantize_dequant_block_rows,
            "pack_int4": q.pack_int4,
            "unpack_int4": q.unpack_int4,
            "quantize_pack_int4": q.quantize_pack_int4,
            "unpack_dequant_int4": q.unpack_dequant_int4,
            "flash_attention": fa.flash_attention,
            "flash_decode": fd.flash_decode,
            "weighted_ce_fwd": wce.weighted_ce_fwd,
            "weighted_ce_bwd": wce.weighted_ce_bwd,
            "weighted_ce_shard_fwd": wce.weighted_ce_shard_fwd,
            "weighted_ce_shard_bwd": wce.weighted_ce_shard_bwd,
            "flash_decode_shard": fd.flash_decode_shard}


# The quantize kernels with the range as a device operand (the
# instantiations that read one qmax a row): launched by the float-range
# batches' wrappers given a tensor qmax, and counted by those wrappers'
# counters, named here.  Their launches in the kernels' JSON line are those
# counters' reads over the codec sweep's runs (18(b)), where every quantize
# and every served block takes the device range.
QMAX_ROUTES = {"quantize_dequant_rows_qmax": "quantize_dequant_tiles",
               "quantize_dequant_block_rows_qmax":
                   "quantize_dequant_block_rows"}


def _bound_ms(nbytes: int, ops: int,
              ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_pairs(s: int, t: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of right-aligned attention: the work
    this input needs."""
    pairs = 0
    for i in range(s):
        row = i + t - s
        hi = row if causal else t - 1
        lo = 0 if window is None else max(0, row - window + 1)
        pairs += max(0, hi - lo + 1)
    return pairs


def _kernel_device_ms(fn, key: str, reps: int = 100) -> float:
    """Device time a call of the kernels whose name holds ``key``:
    torch.profiler's kernel durations over ``reps`` calls of ``fn`` (after
    a warm-up), their mean times the kernels a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window where the tracer saw no kernel at all
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0  # key "" takes every kernel of the window
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and key in evt.key:
                us = getattr(evt, "self_device_time_total", None)
                total += (evt.self_cuda_time_total if us is None
                          else us) / 1e3
                count += evt.count
        if total > 0:
            break
    if total <= 0:
        raise RuntimeError(f"the profiler saw no {key} kernel in three "
                           f"windows")
    # the mean kernel times the kernels a call: a kernel the tracer
    # dropped from the window does not pull the time down
    return total / count * max(1, round(count / reps))


# CUgraphNodeType, cuda.h
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               10: "mem_alloc", 11: "mem_free"}


def _device_kernels_per_call(fn) -> tuple[int, dict]:
    """Device operations a call of ``fn`` enqueues, and their count by
    kind: one call (after a warm-up) captured into a CUDA graph on a side
    stream through the driver API, its nodes counted.  Unlike the
    profiler's tracer, which can drop a short kernel from its window, the
    count does not depend on timing; the graph is never launched."""
    import ctypes
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(what, status):
        if status != 0:
            raise RuntimeError(f"{what} returned CUresult {status}")
    stream, graph = torch.cuda.Stream(), ctypes.c_void_p()
    handle = ctypes.c_void_p(stream.cuda_stream)
    with torch.cuda.stream(stream):
        # CU_STREAM_CAPTURE_MODE_RELAXED: the caching allocator may still
        # reach cudaMalloc inside the call
        check("cuStreamBeginCapture", cu.cuStreamBeginCapture_v2(handle, 2))
        try:
            fn()
        finally:
            check("cuStreamEndCapture",
                  cu.cuStreamEndCapture(handle, ctypes.byref(graph)))
    try:
        count = ctypes.c_size_t(0)
        check("cuGraphGetNodes",
              cu.cuGraphGetNodes(graph, None, ctypes.byref(count)))
        nodes = (ctypes.c_void_p * count.value)()
        check("cuGraphGetNodes",
              cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)))
        kinds: dict = {}
        for node in nodes[:count.value]:
            kind = ctypes.c_int(-1)
            check("cuGraphNodeGetType", cu.cuGraphNodeGetType(
                ctypes.c_void_p(node), ctypes.byref(kind)))
            name = _NODE_TYPES.get(kind.value, str(kind.value))
            kinds[name] = kinds.get(name, 0) + 1
    finally:
        check("cuGraphDestroy", cu.cuGraphDestroy(graph))
    torch.cuda.synchronize()
    return sum(kinds.values()), kinds


def _live_tiles(s: int, t: int, causal: bool, window) -> int:
    """KV tiles of 64 keys the attention kernels visit for one head: for
    each tile of 64 right-aligned queries, the tiles that hold a key of
    the causal / window band of one of its queries."""
    tiles = 0
    for q0 in range(0, s, 64):
        lo, hi = q0 + t - s, min(s, q0 + 64) - 1 + t - s
        k_begin = 0 if window is None else max(0, lo - window + 1)
        k_end = min(t, hi + 1) if causal else t
        tiles += -(-k_end // 64) - k_begin // 64
    return tiles


def _host_time_ms(fn, reps: int = 50) -> float:
    """Host clock around ``reps`` calls that end in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


KINDS = (("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
         ("weighted_ce", ("wce_",)), ("flash", ("flash_",)),
         ("copy/cast", ("copy", "Memcpy", "Memset")),
         ("softmax", ("softmax",)), ("reduce", ("reduce",)),
         ("index/scatter", ("index", "scatter", "gather", "embedding")),
         ("elementwise", ("elementwise",)))


def _kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def _device_profile(fn, top: int = 8) -> dict:
    """torch.profiler around ``fn()`` ending in a synchronize: wall ms (host
    clock, under the profiler), the device's kernel and copy ms, its idle
    share, the ``top`` kernels by device time, and the device ms by kind
    of kernel (GEMMs, copies and casts, elementwise, ...)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}     # the device's own events: kernels and copies
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        dev[evt.key] = dev.get(evt.key, 0.0) + us / 1e3
    busy = sum(dev.values())
    ranked = sorted(dev.items(), key=lambda kv: -kv[1])[:top]
    kinds: dict = {}
    for name, ms in dev.items():
        kinds[_kind_of(name)] = kinds.get(_kind_of(name), 0.0) + ms
    return {"wall_ms": wall_ms,
            "device_ms": busy if dev else "not measured",
            "idle_share": 1 - busy / wall_ms if dev else "not measured",
            "by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top": [[k[:70], v] for k, v in ranked]}


def _device_op_counts(fn) -> dict:
    """The device operations one ``fn()`` (ending in a synchronize) runs,
    by kind, as torch.profiler's tracer records them: kernels (every
    kernel, the library's and the hand-written ones), copies and
    memsets."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0, "memsets": 0}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kind = ("copies" if evt.key.startswith("Memcpy") else "memsets"
                    if evt.key.startswith("Memset") else "kernels")
            out[kind] += evt.count
    return out


def _ptxas_usage(log: str) -> dict:
    """Registers and spill stores / loads (bytes) of each kernel in an
    ``nvcc -Xptxas=-v`` log, by demangled name without its arguments."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {"regs": None, "spill": [None, None]}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            usage[fn]["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["regs"] = int(m.group(1))
    names = list(usage)
    filt = os.path.join(os.path.dirname(_cuda_tool("nvcc")), "cu++filt")
    if names and os.path.exists(filt):
        out = subprocess.run([filt, *names], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(names):
            return {_short_name(pretty): usage[raw]
                    for raw, pretty in zip(names, out)}
    return usage


def _short_name(demangled: str) -> str:
    """``void (anonymous namespace)::f<(int)4>(Args)`` -> ``f<4>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|"
                  r"\((int|bool)\)", "", demangled)
    return name[:name.index("(")] if "(" in name else name


def _cuda_tool(name: str) -> str:
    from repro_torch.kernels import _build
    return os.path.join(os.path.dirname(_build._nvcc()), name)


def _sass_count(lib, opcodes) -> dict:
    """How many instructions of each opcode ``cuobjdump -sass`` finds in a
    built library."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def _max_rel(a, b) -> float:
    import torch
    denom = torch.clamp(b.abs(), min=1e-30)
    return float(((a - b).abs() / denom).max())


def _dlogits_ratios(d, pd, w, g) -> tuple[float, float]:
    """The backward kernel's dlogits against the plain version's, as
    ratios to their tolerances (each must be <= 1):

    - element by element, |d - pd| <= rtol |pd| + 1e-3 |w g| / V, with
      rtol 2^-7 in bf16 (both round the same float32 value, so they differ
      by at most one bf16 ulp, <= 2^-7 of either) and 1e-5 in float32;
      the atol is a thousandth of a typical entry |w g| / V;
    - each row's sum, which is w g (sum p - 1) = 0: |sum_v d| <= stol |w g|,
      with stol 2^-7 in bf16 (each of the entries, whose magnitudes sum to
      at most 2 |w g|, rounds by at most 2^-8 of itself) and 1e-5 in
      float32.  A kernel that drops small probabilities, or an lse that
      is off, moves the row sum."""
    import torch
    bf16 = d.dtype == torch.bfloat16
    rtol = 2.0 ** -7 if bf16 else 1e-5
    wg = (w.float() * g.float()).abs()[:, None]
    tiny = torch.finfo(torch.float32).tiny
    pdf = pd.float()
    bound = rtol * pdf.abs() + 1e-3 * wg / d.shape[1]
    elem = float(((d.float() - pdf).abs() / bound.clamp(min=tiny)).max())
    rows = d.double().sum(dim=1).abs()
    row = float((rows / (rtol * wg[:, 0].double()).clamp(min=tiny)).max())
    return elem, row


class Smoke:
    def __init__(self) -> None:
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.launches = {name: 0 for name in [*_counters(), *QMAX_ROUTES]}
        self.fashion_fp32 = None       # phase 5's data and accuracy
        self.mlp_limit = None          # phase 12a's logits limit
        self.floor_ms = None           # phase 2's launch floor
        self.serve_protos = None       # phase 15(b)'s fitted sessions
        self.tele_dark = {}            # phase 17(a)'s dark runs
        self.card = ""                 # the card's name and power limit

    def phase(self, num: int, fn) -> None:
        t0 = time.perf_counter()
        try:
            line = fn()
            print(f"phase {num} ok ({time.perf_counter() - t0:.1f} s): "
                  f"{line}", flush=True)
        except Exception as e:  # report and go on: every phase runs
            traceback.print_exc()
            self.failed.append(f"phase {num}")
            print(f"phase {num} FAILED: {type(e).__name__}: {e}", flush=True)

    def require(self, cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    # ------------------------------------------------------------ counters
    def reset_counts(self) -> None:
        for fn in _counters().values():
            fn.launches = 0

    def read_counts(self, hops: int, where: str, **channel: int) -> None:
        """The main path's launches since reset_counts: one fused
        ignorance update per shipped hop (and no unnormalized one), and the
        wire channel's kernels as ``channel`` names them (0 where not
        named), added to the run's totals."""
        want = {name: 0 for name in _counters()}
        want["ignorance_update"] = hops
        want.update(channel)
        got = {name: fn.launches for name, fn in _counters().items()}
        self.require(got == want,
                     f"{where}: kernel launches {got} != expected {want}")
        for name, count in got.items():
            self.launches[name] += count

    # -------------------------------------------------------------- phases
    def build(self) -> str:
        from repro_torch.kernels import _build
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        _build.build(*sources)
        secs = time.perf_counter() - t0
        usage, hop = {}, {}
        for name in ("flash_attention", "flash_decode",
                     "flash_decode_cluster"):
            usage.update(_ptxas_usage(_build.LOGS[name]))
        for name in ("ignorance", "quantize"):
            hop.update(_ptxas_usage(_build.LOGS[name]))
        print("flash_ptxas " + json.dumps(usage), flush=True)
        print("hop_ptxas " + json.dumps(hop), flush=True)
        spills = [k for k, u in {**usage, **hop}.items()
                  if u["spill"] != [0, 0]]
        self.require(not spills, f"spilling instantiations: {spills}")
        mma = _sass_count(_build.library_path("flash_attention"),
                          ("HGMMA", "HMMA"))
        self.require(sum(mma.values()) > 0,
                     f"no tensor-core instruction in the flash_attention "
                     f"library's SASS: {mma}")
        return (f"built {sources} with nvcc in {secs:.2f} s; flash "
                f"instantiations {len(usage)}, ignorance and quantize "
                f"{len(hop)}, none spilling; "
                f"flash_attention SASS tensor-core instructions {mma}")

    def kernel_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        gen = torch.Generator(device=self.dev).manual_seed(0)
        limit = ig.cluster_limit(self.dev.index or 0)
        # 420, 10500, 42000: the hops of phases 3, 4, 5; then both sides of
        # each boundary of the plan (the cluster limit at 8 and 16 tiles,
        # 2, 3, 4, 5 tiles a CTA under either limit, LARGE_N at 64 tiles)
        ns = [1, 210, 420, 1024, 1000, 4096, 10500, 42000, 2 ** 18,
              2 ** 20 + 3, 2 ** 20]
        for tiles in (8, 16, 24, 32, 48, 64):
            ns += [tiles * ig.BN, tiles * ig.BN + 1]
        rows, plans = [], {}
        for n in ns:
            w = torch.rand(n, generator=gen, device=self.dev) + 0.01
            w /= w.sum()
            r = (torch.rand(n, generator=gen, device=self.dev) > 0.4).float()
            a = torch.tensor(1.7, device=self.dev)
            k_n = ops.ignorance_update(w, r, a)
            p_n = ig.ignorance_update_plain(w, r, a)
            k_w, k_p = ig.ignorance_update_unnormalized(w, r, a)
            p_w, p_p = ig.ignorance_update_unnormalized_plain(w, r, a)
            torch.cuda.synchronize()
            self.require(torch.equal(k_n, p_n),
                         f"n={n}: the update differs from the plain version "
                         f"(max abs {float((k_n - p_n).abs().max())})")
            self.require(torch.equal(k_w, p_w) and torch.equal(k_p, p_p),
                         f"n={n}: the unnormalized mode differs from the "
                         f"plain version in w_new or the partials")
            self.require(torch.equal(ops.ignorance_update(w, r, a), k_n),
                         f"n={n}: two runs differ")
            p = ig.plan(n, limit)
            plans[n] = [p.route, p.cluster, p.ctas, p.tiles_per_cta]
            if n in (10500, 42000, ig.LARGE_N, ig.LARGE_N + 1, 2 ** 18,
                     2 ** 20):
                rows.append({
                    "n": n, "route": p.route,
                    "kernel_ms": _cuda_time_ms(
                        lambda: ops.ignorance_update(w, r, a)),
                    "device_ms": _kernel_device_ms(
                        lambda: ops.ignorance_update(w, r, a), ""),
                    "plain_ms": _cuda_time_ms(
                        lambda: ig.ignorance_update_plain(w, r, a)),
                    "bound_ms": _bound_ms(12 * n + 4, 4 * n)[0]})
            if n == 42000:      # the main path's largest hop (phase 5)
                per_call, seen = _device_kernels_per_call(
                    lambda: ops.ignorance_update(w, r, a))
                self.require(per_call == 1, f"ops.ignorance_update at n = "
                             f"{n}: {per_call} device kernels a call {seen}")
                self._kernel_rows(w, r, a, k_n, p_n, k_w, p_w)
        print(f"ignorance_plans cluster_limit={limit} [route, cluster, "
              f"ctas, tiles_per_cta] " + json.dumps(plans),
              flush=True)
        print("kernel_table " + json.dumps(rows), flush=True)
        floor = self.floor_ms = self._launch_floor()
        return (f"ignorance n in {ns}: update and unnormalized mode equal to "
                f"the plain versions bit for bit, two runs identical, one "
                f"device kernel a call at n = 42000 (cluster limit {limit}); "
                f"launch floor {floor:.4f} device ms; "
                + self._quantize_vs_plain() + "; "
                + self._int4_wire_vs_plain(floor))

    def _launch_floor(self) -> float:
        """The empty kernel of csrc/ignorance.cu through the same ctypes
        route, plain and as a cluster of 8: call ms and device ms.  Returns
        the plain launch's device ms."""
        from repro_torch.kernels import ignorance as ig
        out = {}
        for cluster in (1, 8):
            def fn():
                ig.launch_floor(self.dev, cluster)
            out[cluster] = {"ms": _cuda_time_ms(fn),
                            "device_ms": _kernel_device_ms(fn,
                                                           "empty_kernel")}
        print("launch_floor " + json.dumps(out), flush=True)
        return out[1]["device_ms"]

    def _quantize_vs_plain(self) -> str:
        """The wire channel's kernels against their plain versions on one
        generator on the card: q, scales and packed bytes exact, xhat equal
        by value, two runs the same bits."""
        torch = self.torch
        from repro_torch.comm.draws import ChannelDraws
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        gen = torch.Generator(device=self.dev).manual_seed(1)
        limit = q.cluster_limit(self.dev.index or 0)
        checked, timed, plans = 0, [], {}
        # global tiles on both sides of each boundary of the plan: one CTA
        # (1024), the cluster limit (8 and 16 CTAs), LARGE_TILE
        shapes = [(n,) for n in (1, 420, 1000, 1024, 1025, 10500, 42000,
                                 8192, 8193, 16384, 16385, 2 ** 18,
                                 2 ** 18 + 1, 2 ** 20, 2 ** 20 + 3)]
        # MIMIC's and Fashion's score blocks, global tiles, and the ragged
        # 1020- and 1023-element row tiles
        shapes += [(4500, 2), (18000, 10), (1024, 3), (2048, 10), (2040, 10),
                   (3069, 3)]
        for shape in shapes:
            block = len(shape) == 2
            kern = ops.quantize_dequant_block if block else ops.quantize_dequant
            plain = (q.quantize_dequant_block_plain if block
                     else q.quantize_dequant_plain)
            x = torch.rand(shape, generator=gen, device=self.dev) - 0.3
            for qmax in (127.0, 7.0):
                for u in (torch.rand(shape, generator=gen, device=self.dev),
                          torch.full(shape, 0.5, device=self.dev)):
                    got, want = kern(x, u, qmax), plain(x, u, qmax)
                    torch.cuda.synchronize()
                    self.require(torch.equal(got[1], want[1])
                                 and torch.equal(got[2], want[2]),
                                 f"quantize {shape} qmax={qmax}: q or "
                                 f"scales differ from the plain version")
                    self.require(torch.equal(got[0], want[0]),
                                 f"quantize {shape} qmax={qmax}: xhat "
                                 f"differs from the plain version")
                    again = kern(x, u, qmax)
                    self.require(all(torch.equal(a, b)
                                     for a, b in zip(again, got)),
                                 f"quantize {shape}: two runs differ")
                    checked += 1
            tile = (q.rows_for(*shape) * shape[1] if block
                    else q.tile_for(shape[0]))
            p = q.plan(tile, limit)
            plans[str(shape)] = [p.route, p.cluster, x.numel() // tile
                                 * (1 if p.route == "large" else p.cluster)]
            if shape in ((10500,), (42000,), (2 ** 20,), (2 ** 20 + 3,),
                         (4500, 2), (18000, 10)):
                row = {"shape": list(shape), "route": p.route,
                       "kernel_ms": _cuda_time_ms(lambda: kern(x, u, 127.0)),
                       "device_ms": _kernel_device_ms(
                           lambda: kern(x, u, 127.0), ""),
                       "plain_ms": _cuda_time_ms(lambda: plain(x, u, 127.0)),
                       "bound_ms": _bound_ms(13 * x.numel() + 4,
                                             8 * x.numel())[0]}
                timed.append(row)
            if shape in ((42000,), (18000, 10)):
                per_call, seen = _device_kernels_per_call(
                    lambda: kern(x, u, 127.0))
                self.require(per_call == 1, f"quantize {shape}: {per_call} "
                             f"device kernels a call {seen}")
            if shape == (42000,):
                self._quantize_row("quantize_dequant_tiles", x, u, kern,
                                   plain, "src/repro/kernels/quantize.py:73")
            if shape == (18000, 10):
                self._quantize_row("quantize_dequant_block", x, u, kern,
                                   plain, "src/repro/kernels/quantize.py:178")
        for m in (1, 2, 21001, 42000, 2 ** 20 + 1):
            qv = torch.randint(-8, 8, (m,), generator=gen, device=self.dev,
                               dtype=torch.int8)
            packed = ops.pack_int4(qv)
            torch.cuda.synchronize()
            self.require(torch.equal(packed, q.pack_int4_plain(qv)),
                         f"pack_int4 m={m}: bytes differ from the plain "
                         f"version")
            self.require(torch.equal(ops.pack_int4(qv), packed),
                         f"pack_int4 m={m}: two runs differ")
            back = ops.unpack_int4(packed, m)
            self.require(torch.equal(back, qv)
                         and torch.equal(q.unpack_int4_plain(packed, m), qv),
                         f"unpack_int4 m={m}: the round trip is not exact")
            checked += 1
            if m == 42000:          # a Fashion hop's int4 wire
                self._pack_rows(qv, packed)
        # the channel draws of a Fashion hop and score block, drawn on the
        # host and copied to the card
        key = [0, 0]
        draws = ChannelDraws()
        hop_ms = _host_time_ms(lambda: draws.hop(key, 0, 0).uniform(
            (42000,), self.dev))
        block_ms = _host_time_ms(lambda: draws.serve(key, 1).uniform(
            (18000, 10), self.dev))
        print(f"quantize_plans cluster_limit={limit} [route, cluster, "
              f"ctas] " + json.dumps(plans), flush=True)
        print("quantize_table " + json.dumps(timed), flush=True)
        print(f"draws_ms hop[42000]={hop_ms:.4f} block[18000,10]="
              f"{block_ms:.4f}", flush=True)
        return (f"quantize/pack/unpack: {checked} cases equal to the plain "
                f"versions (q, scales, bytes exact), two runs identical, "
                f"quantize one device kernel a call at (42000,) and "
                f"(18000, 10) (cluster limit {limit}); "
                f"draws to the card {hop_ms:.3f} ms a hop, {block_ms:.3f} ms "
                f"a score block")

    def _int4_wire_vs_plain(self, floor: float) -> str:
        """The int4 codec's fused encode (quantize with the pack as its
        epilogue) and decode (unpack with the dequantize) against their
        plain versions: bytes, scales and xhat bit for bit, decode = the
        quantize-dequant's xhat, two runs the same bits, the wire also
        read from offset views; one device kernel a call at the main
        path's payloads; ``int4_wire_table`` beside the parent route."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        gen = torch.Generator(device=self.dev).manual_seed(2)
        shapes = [(n,) for n in (1, 7, 420, 1024, 1025, 8192, 8193, 16384,
                                 16385, 10500, 42000, 42001, 2 ** 18 - 1,
                                 2 ** 18, 2 ** 18 + 1, 2 ** 20 + 3)]
        shapes += [(4500, 2), (18000, 10), (1024, 3), (2040, 10), (3069, 3)]
        table, checked = [], 0
        for shape in shapes:
            n = math.prod(shape)
            tile = (q.rows_for(*shape) * shape[1] if len(shape) == 2
                    else q.tile_for(n))
            x = (torch.rand(shape, generator=gen, device=self.dev) - 0.3) * 5
            for u in (torch.rand(shape, generator=gen, device=self.dev),
                      torch.full(shape, 0.5, device=self.dev)):
                packed, scales = ops.quantize_pack_int4(x, u, 7.0, tile)
                want_p, want_s = q.quantize_pack_int4_plain(x, u, 7.0, tile)
                xhat = ops.unpack_dequant_int4(packed, scales, n, tile)
                want = q.unpack_dequant_int4_plain(want_p, want_s, n, tile)
                roundtrip = q.quantize_dequant_plain(
                    x.reshape(-1), u.reshape(-1), 7.0, bn=tile)[0]
                torch.cuda.synchronize()
                self.require(torch.equal(packed, want_p)
                             and torch.equal(scales, want_s),
                             f"int4 encode {shape}: bytes or scales differ "
                             f"from the plain version")
                self.require(torch.equal(xhat.view(torch.int32),
                                         want.view(torch.int32))
                             and torch.equal(xhat, roundtrip),
                             f"int4 decode {shape}: xhat differs from the "
                             f"plain version or the roundtrip")
                again = ops.quantize_pack_int4(x, u, 7.0, tile)
                self.require(torch.equal(again[0], packed)
                             and torch.equal(again[1], scales)
                             and torch.equal(ops.unpack_dequant_int4(
                                 packed, scales, n, tile), xhat),
                             f"int4 wire {shape}: two runs differ")
                checked += 1
            lead = 1 + n % 3                     # an offset view of the wire
            buf = torch.empty(lead + packed.numel(), dtype=torch.int8,
                              device=self.dev)
            buf[lead:].copy_(packed)
            self.require(torch.equal(ops.unpack_dequant_int4(
                buf[lead:], scales, n, tile), xhat),
                f"int4 decode {shape}: an offset view decodes otherwise")
            xbuf = torch.empty(n + 1, device=self.dev)   # x off 8 bytes
            xbuf[1:].copy_(x.reshape(-1))
            got = ops.quantize_pack_int4(xbuf[1:].view(shape), u, 7.0, tile)
            self.require(torch.equal(got[0], packed)
                         and torch.equal(got[1], scales),
                         f"int4 encode {shape}: an offset view of x encodes "
                         f"otherwise")
            if shape in ((42000,), (18000, 10)):
                table.append(self._int4_wire_row(x, u, tile, floor))
            if shape == (42000,):       # a Fashion hop's int4 wire
                for name, key, line in (("quantize_pack_int4", "encode", 131),
                                        ("unpack_dequant_int4", "decode",
                                         150)):
                    r = table[-1][key]
                    self.kernels[name] = {
                        "source": "src/repro_torch/csrc/quantize.cu",
                        "replaces": f"src/repro/kernels/quantize.py:{line}",
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None}
        print("int4_wire_table " + json.dumps(table), flush=True)
        return (f"int4 wire: {checked} cases of the fused encode and "
                f"decode equal to the plain versions bit for bit (decode = "
                f"the quantize-dequant's xhat), two runs identical, offset "
                f"views; encode and decode one device kernel a call at "
                f"(42000,) and (18000, 10)")

    def _int4_wire_row(self, x, u, tile, floor) -> dict:
        """One ``int4_wire_table`` row: the fused encode and decode (call
        ms, device ms, device kernels a call, plain ms, bound ms, max abs
        err against the plain version) beside the quantize-dequant alone on
        the same inputs, the parent route's (the quantize-dequant then the
        pack; the unpack, a cast and a product) and the launch floor."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        n, tiles = x.numel(), x.numel() // tile
        packed, scales = ops.quantize_pack_int4(x, u, 7.0, tile)
        xhat = ops.unpack_dequant_int4(packed, scales, n, tile)
        qd = (ops.quantize_dequant_block if x.dim() == 2
              else ops.quantize_dequant)

        def parent_encode():        # the codec's default tiles, as ``tile``
            return ops.pack_int4(qd(x, u, 7.0)[1])

        def parent_decode():
            return (ops.unpack_int4(packed, n).to(torch.float32)
                    .reshape(-1, tile) * scales[:, None]).reshape(-1)

        self.require(torch.equal(parent_decode(), xhat)
                     and torch.equal(parent_encode(), packed),
                     f"int4 wire {tuple(x.shape)}: the parent route gives "
                     f"other bits")
        plain_p = q.quantize_pack_int4_plain(x, u, 7.0, tile)[0]
        plain_x = q.unpack_dequant_int4_plain(packed, scales, n, tile)
        fused = {  # name: (call, plain, max abs err, bytes, operations)
            "encode": (lambda: ops.quantize_pack_int4(x, u, 7.0, tile),
                       lambda: q.quantize_pack_int4_plain(x, u, 7.0, tile),
                       (packed.int() - plain_p.int()).abs().max(),
                       8 * n + (n + 1) // 2 + 4 * tiles, 8 * n),
            "decode": (lambda: ops.unpack_dequant_int4(packed, scales, n,
                                                       tile),
                       lambda: q.unpack_dequant_int4_plain(packed, scales, n,
                                                           tile),
                       (xhat - plain_x).abs().max(),
                       (n + 1) // 2 + 4 * tiles + 4 * n, 2 * n)}
        others = {"quantize_alone": lambda: qd(x, u, 7.0),
                  "parent_encode": parent_encode,
                  "parent_decode": parent_decode}
        row = {"shape": list(x.shape), "launch_floor_device_ms": floor}
        for name, fn in [*((k, v[0]) for k, v in fused.items()),
                         *others.items()]:
            per_call, seen = _device_kernels_per_call(fn)
            if name in fused:
                self.require(per_call == 1, f"int4 {name} {tuple(x.shape)}: "
                             f"{per_call} device kernels a call {seen}")
            row[name] = {"ms": _cuda_time_ms(fn),
                         "device_ms": _kernel_device_ms(fn, ""),
                         "kernels_a_call": per_call}
        for name, (_, plain, err, nbytes, ops_) in fused.items():
            bound, by = _bound_ms(nbytes, ops_)
            row[name].update(plain_ms=_cuda_time_ms(plain),
                             max_abs_err=float(err), bound_ms=bound,
                             bound_by=by)
        return row

    def _quantize_row(self, name, x, u, kern, plain, replaces) -> None:
        got, want = kern(x, u, 127.0), plain(x, u, 127.0)
        nbytes, ops_ = 13 * x.numel() + 4 * got[2].numel(), 8 * x.numel()
        bound, by = _bound_ms(nbytes, ops_)
        self.kernels[name] = {
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": replaces,
            "max_abs_err": float((got[0] - want[0]).abs().max()),
            "ms": _cuda_time_ms(lambda: kern(x, u, 127.0)),
            "device_ms": _kernel_device_ms(lambda: kern(x, u, 127.0), ""),
            "plain_ms": _cuda_time_ms(lambda: plain(x, u, 127.0)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}

    def _pack_rows(self, qv, packed) -> None:
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        m = qv.numel()
        bound, by = _bound_ms(m + packed.numel(), 4 * m)
        self.kernels["pack_int4"] = {
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:131",
            "max_abs_err": float((ops.pack_int4(qv).int()
                                  - q.pack_int4_plain(qv).int()).abs().max()),
            "ms": _cuda_time_ms(lambda: ops.pack_int4(qv)),
            "device_ms": _kernel_device_ms(lambda: ops.pack_int4(qv), ""),
            "plain_ms": _cuda_time_ms(lambda: q.pack_int4_plain(qv)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        self.kernels["unpack_int4"] = {
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:150",
            "max_abs_err": float((ops.unpack_int4(packed, m).int()
                                  - q.unpack_int4_plain(packed, m).int()
                                  ).abs().max()),
            "ms": _cuda_time_ms(lambda: ops.unpack_int4(packed, m)),
            "device_ms": _kernel_device_ms(lambda: ops.unpack_int4(packed, m),
                                           ""),
            "plain_ms": _cuda_time_ms(
                lambda: q.unpack_int4_plain(packed, m)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}

    def _kernel_rows(self, w, r, a, k_n, p_n, k_w, p_w) -> None:
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        n, nt = w.shape[0], ig.num_tiles(w.shape[0])
        bound, by = _bound_ms(4 * (3 * n + 1), 4 * n)
        self.kernels["ignorance_update"] = {
            "source": "src/repro_torch/csrc/ignorance.cu",
            "replaces": "src/repro/kernels/ignorance.py:46",
            "max_abs_err": float((k_n - p_n).abs().max()),
            "ms": _cuda_time_ms(lambda: ops.ignorance_update(w, r, a)),
            "device_ms": _kernel_device_ms(
                lambda: ops.ignorance_update(w, r, a), ""),
            "plain_ms": _cuda_time_ms(
                lambda: ig.ignorance_update_plain(w, r, a)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        b1, by1 = _bound_ms(4 * (3 * n + 1 + nt), 4 * n)
        self.kernels["ignorance_update_unnormalized"] = {
            "source": "src/repro_torch/csrc/ignorance.cu",
            "replaces": "src/repro/kernels/ignorance.py:46",
            "max_abs_err": float((k_w - p_w).abs().max()),
            "ms": _cuda_time_ms(
                lambda: ig.ignorance_update_unnormalized(w, r, a)),
            "device_ms": _kernel_device_ms(
                lambda: ig.ignorance_update_unnormalized(w, r, a), ""),
            "plain_ms": _cuda_time_ms(
                lambda: ig.ignorance_update_unnormalized_plain(w, r, a)),
            "bound_ms": b1, "bound_by": by1, "library_ms": None}

    def cli_path(self) -> str:
        torch = self.torch
        from repro_torch.launch import session as cli
        out = []
        for transport in ("metered", "meshring"):
            self.reset_counts()
            run = cli.run(cli.parser().parse_args(["--transport", transport]))
            st = run.session.state
            hops = len(st.components)
            self.read_counts(hops, f"cli {transport}")
            out.append(f"{transport}: {run.line}, launches={hops}")
            if transport != "metered":
                continue
            n, m = st.w.shape[0], len(run.session.endpoints)
            kinds = run.transport.log.bits_by_kind()
            train = (m - 1) * 2 * n * 32 + hops * (n + 1) * 32
            self.require(kinds["ignorance"] == hops * n * 32
                         and kinds["model_weight"] == hops * 32
                         and kinds["labels"] + kinds["sample_ids"]
                         == (m - 1) * 2 * n * 32,
                         f"ledger {kinds} != Fig.-4 formula")
            self.require(run.transport.total_bits - kinds["score_block"]
                         == train, "training bits != Fig.-4 formula")
            full_w = st.w.clone()
        ckpt = tempfile.mkdtemp(dir=SMOKE_DIR)
        try:
            self.reset_counts()
            base = ["--ckpt-dir", ckpt]
            paused = cli.run(cli.parser().parse_args(base + ["--stop-after",
                                                             "2"]))
            resumed = cli.run(cli.parser().parse_args(base + ["--resume"]))
            self.read_counts(len(resumed.session.state.components),
                             "cli pause/resume")
            self.require(paused.paused, "the run did not pause")
            self.require(torch.equal(resumed.session.state.w, full_w),
                         "resumed w is not bit-identical")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        return "; ".join(out) + "; Fig.-4 bits exact; resume bit-exact"

    def _split(self, ds, seed=0):
        torch = self.torch
        from repro_torch.data.partition import train_test_split, vertical_split
        tr, te = train_test_split(seed, ds.X.shape[0])
        tr = torch.as_tensor(tr, device=ds.X.device)
        te = torch.as_tensor(te, device=ds.X.device)
        Xs = vertical_split(ds.X, ds.splits)
        return ([x[tr] for x in Xs], ds.classes[tr], [x[te] for x in Xs],
                ds.classes[te])

    def mimic(self) -> str:
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import mimic_surrogate
        from repro_torch.learners.tree import DecisionTree
        runs = {}
        for device in ("cuda", "cpu"):   # the card, then its plain version
            ds = mimic_surrogate(torch.Generator().manual_seed(0), n=15000,
                                 device=device)
            Xtr, ctr, Xte, cte = self._split(ds)
            proto = E.Protocol(E.SessionConfig(num_classes=2, max_rounds=10),
                               transport=E.MeteredTransport(), device=device)
            eps = E.endpoints_for([DecisionTree(depth=4, num_thresholds=16,
                                                device=device)
                                   for _ in Xtr], Xtr)
            self.reset_counts()
            t0 = time.perf_counter()
            session = proto.start(0, eps, ctr)
            session.run()
            preds = session.fitted().predict(Xte)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if device == "cuda":
                self.read_counts(len(session.state.components), "mimic")
            runs[device] = (session, preds.cpu(), cte.cpu(), secs)
        g, c = runs["cuda"][0].state, runs["cpu"][0].state
        self.require([(x.agent, x.round) for x in g.components]
                     == [(x.agent, x.round) for x in c.components],
                     "components differ between card and CPU")
        ga = torch.tensor([x.alpha for x in g.components])
        ca = torch.tensor([x.alpha for x in c.components])
        torch.testing.assert_close(ga, ca, rtol=1e-5, atol=0)
        w_err = float((g.w.cpu() - c.w).abs().max())
        self.require(w_err <= 1e-6, f"w differs by {w_err} > 1e-6")
        agree = float((runs["cuda"][1] == runs["cpu"][1]).float().mean())
        self.require(agree >= 0.999, f"predictions agree {agree} < 0.999")
        acc = float((runs["cuda"][1] == runs["cuda"][2]).float().mean())
        return (f"mimic n_train=10500 agents=(3,13) depth=4 rounds=10: "
                f"components={len(g.components)} acc={acc:.4f} "
                f"card {runs['cuda'][3]:.2f} s, cpu {runs['cpu'][3]:.2f} s; "
                f"vs cpu: alpha rtol<=1e-5, w err {w_err:.3g}, "
                f"predictions agree {agree:.4f}")

    def fashion(self) -> str:
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.core.protocol import (ASCIIConfig,
                                               fit_single_agent_adaboost)
        from repro_torch.data.synthetic import fashion_surrogate
        from repro_torch.learners.logistic import LogisticRegression
        ds = fashion_surrogate(torch.Generator().manual_seed(0), n=60000,
                               device="cuda")
        Xtr, ctr, Xte, cte = self._split(ds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        learner = LogisticRegression(steps=300, device="cuda")
        proto = E.Protocol(E.SessionConfig(num_classes=10, max_rounds=5),
                           transport=E.MeteredTransport(), device="cuda")
        self.reset_counts()
        t0 = time.perf_counter()
        session = proto.start(0, E.endpoints_for([learner] * 2, Xtr), ctr)
        session.run()
        preds = session.fitted().predict(Xte)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        self.read_counts(len(session.state.components), "fashion")
        cfg = ASCIIConfig(num_classes=10, max_rounds=5)
        single = fit_single_agent_adaboost(0, Xtr[0], ctr, learner, cfg,
                                           device="cuda")
        oracle = fit_single_agent_adaboost(0, torch.cat(Xtr, 1), ctr, learner,
                                           cfg, device="cuda")

        def acc(p):
            return float((p == cte).float().mean())

        a_ascii = acc(preds)
        a_single = acc(single.predict([Xte[0]]))
        a_oracle = acc(oracle.predict([torch.cat(Xte, 1)]))
        st = session.state
        w_sum = float(st.w.sum())
        self.require(abs(w_sum - 1.0) <= 1e-5, f"w sums to {w_sum}")
        self.require(all(math.isfinite(c.alpha) for c in st.components),
                     "non-finite alpha")
        self.require(a_ascii >= a_single,
                     f"ASCII acc {a_ascii} < single-agent acc {a_single}")
        self.fashion_fp32 = (Xtr, ctr, Xte, cte, a_ascii,
                             [c.alpha for c in st.components])
        return (f"fashion n_train=42000 agents=(392,392) logistic steps=300 "
                f"rounds=5: components={len(st.components)} "
                f"acc ascii={a_ascii:.4f} single={a_single:.4f} "
                f"oracle={a_oracle:.4f}; session {secs:.2f} s, "
                f"peak device memory {peak_gib:.3f} GiB, "
                f"ledger {session.transport.total_bits} bits")

    # ------------------------------------------------------- wire channel
    def _channel_session(self, device: str, argv: list, ds_fn, cfg, learner):
        """One session through the CLI's transport for ``argv`` on
        ``device``: (session, transport, predict_distributed classes,
        fitted classes, test classes, seconds)."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.launch import session as cli
        args = cli.parser().parse_args(["--device", device, *argv])
        cli.check_args(args)
        transport = cli.make_transport(args)
        Xtr, ctr, Xte, cte = ds_fn(device)
        proto = E.Protocol(cfg, transport=transport, device=device)
        t0 = time.perf_counter()
        session = proto.start(0, E.endpoints_for(
            [learner(device) for _ in Xtr], Xtr), ctr)
        session.run()
        served = session.predict_distributed(Xte)
        fitted = session.fitted().predict(Xte)
        if device == "cuda":
            torch.cuda.synchronize()
        return (session, transport, served.cpu(), fitted.cpu(), cte.cpu(),
                time.perf_counter() - t0)

    @staticmethod
    def _int_codec_counts(transport) -> dict:
        """Expected quantize launches from the ledger: one per int-coded
        hop and one per int-coded score block."""
        from repro_torch.comm.codecs import QuantCodec

        def coded(entry, fixed):
            if "rung" in entry:
                return isinstance(transport.budget.ladder[entry["rung"]],
                                  QuantCodec)
            return isinstance(fixed, QuantCodec)
        log = transport.log.entries
        return {"quantize_dequant_tiles": sum(
                    coded(e, transport.codec) for e in log
                    if e["kind"] == "ignorance"),
                "quantize_dequant_block": sum(
                    coded(e, transport.effective_serve_codec) for e in log
                    if e["kind"] == "score_block")}

    @staticmethod
    def _check_wire_bits(transport, n: int, block: tuple) -> None:
        """Every wire-priced entry equals its codec's wire_bits formula."""
        for e in transport.log.entries:
            if e["kind"] not in ("ignorance", "score_block"):
                continue
            shape = n if e["kind"] == "ignorance" else block
            if "rung" in e:
                codec = transport.budget.ladder[e["rung"]]
            elif e["kind"] == "ignorance":
                codec = transport.codec
            else:
                codec = transport.effective_serve_codec
            want = 32 * (n if e["kind"] == "ignorance" else block[0] *
                         block[1]) if codec is None else codec.wire_bits(shape)
            if e["bits"] != want:
                raise AssertionError(f"ledger entry {e} != wire_bits {want}")

    def mimic_channel(self) -> str:
        torch = self.torch
        from repro_torch.comm.budget import BudgetSpec
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import mimic_surrogate
        from repro_torch.learners.tree import DecisionTree

        def data(device):
            ds = mimic_surrogate(torch.Generator().manual_seed(0), n=15000,
                                 device=device)
            return self._split(ds)

        n, m, n_te = 10500, 2, 4500
        costs = BudgetSpec().hop_costs(n)
        # setup, then one hop at each rung fp32, fp16, int8, int4, then
        # skips: the session ends exhausted
        budget_bits = (m - 1) * 2 * n * 32 + sum(costs) + 100
        configs = [["--codec", "int8"],
                   ["--codec", "int4", "--serve-codec", "int8"],
                   ["--codec", "topk"],
                   ["--dp-epsilon", "1.0", "--accountant", "rdp"],
                   ["--byte-budget", str(-(-budget_bits // 8))]]
        cfg = E.SessionConfig(num_classes=2, max_rounds=10)
        out = []
        for argv in configs:
            runs = {}
            for device in ("cuda", "cpu"):
                if device == "cuda":
                    self.reset_counts()
                runs[device] = self._channel_session(
                    device, argv, data, cfg,
                    lambda dev: DecisionTree(depth=4, num_thresholds=16,
                                             device=dev))
                if device == "cuda":
                    t = runs[device][1]
                    self.read_counts(
                        sum(e["kind"] == "ignorance" for e in t.log.entries),
                        f"mimic {' '.join(argv)}",
                        **self._int_codec_counts(t))
            (gs, gt, gserve, gfit, cte, gsec), (cs, ct, cserve, cfit, _,
                                                csec) = (runs["cuda"],
                                                         runs["cpu"])
            name = " ".join(argv)
            self.require(gt.log.entries == ct.log.entries,
                         f"{name}: card and CPU ledgers differ")
            self._check_wire_bits(gt, n, (n_te, 2))
            self.require((gs.state.round, gs.state.stopped)
                         == (cs.state.round, cs.state.stopped),
                         f"{name}: stop rounds differ")
            self.require([(c.agent, c.round) for c in gs.state.components]
                         == [(c.agent, c.round) for c in cs.state.components],
                         f"{name}: components differ")
            torch.testing.assert_close(
                torch.tensor([c.alpha for c in gs.state.components]),
                torch.tensor([c.alpha for c in cs.state.components]),
                rtol=1e-5, atol=0)
            self.require(torch.equal(gserve, cserve)
                         and torch.equal(gfit, cfit),
                         f"{name}: predictions differ between card and CPU")
            if gt.accountant is not None:
                self.require(gt.accountant.releases == ct.accountant.releases,
                             f"{name}: DP releases differ")
            rungs = ""
            if hasattr(gt, "budget"):
                self.require((gt.skipped, gt.exhausted)
                             == (ct.skipped, ct.exhausted) and gt.exhausted,
                             f"{name}: budget skips/exhaustion differ or the "
                             f"session did not end exhausted")
                used = sorted({e["rung"] for e in gt.log.entries
                               if "rung" in e})
                self.require(len(used) >= 3, f"{name}: rungs {used} < 3")
                rungs = f",rungs={used},skipped={len(gt.skipped)}"
            same_w = torch.equal(gs.state.w.cpu(), cs.state.w)
            acc = float((gserve == cte).float().mean())
            kinds = gt.log.bits_by_kind()
            out.append(f"[{name}] hops={len(gs.state.components)} "
                       f"ignorance_bits={kinds.get('ignorance', 0)} "
                       f"score_block_bits={kinds.get('score_block', 0)}"
                       f"{rungs} serve_acc={acc:.4f} w_bit_equal={same_w} "
                       f"card {gsec:.2f} s cpu {csec:.2f} s")
        return ("mimic through the wire channel, card = cpu (ledgers, "
                "wire_bits, stops, predictions exact; alphas rtol 1e-5): "
                + "; ".join(out))

    def fashion_channel(self) -> str:
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        self.require(self.fashion_fp32 is not None,
                     "phase 5's fp32 session did not run")
        Xtr, ctr, Xte, cte, a_fp32, alphas_fp32 = self.fashion_fp32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        session, t, served, fitted, cte, secs = self._channel_session(
            "cuda", ["--codec", "int8", "--serve-codec", "int4"],
            lambda device: (Xtr, ctr, Xte, cte),
            E.SessionConfig(num_classes=10, max_rounds=5),
            lambda dev: LogisticRegression(steps=300, device=dev))
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        # the int wires of a real hop's w: encode (int4: the quantize with
        # the pack fused in) then decode (int4: the unpack fused with the
        # dequantize) equals the fused roundtrip, and every element lies
        # within one quantization step of its input
        w = session.state.w
        draws = session.draws.hop(session.state.key, 0, 0)
        for bits in (4, 8):
            codec = QuantCodec(bits=bits)
            wire, _ = codec.encode(w, draws)
            decoded = codec.decode(wire)
            fused, _ = codec.roundtrip(w, draws)
            torch.cuda.synchronize()
            self.require(torch.equal(decoded, fused),
                         f"int{bits} encode -> decode != roundtrip on a "
                         f"hop's w")
            step = float(wire[1].max())
            self.require(float((decoded - w).abs().max()) <= step,
                         f"int{bits}: an element is more than one step "
                         f"({step}) from its input")
        counts = self._int_codec_counts(t)
        # int8's encode, both roundtrips; int4's encode and decode are one
        # launch each of the fused wire kernels
        counts["quantize_dequant_tiles"] += 3
        self.read_counts(sum(e["kind"] == "ignorance" for e in t.log.entries),
                         "fashion int8", quantize_pack_int4=1,
                         unpack_dequant_int4=1, **counts)
        self._check_wire_bits(t, Xtr[0].shape[0], tuple(served.shape) + (10,))
        alphas = [c.alpha for c in session.state.components]
        self.require(all(math.isfinite(a) for a in alphas),
                     "non-finite alpha")
        # the first fit sees the uniform w, before any hop crossed the wire
        self.require(alphas[0] == alphas_fp32[0],
                     f"first alpha {alphas[0]} != the fp32 session's "
                     f"{alphas_fp32[0]}")
        a_int8 = float((fitted == cte).float().mean())
        a_serve = float((served == cte).float().mean())
        # No accuracy bound against fp32: at this width the int8 global tile
        # zeroes most easy samples' weights, the next fits score r-bar = 1 on
        # what is left, and their capped alphas (20) dominate the vote.  The
        # reference does the same (tests/test_torch_comm_session.py::
        # test_fashion_int8_session_tracks_reference_on_card holds the
        # port's accuracy to the reference's on the card).
        kinds = t.log.bits_by_kind()
        return (f"fashion n_train=42000 agents=(392,392) rounds=5 --codec int8 "
                f"--serve-codec int4: acc ascii={a_int8:.4f} (fp32 phase 5 "
                f"{a_fp32:.4f}), served through int4 "
                f"{a_serve:.4f}; alphas int8 {[round(a, 3) for a in alphas]} "
                f"fp32 {[round(a, 3) for a in alphas_fp32]}; "
                f"ignorance_bits={kinds['ignorance']} score_block_bits="
                f"{kinds['score_block']} (= wire_bits); session {secs:.2f} s, "
                f"peak device memory {peak_gib:.3f} GiB; int4/int8 "
                f"encode->decode of a hop's w = roundtrip, within one step "
                f"(the fused int4 wire at n={w.numel()})")

    # ------------------------------------------------------- model zoo
    # The dense models' attention: (model, batch, H, KV, D, window);
    # danube's window of 4096 is cut to 128 so that it bites at S 512.
    FLASH_SHAPES = (("qwen3-0.6b", 4, 16, 8, 128, None),
                    ("h2o-danube-3-4b", 2, 32, 8, 120, 128),
                    ("gemma-7b", 2, 16, 16, 256, None))

    def flash_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        gen = torch.Generator(device=self.dev).manual_seed(2)
        tols = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
        worst, timed = {}, []
        sms = fd.sm_count(torch.cuda.current_device())
        split_s = 0.0           # the split kernel's own checks

        def randn(*shape, dtype):
            return torch.randn(*shape, generator=gen, device=self.dev).to(
                dtype)

        def check(what, key, got, again, want, vmax, tol):
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            self.require(err <= tol * vmax,
                         f"{what}: max err {err} > {tol} * {vmax}")
            self.require(torch.equal(got, again),
                         f"{what}: two runs differ")
            worst[key] = max(worst.get(key, 0.0), err / vmax)

        for model, b, h, kv, d, win in self.FLASH_SHAPES:
            cases = [(512, 512, win), (500, 500, win), (500, 512, win)]
            if win is None:
                cases.append((512, 512, 128))
            for dtype, tol in tols.items():
                for s, t, window in cases:
                    # the model's layout: [B, S, H, D] seen as [B, H, S, D]
                    q = randn(b, s, h, d, dtype=dtype).transpose(1, 2)
                    k = randn(b, t, kv, d, dtype=dtype).transpose(1, 2)
                    v = randn(b, t, kv, d, dtype=dtype).transpose(1, 2)
                    got = fa.flash_attention(q, k, v, window=window)
                    again = fa.flash_attention(q, k, v, window=window)
                    want = fa.flash_attention_plain(q, k, v, window=window)
                    check(f"flash_attention {model} {dtype} S={s} T={t} "
                          f"window={window}",
                          f"attention {model} {str(dtype)[6:]}", got, again,
                          want, float(v.float().abs().max()), tol)
                    if dtype == torch.bfloat16 and s == t == 512 \
                            and window == win:
                        timed.append(("attention", model, (q, k, v),
                                      window, got, want))
            for dtype, tol in tols.items():
                q = randn(b, h, d, dtype=dtype)
                for quant in (False, True):
                    if quant:
                        k, v = (torch.randint(-127, 128, (b, 576, kv, d),
                                              generator=gen, device=self.dev,
                                              dtype=torch.int8)
                                for _ in range(2))
                        ks, vs = (torch.rand(b, 576, kv, generator=gen,
                                             device=self.dev) * 0.05
                                  for _ in range(2))
                        scales = dict(k_scale=ks.transpose(1, 2),
                                      v_scale=vs.transpose(1, 2))
                        vmax = float((v.float() * vs[..., None]).abs().max())
                    else:
                        k = randn(b, 576, kv, d, dtype=dtype)
                        v = randn(b, 576, kv, d, dtype=dtype)
                        scales, vmax = {}, float(v.float().abs().max())
                    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                    for pos in (0, 511, 575):
                        for window in (None, 128):
                            got, again = (fd.flash_decode(
                                q, kt, vt, pos, window=window, **scales)
                                for _ in range(2))
                            want = fd.flash_decode_plain(
                                q, kt, vt, pos, window=window, **scales)
                            check(f"flash_decode {model} {dtype} quant="
                                  f"{quant} pos={pos} window={window}",
                                  f"decode {model} {str(dtype)[6:]}"
                                  f"{' int8' if quant else ''}", got, again,
                                  want, vmax, tol)
                            t0 = time.perf_counter()
                            self._split_vs_plain(
                                check, q, kt, vt, pos, window, scales, sms,
                                want, vmax, tol)
                            split_s += time.perf_counter() - t0
                    if dtype == torch.bfloat16 and (
                            model == "qwen3-0.6b" or not quant):
                        timed.append(("decode", model, (q, kt, vt), scales,
                                      got, want))
        # the decode grid at the serve shape's last step (pos 575)
        b, h, kv, d = self.FLASH_SHAPES[0][1:5]
        lo, hi = fd.valid_range(575, 576, None)
        gt = fd.heads_per_block(h // kv)
        kernel, n_split, chunk = fd.decode_plan(
            lo, hi, b * h // gt, sms, fd.rows_per_pass(torch.bfloat16, d))
        blocks = b * h // gt * n_split
        # the cluster kernel: a cluster of n_split blocks a row, every SM
        # a block or more
        self.require(gt == h // kv and kernel == "flash_decode_cluster"
                     and blocks >= sms,
                     f"flash_decode grid {blocks} blocks ({gt} heads a "
                     f"block, {kernel}) on {sms} SMs")
        # call times first, then the profiler's device times (so that no
        # call time is taken after a profiler session)
        rows = [self._flash_row(*row) for row in timed]
        table = [row for row, _ in rows]
        for (row, lib_fn), (kind, _, tensors, extra, _, _) in zip(rows,
                                                                  timed):
            key = "flash_attention" if kind == "attention" else "flash_decode"
            fn = self._flash_call(kind, tensors, extra)
            row["device_ms"] = _kernel_device_ms(lambda: fn(*tensors), key)
            row["library_device_ms"] = _kernel_device_ms(lib_fn, "")
            copies = [tuple(x.clone() for x in tensors)
                      for _ in range(max(2, -(-120 * 2 ** 20 // sum(
                          x.numel() * x.element_size() for x in tensors))))]
            turn = iter(range(10 ** 9))
            row["device_ms_cold"] = _kernel_device_ms(
                lambda: fn(*copies[next(turn) % len(copies)]), key)
        for row in table:
            if row["model"] == "qwen3-0.6b" and row.get("cache") != "int8":
                name = ("flash_attention" if "T" in row else "flash_decode")
                self.kernels[name] = {k: row[k] for k in (
                    "source", "replaces", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
        for row in table:
            for k in ("source", "replaces"):
                row.pop(k)
        print("flash_table " + json.dumps(table), flush=True)
        print("flash_scaling " + json.dumps(self._flash_scaling()),
              flush=True)
        return ("flash kernels = plain versions, two runs the same bits, at "
                "qwen3-0.6b's, h2o-danube-3-4b's and gemma-7b's shapes; max "
                "err / max|v|: " + ", ".join(f"{k} {v:.3g}"
                                             for k, v in worst.items())
                + f" (tolerance 2e-5 f32, 2^-7 bf16); decode grid {blocks} "
                f"blocks on {sms} SMs ({kernel}: {n_split} blocks of "
                f"{chunk} positions a row, {gt} query heads a block); the "
                f"split kernel held on its own plan in {split_s:.1f} s")

    def _split_vs_plain(self, check, q, k, v, pos, window, scales, sms,
                        want, vmax, tol) -> None:
        """The split kernel and its merge on the same inputs, on its own
        plan (``split_plan``), in both modes: ``decode_plan`` gives these
        shapes the cluster kernel, and the split kernel runs on long
        caches at batch 1 (``decode_plan``).  Its output held to the plain version as the wrapper's is,
        its lse within 1e-3 of the plain version's; two runs the same
        bits.  Not counted: ``_launch`` is below the wrappers' counts."""
        torch = self.torch
        from repro_torch.kernels import flash_decode as fd
        b, h, d = q.shape
        kv = k.shape[1]
        lo, hi = fd.valid_range(pos, k.shape[2], window)
        gt = fd.heads_per_block(h // kv)
        plan = fd.split_plan(lo, hi, b * h // gt, sms,
                             fd.rows_per_pass(k.dtype, d))
        ks, vs = scales.get("k_scale"), scales.get("v_scale")
        what = (f"split kernel {q.dtype} quant={ks is not None} B={b} "
                f"H={h} D={d} pos={pos} window={window}")
        key = (f"decode split {str(q.dtype)[6:]}"
               f"{' int8' if ks is not None else ''}")
        got, again = (fd._launch("flash_decode", q, k, v, ks, vs, lo, hi,
                                 *plan, gt, False) for _ in range(2))
        check(what, key, got, again, want, vmax, tol)
        (o, lse), (o2, lse2) = (fd._launch("flash_decode", q, k, v, ks, vs,
                                           lo, hi, *plan, gt, True)
                                for _ in range(2))
        want_o, want_lse = fd.flash_decode_plain(
            q, k, v, pos, window=window, return_lse=True, **scales)
        check(what + " shard mode", key, o, o2, want_o, vmax, tol)
        err = float((lse - want_lse).abs().max())
        self.require(err <= 1e-3, f"{what}: lse err {err} > 1e-3")
        self.require(torch.equal(lse, lse2), f"{what}: two runs' lse differ")

    def _flash_scaling(self) -> list:
        """bf16 flash_attention at qwen3-0.6b's heads (H 16, KV 8, D 128)
        over more batches, lengths and masks, each against its plain
        version (2^-7 max|v|): its device time and SDPA's beside the
        kernel's blocks (B * H * ceil(S / 64)) and live KV tiles of 64,
        which is how its time splits into a cost a block and a cost a
        tile."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa
        gen = torch.Generator(device=self.dev).manual_seed(3)
        rows = []
        for b, s, causal, window in (
                (4, 512, True, None), (8, 512, True, None),
                (16, 512, True, None), (4, 1024, True, None),
                (4, 2048, True, None), (4, 512, False, None),
                (4, 512, True, 64), (1, 512, True, None)):
            q, k, v = (torch.randn(b, s, h, 128, generator=gen,
                                   device=self.dev).to(torch.bfloat16)
                       .transpose(1, 2) for h in (16, 8, 8))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            err = float((got.float() - want.float()).abs().max())
            self.require(err <= 2 ** -7 * float(v.float().abs().max()),
                         f"flash_attention B={b} S={s} causal={causal} "
                         f"window={window}: max err {err}")
            row = {"B": b, "S": s, "causal": causal, "window": window,
                   "blocks": b * 16 * -(-s // 64),
                   "kv_tiles": b * 16 * _live_tiles(s, s, causal, window),
                   "device_ms": _kernel_device_ms(lambda: fa.flash_attention(
                       q, k, v, causal=causal, window=window),
                       "flash_attention")}
            if window is None:
                row["library_device_ms"] = _kernel_device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True), "")
            rows.append(row)
        return rows

    def _flash_call(self, kind, tensors, extra):
        """The kernel's wrapper with its options bound: f(q, k, v[, k_scale,
        v_scale]); decode at the serve path's last step (pos 575)."""
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        if kind == "attention":
            return lambda q, k, v: fa.flash_attention(q, k, v, window=extra)
        if extra:
            return lambda q, k, v: fd.flash_decode(q, k, v, 575, **extra)
        return lambda q, k, v: fd.flash_decode(q, k, v, 575)

    def _flash_row(self, kind, model, tensors, extra, got, want):
        """One bf16 row of flash_table: call ms (CUDA events around
        back-to-back calls), the plain version's, the library call's
        (F.scaled_dot_product_attention, a boolean mask where a window or a
        cache position needs one) and the bound of this input; and the
        library call, for its device time."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        q, k, v = tensors
        fn = self._flash_call(kind, tensors, extra)
        ms = _cuda_time_ms(lambda: fn(q, k, v), reps=100)
        if kind == "attention":
            b, h, s, d = q.shape
            t, window = k.shape[2], extra
            plain_ms = _cuda_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, window=window), reps=10, warmup=2)
            if window is None:
                def lib_fn():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
            else:
                rows = torch.arange(s, device=self.dev)[:, None] + (t - s)
                cols = torch.arange(t, device=self.dev)[None]
                mask = (cols <= rows) & (cols > rows - window)

                def lib_fn():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            ops_ = 4 * b * h * d * _attention_pairs(s, t, True, window)
            row = {"model": model, "S": s, "T": t, "window": window,
                   "source":
                   "src/repro_torch/csrc/flash_attention.cu", "replaces":
                   "src/repro/kernels/flash_attention.py:106"}
        else:
            b, h, d = q.shape
            kv, s = k.shape[1], k.shape[2]
            pos, scales = s - 1, extra
            got = fn(q, k, v)
            want = fd.flash_decode_plain(q, k, v, pos, **scales)
            plain_ms = _cuda_time_ms(lambda: fd.flash_decode_plain(
                q, k, v, pos, **scales), reps=50)
            if scales:  # SDPA on the dequantized copy (made outside timing)
                kl = (k.float() * scales["k_scale"][..., None]).to(q.dtype)
                vl = (v.float() * scales["v_scale"][..., None]).to(q.dtype)
            else:
                kl, vl = k, v
            mask = (torch.arange(s, device=self.dev) <= pos)[None, None,
                                                              None]
            q4 = q[:, :, None]

            def lib_fn():
                return F.scaled_dot_product_attention(
                    q4, kl, vl, attn_mask=mask, enable_gqa=True)
            valid = pos + 1
            cache_bytes = 2 * b * kv * valid * d * k.element_size()
            if scales:
                cache_bytes += 2 * b * kv * valid * 4
            nbytes = 2 * q.numel() * q.element_size() + cache_bytes
            ops_ = 4 * b * h * valid * d
            kernel = fd.decode_plan(
                0, pos, b * h // fd.heads_per_block(h // kv),
                fd.sm_count(torch.cuda.current_device()),
                fd.rows_per_pass(k.dtype, d))[0]
            row = {"model": model, "S": s, "pos": pos,
                   "cache": "int8" if scales else "bf16", "source":
                   f"src/repro_torch/csrc/{kernel}.cu", "replaces":
                   "src/repro/kernels/flash_decode.py:96"}
        lib_ms = _cuda_time_ms(lib_fn, reps=100)
        bound, by = _bound_ms(nbytes, ops_, BF16_OPS_PER_S)
        row.update({"dtype": "bf16", "max_abs_err": float(
            (got.float() - want.float()).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by})
        return row, lib_fn

    def serve(self) -> str:
        torch = self.torch
        from repro_torch.launch import serve as cli
        from repro_torch.models import api
        batch, prompt_len, gen = 4, 512, SERVE_GEN
        common = ["--arch", "qwen3-0.6b", "--no-reduced", "--use_flash",
                  "--batch", str(batch), "--prompt_len", str(prompt_len),
                  "--device", "cuda", "--seed", "0"]
        argv = common + ["--gen", str(gen)]
        # warm-up at the same prompt (libraries, cuBLAS plans); not counted
        warm = cli.run(cli.parser().parse_args(common + ["--gen", "2"]))
        params, layers, steps = warm.params, warm.cfg.num_layers, gen - 1
        self.require(warm.cfg.d_model == 1024 and layers == 28
                     and warm.cfg.dtype == "bfloat16",
                     f"not qwen3-0.6b at full width: {warm.cfg}")
        out, runs = [], {}
        for name, extra in (("fp", []), ("kv_quant", ["--kv_quant"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            run = cli.run(cli.parser().parse_args(argv + extra), params)
            self.read_counts(0, f"serve {name}", flash_attention=layers,
                             flash_decode=layers * steps)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            toks = run.tokens
            self.require(tuple(toks.shape) == (batch, gen)
                         and int(toks.min()) >= 0
                         and int(toks.max()) < run.cfg.vocab_size,
                         f"serve {name}: tokens {tuple(toks.shape)} out of "
                         f"range")
            runs[name] = run
            out.append(f"[{name}] prefill {run.prefill_s * 1e3:.2f} ms, "
                       f"decode {run.decode_s * 1e3 / steps:.3f} ms/step, "
                       f"{steps * batch / run.decode_s:.1f} tok/s, peak "
                       f"device memory {peak_gib:.3f} GiB; "
                       f"{run.lines[0]}; {run.lines[1]}")
        profile = {name: self._profile(api, runs["fp"], quant)
                   for name, quant in (("fp", False), ("kv_quant", True))}
        print("serve_profile " + json.dumps(profile), flush=True)
        errs = {name: self._teacher_forced(api, runs["fp"], quant)
                for name, quant in (("fp", False), ("kv_quant", True))}
        return ("qwen3-0.6b full width (28 layers, bf16, 596049920 params) "
                f"batch {batch} prompt {prompt_len} gen {gen} --use_flash: "
                + "; ".join(out) + "; teacher-forced, worst max|dlogits| / "
                "max|logits| against the float32 einsum path (use_flash="
                "False): " + "; ".join(
                    f"[{name}] " + ", ".join(f"{k} {v:.4g}"
                                             for k, v in e.items())
                    for name, e in errs.items()))

    def _profile(self, api, run, quant: bool,
                 steps: int = PROFILE_STEPS) -> dict:
        """torch.profiler over one prefill and ``steps`` decode steps of the
        flash path on one run's weights and tokens: wall ms (host clock,
        under the profiler), the device's kernel and copy ms, its idle
        share, and the top kernels by device time, for each window."""
        cfg, params = run.cfg, run.params
        s = run.prompt.shape[1]
        out, caches = {}, None

        def prefill():
            nonlocal caches
            _, c = api.make_prefill_step(cfg)(params, {"tokens": run.prompt})
            c = api.pad_prefill_cache(c, cfg, s + run.tokens.shape[1])
            caches = api.quantize_cache(c, cfg) if quant else c

        def decode():
            for i in range(steps):
                api.decode_step(params, caches, run.tokens[:, i:i + 1], s + i,
                                cfg)

        for window, fn in (("prefill", prefill), (f"decode x{steps}", decode)):
            out[window] = _device_profile(fn)
        return out

    def _teacher_forced(self, api, run, quant: bool) -> dict:
        """One run's weights, prompt and continuation through four paths:
        the flash kernels and the einsum attention (use_flash=False), each
        in bf16 and with the weights in float32.  Prefill, then every
        decode step fed the same token.  The float32 einsum path is the
        reference: the float32 flash path must be within 1e-4 max|logits|
        of it (1e-3 with the int8 cache, whose values at a rounding
        boundary follow ulps of K), and the bf16 flash path no further
        from it than 1.25 times the bf16 einsum path.  Returns the worst
        max|dlogits| / max|logits| of each comparison."""
        torch = self.torch
        batch, s = run.prompt.shape
        s_cache = s + run.tokens.shape[1]

        def up(tree):
            return {k: up(v) if isinstance(v, dict) else v.float()
                    for k, v in tree.items()}

        cfg, p32 = run.cfg, up(run.params)
        paths = {"flash_bf16": (cfg, run.params),
                 "einsum_bf16": (cfg.with_overrides(use_flash=False),
                                 run.params),
                 "flash_f32": (cfg.with_overrides(dtype="float32"), p32),
                 "einsum_f32": (cfg.with_overrides(use_flash=False,
                                                   dtype="float32"), p32)}
        f32_bound = 1e-3 if quant else 1e-4
        worst = {"flash_f32": 0.0, "flash_bf16": 0.0, "einsum_bf16": 0.0,
                 "flash_vs_einsum_bf16": 0.0}

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())

        def check(out, where):
            ref = out["einsum_f32"]
            err = {n: rel(out[n], ref)
                   for n in ("flash_f32", "flash_bf16", "einsum_bf16")}
            err["flash_vs_einsum_bf16"] = rel(out["flash_bf16"],
                                              out["einsum_bf16"])
            tag = f"teacher-forced {where} quant={quant}"
            self.require(all(math.isfinite(e) for e in err.values()),
                         f"{tag}: non-finite logits {err}")
            self.require(err["flash_f32"] <= f32_bound,
                         f"{tag}: float32 flash path {err['flash_f32']} > "
                         f"{f32_bound} max|logits| from the einsum path")
            self.require(err["flash_bf16"] <= 1.25 * err["einsum_bf16"],
                         f"{tag}: bf16 flash path {err['flash_bf16']} from "
                         f"float32 > 1.25 x the bf16 einsum path's "
                         f"{err['einsum_bf16']}")
            for n, e in err.items():
                worst[n] = max(worst[n], e)

        caches, out = {}, {}
        for name, (c, p) in paths.items():
            lg, cache, _ = api.forward(p, {"tokens": run.prompt}, c)
            cache = api.pad_prefill_cache(cache, c, s_cache)
            caches[name] = api.quantize_cache(cache, c) if quant else cache
            out[name] = lg
        check(out, "prefill")
        del out
        for i in range(run.tokens.shape[1] - 1):
            tok = run.tokens[:, i:i + 1]
            check({name: api.decode_step(p, caches[name], tok, s + i, c)[0]
                   for name, (c, p) in paths.items()}, f"step {i}")
        return worst

    # ------------------------------------------------------ weighted CE
    def ce_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.configs.registry import ARCHS
        from repro_torch.data.synthetic import token_stream
        from repro_torch.kernels import weighted_ce as wce
        from repro_torch.launch.train import PRESETS
        from repro_torch.models import api
        gen = torch.Generator(device=self.dev).manual_seed(3)
        host = torch.Generator().manual_seed(3)
        cases = []
        # the training path's rows: [B, S, V] logits as the loss hands them
        for name, cfg in (("qwen3-0.6b", ARCHS["qwen3-0.6b"]),
                          ("100m", PRESETS["100m"])):
            b, s, v = 8, 256, cfg.vocab_size
            dtype = getattr(torch, cfg.dtype)
            logits = (torch.randn(b, s, v, generator=gen, device=self.dev)
                      * 2).to(dtype)
            batch = {"tokens": token_stream(host, vocab_size=v, batch=b,
                                            seq_len=s, device=self.dev),
                     "sample_weight": torch.rand(b, generator=gen,
                                                 device=self.dev) + 0.5}
            cases.append((name, *api.next_token_rows(logits, batch, cfg)))
        for t, v in ((2040, 1000), (7, 3)):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(t, v, generator=gen, device=self.dev)
                     * 3).to(dtype)
                lab = torch.randint(0, v, (t,), generator=gen,
                                    device=self.dev, dtype=torch.int32)
                w = torch.rand(t, generator=gen, device=self.dev)
                w[::5] = 0.0
                cases.append((f"{t}x{v} {str(dtype)[6:]}", x, lab, w))
        worst, table = {}, []
        for name, x, lab, w in cases:
            g = torch.full_like(w, 1.0 / float(w.sum()))  # the loss's g
            loss, lse = wce.weighted_ce_fwd(x, lab, w)
            ploss, plse = wce.weighted_ce_fwd_plain(x, lab, w)
            d = wce.weighted_ce_bwd(x, lab, w, lse, g)
            pd = wce.weighted_ce_bwd_plain(x, lab, w, lse, g)
            torch.cuda.synchronize()
            rel = max(float(((a - p).abs() / (1e-5 * p.abs() + 1e-6)).max())
                      for a, p in ((loss, ploss), (lse, plse)))
            self.require(rel <= 1.0, f"weighted_ce_fwd {name}: loss or lse "
                         f"beyond rtol 1e-5 (+ atol 1e-6) of the plain "
                         f"version (ratio {rel})")
            elem, row = _dlogits_ratios(d, pd, w, g)
            self.require(elem <= 1.0 and row <= 1.0,
                         f"weighted_ce_bwd {name}: dlogits beyond the plain "
                         f"version's by {elem} of the element tolerance, "
                         f"row sums {row} of theirs")
            again = wce.weighted_ce_fwd(x, lab, w)
            self.require(torch.equal(again[0], loss)
                         and torch.equal(again[1], lse)
                         and torch.equal(wce.weighted_ce_bwd(x, lab, w, lse,
                                                             g), d),
                         f"weighted_ce {name}: two runs differ")
            worst[name] = (float(((loss - ploss).abs()
                                  / ploss.abs().clamp(min=1e-30)).max()),
                           elem, row)
            if name in ("qwen3-0.6b", "100m"):
                table.append(self._ce_row(name, x, lab, w, g, loss, ploss,
                                          d, pd))
        print("ce_table " + json.dumps(table), flush=True)
        return ("weighted_ce kernels = plain versions, two runs identical; "
                "max rel err loss, dlogits element and row-sum errors as "
                "shares of their tolerances: "
                + ", ".join(f"{k} {a:.3g} {b:.3g} {c:.3g}"
                            for k, (a, b, c) in worst.items())
                + " (loss rtol 1e-5; dlogits rtol 2^-7 bf16, 1e-5 f32, "
                "per element, row sums 0 within the same share of |w g|)")

    def _ce_row(self, name, x, lab, w, g, loss, ploss, d, pd) -> dict:
        """Times at a training shape: both kernels, their plain versions,
        F.cross_entropy (reduction='none') forward, its backward through
        autograd (the graph kept), and both together; the qwen3 row is the
        kernels' JSON rows."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import weighted_ce as wce
        t, v = x.shape
        lse = wce.weighted_ce_fwd(x, lab, w)[1]
        fwd_ms = _cuda_time_ms(lambda: wce.weighted_ce_fwd(x, lab, w),
                               reps=50)
        bwd_ms = _cuda_time_ms(lambda: wce.weighted_ce_bwd(x, lab, w, lse, g),
                               reps=50)
        pfwd_ms = _cuda_time_ms(lambda: wce.weighted_ce_fwd_plain(x, lab, w),
                                reps=10, warmup=2)
        pbwd_ms = _cuda_time_ms(
            lambda: wce.weighted_ce_bwd_plain(x, lab, w, lse, g), reps=10,
            warmup=2)
        lab64 = lab.long()
        xg = x.detach().requires_grad_(True)
        lib_fwd = _cuda_time_ms(lambda: F.cross_entropy(
            xg.detach(), lab64, reduction="none"), reps=50)
        nll = F.cross_entropy(xg, lab64, reduction="none")
        lib_bwd = _cuda_time_ms(lambda: torch.autograd.grad(
            nll, xg, g, retain_graph=True), reps=50)
        del nll

        def both():
            torch.autograd.grad(F.cross_entropy(xg, lab64, reduction="none"),
                                xg, g)
        lib_both = _cuda_time_ms(both, reps=50)
        esize = x.element_size()
        b_fwd, by_fwd = _bound_ms(t * v * esize + 16 * t, 4 * t * v)
        b_bwd, by_bwd = _bound_ms(2 * t * v * esize + 16 * t, 4 * t * v)
        fwd_dev = _kernel_device_ms(lambda: wce.weighted_ce_fwd(x, lab, w),
                                    "wce_fwd", 50)
        bwd_dev = _kernel_device_ms(
            lambda: wce.weighted_ce_bwd(x, lab, w, lse, g), "wce_bwd", 50)
        row = {"shape": name, "T": t, "V": v, "dtype": str(x.dtype)[6:],
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_device_ms": fwd_dev,
               "bwd_device_ms": bwd_dev, "plain_fwd_ms": pfwd_ms,
               "plain_bwd_ms": pbwd_ms, "cross_entropy_fwd_ms": lib_fwd,
               "cross_entropy_bwd_ms": lib_bwd,
               "cross_entropy_fwd_bwd_ms": lib_both, "fwd_bound_ms": b_fwd,
               "bwd_bound_ms": b_bwd, "bound_by": by_fwd}
        if name == "qwen3-0.6b":     # the training path's main shape
            self.kernels["weighted_ce_fwd"] = {
                "source": "src/repro_torch/csrc/weighted_ce.cu",
                "replaces": "src/repro/kernels/weighted_ce.py:68",
                "max_abs_err": float((loss - ploss).abs().max()),
                "ms": fwd_ms, "device_ms": fwd_dev,
                "plain_ms": pfwd_ms, "bound_ms": b_fwd,
                "bound_by": by_fwd, "library_ms": lib_fwd}
            self.kernels["weighted_ce_bwd"] = {
                "source": "src/repro_torch/csrc/weighted_ce.cu",
                "replaces": "src/repro/kernels/weighted_ce.py:113",
                "max_abs_err": float((d.float() - pd.float()).abs().max()),
                "ms": bwd_ms, "device_ms": bwd_dev,
                "plain_ms": pbwd_ms, "bound_ms": b_bwd,
                "bound_by": by_bwd, "library_ms": lib_bwd}
        return row

    # ------------------------------------------------------------ train
    def train(self) -> str:
        torch = self.torch
        from repro_torch.launch import train as cli
        from repro_torch.models import api
        steps = 20
        torch.cuda.synchronize()
        self.reset_counts()
        run = cli.run(cli.parser().parse_args(
            ["--arch", "qwen3-0.6b", "--steps", str(steps), "--device",
             "cuda", "--seed", "0"]))
        self.read_counts(0, "train qwen3-0.6b", weighted_ce_fwd=steps,
                         weighted_ce_bwd=steps)
        cfg = run.cfg
        n_params = api.count_params(run.params)
        self.require(cfg.num_layers == 28 and cfg.d_model == 1024
                     and cfg.dtype == "bfloat16" and n_params == 596049920,
                     f"not qwen3-0.6b at full width: {cfg}, {n_params}")
        losses = [h["loss"] for h in run.history]
        self.require(len(losses) == steps
                     and all(math.isfinite(x) for x in losses),
                     f"train qwen3-0.6b: losses {losses}")
        median_ms = statistics.median(run.step_s[1:]) * 1e3
        tokens = 8 * 256
        out = (f"qwen3-0.6b full width (28 layers, bf16, {n_params} params) "
               f"batch 8 seq 256, {steps} steps: step {median_ms:.2f} ms "
               f"(median after the first; first {run.step_s[0] * 1e3:.1f} "
               f"ms), {tokens / median_ms * 1e3:.1f} tokens/s, peak device "
               f"memory {run.peak_bytes / 2 ** 30:.3f} GiB, loss "
               f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        print("train_profile " + json.dumps(self._train_profile(run)),
              flush=True)
        out += "; " + self._kernel_vs_plain_step(run)
        self.reset_counts()
        pre = cli.run(cli.parser().parse_args(
            ["--preset", "100m", "--steps", str(PRESET_STEPS), "--device",
             "cuda", "--seed", "0"]))
        self.read_counts(0, "train 100m", weighted_ce_fwd=PRESET_STEPS,
                         weighted_ce_bwd=PRESET_STEPS)
        first, last = pre.history[0]["loss"], pre.history[-1]["loss"]
        self.require(all(math.isfinite(h["loss"]) for h in pre.history)
                     and last < first,
                     f"100m preset: loss {first} -> {last} did not fall")
        pre_ms = statistics.median(pre.step_s[1:]) * 1e3
        return (out + f"; 100m preset (float32, {api.count_params(pre.params)}"
                f" params) {PRESET_STEPS} steps: loss {first:.4f} -> "
                f"{last:.4f} "
                f"(improved), step {pre_ms:.2f} ms, "
                f"{tokens / pre_ms * 1e3:.1f} tokens/s, peak "
                f"{pre.peak_bytes / 2 ** 30:.3f} GiB")

    def _train_batch(self, cfg, seed: int) -> dict:
        torch = self.torch
        from repro_torch.data.synthetic import token_stream
        gen = torch.Generator().manual_seed(seed)
        return {"tokens": token_stream(gen, vocab_size=cfg.vocab_size,
                                       batch=8, seq_len=256, device=self.dev),
                "sample_weight": (torch.rand(8, generator=gen)
                                  + 0.5).to(self.dev)}

    def _train_profile(self, run) -> dict:
        """torch.profiler on the run's weights (the CLI's optimizer): two
        whole train steps, then one step's forward + backward and its
        optimizer update alone; for each, wall and device ms, idle share,
        device ms by kind, top kernels."""
        from repro_torch.models import api
        from repro_torch.optim.optimizers import adamw
        from repro_torch.optim.schedules import cosine_with_warmup
        opt = adamw(cosine_with_warmup(3e-4, 5, 20), weight_decay=0.01,
                    grad_clip_norm=1.0)
        step = api.make_train_step(run.cfg, opt)
        batch = self._train_batch(run.cfg, 7)
        state = {"p": run.params, "s": opt.init(run.params)}

        def two_steps():
            for i in range(2):
                state["p"], state["s"], _ = step(state["p"], state["s"],
                                                 batch, 10 + i)

        def fwd_bwd():
            state["g"] = api.loss_and_grads(state["p"], batch, run.cfg)[1]

        def update():
            opt.update(state["g"], state["s"], state["p"], 12)

        two_steps()                      # warm: the optimizer's first use
        return {"two steps": _device_profile(two_steps, top=12),
                "forward+backward": _device_profile(fwd_bwd),
                "optimizer update": _device_profile(update)}

    def _step_pair(self, cfg, params, batch) -> dict:
        """One forward of the train step, then its loss and gradients
        through the kernels and through the plain versions on the same
        logits: the losses, the logits' gradients as phase 10's ratios to
        their tolerances, and the whole gradient's and the worst leaf's
        relative L2 error and the two global norms."""
        torch = self.torch
        from repro_torch.kernels import weighted_ce as wce
        from repro_torch.models import api
        from repro_torch.optim.optimizers import tree_leaves
        loss_k, grads_k, _, logits, leaves = api.loss_and_grads(
            params, batch, cfg, retain_graph=True)
        dl_k = torch.autograd.grad(loss_k, logits, retain_graph=True)[0]
        rows, lab, w = api.next_token_rows(logits, batch, cfg)
        loss_p = (wce.weighted_ce_fwd_plain(rows, lab, w)[0].sum()
                  / w.sum().clamp(min=1e-9))
        dl_p = torch.autograd.grad(loss_p, logits, retain_graph=True)[0]
        grads_p = torch.autograd.grad(loss_p, leaves)
        v = logits.shape[-1]
        g = torch.full_like(w, 1.0 / max(float(w.sum()), 1e-9))
        elem, row = _dlogits_ratios(dl_k.reshape(-1, v), dl_p.reshape(-1, v),
                                    w, g)
        del dl_k, dl_p, logits, leaves
        sq_k = sq_p = sq_d = 0.0
        leaf = 0.0
        for gk, gp in zip(tree_leaves(grads_k), grads_p):
            gk, gp = gk.double(), gp.double()
            dk, dp, dd = (float(torch.sum(a * a))
                          for a in (gk, gp, gk - gp))
            sq_k, sq_p, sq_d = sq_k + dk, sq_p + dp, sq_d + dd
            leaf = max(leaf, math.sqrt(dd / max(dp, 1e-300)))
        return {"loss": (float(loss_k.detach()), float(loss_p.detach())),
                "dlogits": (elem, row),
                "norm": (math.sqrt(sq_k), math.sqrt(sq_p)),
                "whole": math.sqrt(sq_d / sq_p), "leaf": leaf}

    def _kernel_vs_plain_step(self, run) -> str:
        """One step's loss and gradients on the run's weights and a fresh
        batch: the loss through the kernels (the train step's) against the
        plain versions' on the same logits.

        The two paths differ only in the logits' gradient, held per element
        by phase 10's rule; the rest of the backward is the same code.  In
        bf16 (the run's weights) the loss is held to rtol 1e-5, the global
        gradient norm to 1e-3, and the whole gradient's and each leaf's
        relative L2 error to 2^-5: the bf16 roundings of a 28-layer
        backward turn an ulp of difference in the logits' gradient into
        about 1 % in the leaves.  So the same weights are also cast to
        float32, where those roundings are 2^16 times finer, and there
        the whole gradient and each leaf are held to 1e-4."""
        torch = self.torch
        from repro_torch.optim.optimizers import tree_map
        batch = self._train_batch(run.cfg, 11)
        out = []
        for dtype, grad_tol in (("bfloat16", 2.0 ** -5), ("float32", 1e-4)):
            cfg = run.cfg.with_overrides(dtype=dtype)
            params = tree_map(lambda p: p.detach().to(getattr(torch, dtype)),
                              run.params)
            r = self._step_pair(cfg, params, batch)
            del params
            (lk, lp), (nk, np_) = r["loss"], r["norm"]
            self.require(abs(lk - lp) <= 1e-5 * abs(lp),
                         f"{dtype}: kernel loss {lk} != plain {lp} "
                         f"(rtol 1e-5)")
            self.require(abs(nk - np_) <= 1e-3 * np_,
                         f"{dtype}: kernel grad norm {nk} != plain {np_} "
                         f"(rtol 1e-3)")
            self.require(max(r["dlogits"]) <= 1.0,
                         f"{dtype}: the logits' gradient beyond phase 10's "
                         f"rule: {r['dlogits']}")
            self.require(r["whole"] <= grad_tol and r["leaf"] <= grad_tol,
                         f"{dtype}: kernel gradients != plain: relative "
                         f"error {r['whole']}, worst leaf {r['leaf']} "
                         f"(tolerance {grad_tol:.3g})")
            out.append(f"[{dtype}] loss {lk:.6f} vs {lp:.6f}, grad norm "
                       f"{nk:.6g} vs {np_:.6g}, dlogits element / row-sum "
                       f"shares {r['dlogits'][0]:.3g} / "
                       f"{r['dlogits'][1]:.3g}, gradient relative error "
                       f"{r['whole']:.3g}, worst leaf {r['leaf']:.3g} "
                       f"(tolerance {grad_tol:.3g})")
        return "kernel step = plain step on the same logits: " + "; ".join(out)


    # ------------------------------------------------- the paper's learners
    def _fashion_data(self):
        """Phase 5's split of the Fashion surrogate, or a fresh one when
        phase 5 did not run (the same seed: the same data)."""
        torch = self.torch
        if self.fashion_fp32 is not None:
            return self.fashion_fp32[:4]
        from repro_torch.data.synthetic import fashion_surrogate
        ds = fashion_surrogate(torch.Generator().manual_seed(0), n=60000,
                               device="cuda")
        return self._split(ds)

    def _timed_fits(self, endpoints) -> list:
        """Wrap each endpoint's fit with a synchronized host clock; returns
        the list the fit times (ms) go into."""
        torch = self.torch
        times = []
        for ep in endpoints:
            inner = ep.fit_local

            def fit_local(*a, _inner=inner, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _inner(*a, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                return out
            ep.fit_local = fit_local
        return times

    @staticmethod
    def _logits_gap(card, cpu, tol) -> dict:
        """Card logits against the CPU's: the largest difference, and
        whether every parted prediction is a row whose top-2 gap is within
        ``tol``."""
        top2 = cpu.topk(2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= tol
        parted = card.argmax(-1) != cpu.argmax(-1)
        return {"max_err": float((card - cpu).abs().max()),
                "parted": int(parted.sum()),
                "parted_off_near_ties": int((parted & ~near).sum())}

    def _mlp_fit_limit(self, Xtr, ctr):
        """12(a)'s limit on an MLP fit's logits: 3x the CPU's own spread,
        the largest distance of the CPU's fit (agent 0's half, uniform w,
        the draws of fit (0, 0) of key 0) on each of two row permutations
        from its fit on the rows in order.  Returns (limit, spread, {"cpu":
        the CPU's logits}), read once a run."""
        if self.mlp_limit is not None:
            return self.mlp_limit
        torch = self.torch
        from repro_torch.comm.draws import ChannelDraws
        from repro_torch.core import engine as E
        from repro_torch.learners.mlp import MLP
        draws = ChannelDraws().fit(E.key_data(0), 0, 0)
        w = torch.full((ctr.shape[0],), 1.0 / ctr.shape[0])
        X, c = Xtr[0].cpu(), ctr.cpu()
        lr = MLP(hidden=(128, 64), steps=200, device="cpu")
        logits = {}
        fits = [("cpu", slice(None))] + [(f"cpu_perm{i}", torch.randperm(
            c.shape[0], generator=torch.Generator().manual_seed(i)))
            for i in (1, 2)]
        for name, rows in fits:
            params = lr.fit(draws, X[rows], c[rows], w[rows], 10)
            logits[name] = lr.core(10).logits(params, X).detach()
        spread = max(float((logits[f"cpu_perm{i}"] - logits["cpu"]).abs()
                           .max()) for i in (1, 2))
        self.mlp_limit = (3 * spread, spread, {"cpu": logits["cpu"]})
        return self.mlp_limit

    def learners(self) -> str:
        out = [self._fashion_mlp(), self._blob_forest(),
               self._heterogeneous(), self._neural_backbone()]
        return "; ".join(out)

    def _fashion_mlp(self) -> str:
        """(a) The paper's 3-layer network on the Fashion halves (Fig. 5)
        at full width, through the session, on the card."""
        torch = self.torch
        from repro_torch.comm.draws import ChannelDraws
        from repro_torch.core import engine as E
        from repro_torch.core.protocol import (ASCIIConfig,
                                               fit_single_agent_adaboost)
        from repro_torch.learners.mlp import MLP
        Xtr, ctr, Xte, cte = self._fashion_data()
        learner = MLP(hidden=(128, 64), steps=200, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        proto = E.Protocol(E.SessionConfig(num_classes=10, max_rounds=5),
                           transport=E.MeteredTransport(), device="cuda")
        eps = E.endpoints_for([learner] * 2, Xtr)
        fit_ms = self._timed_fits(eps)
        self.reset_counts()
        t0 = time.perf_counter()
        session = proto.start(0, eps, ctr)
        session.run()
        preds = session.fitted().predict(Xte)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        st = session.state
        self.read_counts(len(st.components), "fashion mlp")
        single = fit_single_agent_adaboost(
            0, Xtr[0], ctr, learner, ASCIIConfig(num_classes=10,
                                                 max_rounds=5),
            device="cuda")
        a_ascii = float((preds == cte).float().mean())
        a_single = float((single.predict([Xte[0]]) == cte).float().mean())
        self.require(all(math.isfinite(c.alpha) for c in st.components),
                     "non-finite alpha")
        self.require(a_ascii > a_single, f"ASCII acc {a_ascii} <= single-"
                     f"agent acc {a_single}")
        # one fit on the card and on the CPU from the same draws.  The limit
        # is the float32 trajectory's own sensitivity, read in this run:
        # the CPU's fit on row-permuted data (the same math summed in
        # another order) is that far from its fit on the rows in order;
        # the card may be 3x as far.  A card fit with TF32 matmuls on (a
        # 10-bit mantissa) is the control the limit must refuse.
        draws = ChannelDraws().fit(E.key_data(0), 0, 0)
        w = torch.full((ctr.shape[0],), 1.0 / ctr.shape[0], device="cuda")
        tol, spread, cpu = self._mlp_fit_limit(Xtr, ctr)
        logits = dict(cpu)
        for name, tf32 in (("cuda", False), ("cuda_tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                params = learner.fit(draws, Xtr[0], ctr, w, 10)
                logits[name] = learner.core(10).logits(
                    params, Xtr[0]).detach().cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        scale = float(logits["cpu"].abs().max())
        gap = self._logits_gap(logits["cuda"], logits["cpu"], tol)
        control = self._logits_gap(logits["cuda_tf32"], logits["cpu"], tol)
        self.require(0 < spread, "the permuted-row fits equal the fit: no "
                     "yardstick")
        self.require(gap["max_err"] <= tol and not gap["parted_off_near_ties"],
                     f"MLP card vs CPU: {gap} beyond {tol:.3g} (3x the CPU's "
                     f"permuted-row spread {spread:.3g})")
        self.require(control["max_err"] > tol, f"the TF32 control is within "
                     f"the limit {tol:.3g}: {control}; the check cannot see a "
                     f"lower-precision fit")
        prof = _device_profile(lambda: learner.fit(draws, Xtr[0], ctr, w, 10))
        print("mlp_fit_profile " + json.dumps(prof), flush=True)
        logistic = ("" if self.fashion_fp32 is None else
                    f" (phase 5 logistic: ascii={self.fashion_fp32[4]:.4f})")
        return (f"(a) fashion n_train=42000 agents=(392,392) MLP(128,64) "
                f"steps=200 full batch rounds=5: components="
                f"{len(st.components)} acc ascii={a_ascii:.4f} single="
                f"{a_single:.4f}{logistic}; session {secs:.2f} s, "
                f"{statistics.median(fit_ms):.1f} ms a fit (median of "
                f"{len(fit_ms)}), peak device memory {peak_gib:.3f} GiB; "
                f"one fit card vs cpu: max |logit err| {gap['max_err']:.6g} "
                f"({gap['max_err'] / scale:.3g} of max|logit| {scale:.6g}) "
                f"<= {tol:.6g} (3x the CPU against itself on permuted rows, "
                f"{spread:.6g}), predictions parted {gap['parted']} (all at "
                f"near-ties); TF32 control {control['max_err']:.6g} "
                f"({control['max_err'] / scale:.3g}) > the limit, refused")

    def _blob_forest(self) -> str:
        """(b) Fig. 3's forest on the blob: card and CPU, the same bits."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import blob_fig3
        from repro_torch.learners.forest import RandomForest
        runs = {}
        for device in ("cuda", "cpu"):
            ds = blob_fig3(torch.Generator().manual_seed(0), n=1000,
                           device=device)
            Xtr, ctr, Xte, cte = self._split(ds)
            proto = E.Protocol(E.SessionConfig(num_classes=10, max_rounds=8),
                               transport=E.MeteredTransport(), device=device)
            eps = E.endpoints_for([RandomForest(num_trees=8, depth=4,
                                                device=device)
                                   for _ in Xtr], Xtr)
            if device == "cuda":
                fit_ms = self._timed_fits(eps)
                self.reset_counts()
            t0 = time.perf_counter()
            session = proto.start(0, eps, ctr)
            session.run()
            served = session.predict_distributed(Xte)
            if device == "cuda":
                torch.cuda.synchronize()
                self.read_counts(len(session.state.components), "blob forest")
            runs[device] = (session, served.cpu(), cte.cpu(),
                            time.perf_counter() - t0)
        g, c = runs["cuda"][0], runs["cpu"][0]
        self.require(g.transport.log.entries == c.transport.log.entries,
                     "forest: ledgers differ between card and CPU")
        self.require([(x.agent, x.round, x.alpha) for x in g.state.components]
                     == [(x.agent, x.round, x.alpha)
                         for x in c.state.components],
                     "forest: components or alphas differ")
        self.require(torch.equal(g.state.w.cpu(), c.state.w),
                     "forest: final w differs")
        self.require(torch.equal(runs["cuda"][1], runs["cpu"][1]),
                     "forest: predictions differ")
        acc = float((runs["cuda"][1] == runs["cuda"][2]).float().mean())
        return (f"(b) blob n_train=700 agents=4x2 RandomForest(8 trees, "
                f"depth 4) rounds=8: components={len(g.state.components)} "
                f"acc={acc:.4f}; card = cpu bit for bit (ledger, alphas, "
                f"predictions, w); card {runs['cuda'][3]:.2f} s "
                f"({statistics.median(fit_ms):.1f} ms a fit), cpu "
                f"{runs['cpu'][3]:.2f} s")

    def _heterogeneous(self) -> str:
        """(c) examples/heterogeneous_agents.py: tree, logistic and MLP
        agents, the CV stop."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.core.protocol import (ASCIIConfig,
                                               fit_single_agent_adaboost)
        from repro_torch.data.partition import train_test_split, vertical_split
        from repro_torch.data.synthetic import blob_fig3
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.learners.mlp import MLP
        from repro_torch.learners.tree import DecisionTree
        ds = blob_fig3(torch.Generator().manual_seed(3), n=900,
                       device="cuda")
        tr, te = train_test_split(0, 900)
        tr, te = torch.as_tensor(tr, device="cuda"), torch.as_tensor(
            te, device="cuda")
        Xs = vertical_split(ds.X, (2, 3, 3))
        Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
        ctr, cte = ds.classes[tr], ds.classes[te]
        learners = [DecisionTree(depth=4, device="cuda"),
                    LogisticRegression(steps=200, device="cuda"),
                    MLP(hidden=(64, 32), steps=200, device="cuda")]
        Xfit, cfit, Xval, cval = E.holdout_split(Xtr, ctr, 0.2)
        proto = E.Protocol(E.SessionConfig(num_classes=10, max_rounds=8,
                                           cv_patience=2),
                           transport=E.MeteredTransport(), device="cuda")
        self.reset_counts()
        t0 = time.perf_counter()
        session = proto.start(1, E.endpoints_for(learners, Xfit), cfit,
                              validation=(Xval, cval))
        session.run()
        preds = session.fitted().predict(Xte)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = session.state
        self.read_counts(len(st.components), "heterogeneous")
        single = fit_single_agent_adaboost(
            2, Xtr[0], ctr, learners[0],
            ASCIIConfig(num_classes=10, max_rounds=8, cv_fraction=0.2,
                        cv_patience=2), device="cuda")
        a_ascii = float((preds == cte).float().mean())
        a_single = float((single.predict([Xte[0]]) == cte).float().mean())
        self.require(all(math.isfinite(c.alpha) for c in st.components),
                     "non-finite alpha")
        self.require(a_ascii > a_single, f"ASCII acc {a_ascii} <= single "
                     f"{a_single}")
        vals = [round(h["val_acc"], 3) for h in st.history]
        return (f"(c) heterogeneous blob n=900 blocks (2,3,3) tree(4) + "
                f"logistic(200) + MLP(64,32; 200): CV-stopped after "
                f"{st.round} rounds (val_acc {vals}), components="
                f"{len(st.components)}, acc ascii={a_ascii:.4f} single "
                f"tree={a_single:.4f}; {secs:.2f} s")

    def _neural_backbone(self) -> str:
        """(d) NeuralBackbone agents at qwen3-0.6b's layer width, cut to 2
        layers, BACKBONE_STEPS steps."""
        torch = self.torch
        from repro_torch.comm.draws import ChannelDraws
        from repro_torch.configs.registry import get_arch
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import blob_fig3
        from repro_torch.learners import neural
        from repro_torch.learners.neural import NeuralBackbone
        from repro_torch.learners.tree import DecisionTree
        cfg = get_arch("qwen3-0.6b").with_overrides(num_layers=2)
        ds = blob_fig3(torch.Generator().manual_seed(0), n=1000,
                       device="cuda")
        Xtr, ctr, Xte, cte = self._split(ds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        learners = [NeuralBackbone(cfg=cfg, steps=BACKBONE_STEPS,
                                   device="cuda"),
                    DecisionTree(depth=4, device="cuda"),
                    DecisionTree(depth=4, device="cuda"),
                    DecisionTree(depth=4, device="cuda")]
        proto = E.Protocol(E.SessionConfig(num_classes=10, max_rounds=2),
                           transport=E.MeteredTransport(), device="cuda")
        eps = E.endpoints_for(learners, Xtr)
        fit_ms = self._timed_fits(eps[:1])
        self.reset_counts()
        t0 = time.perf_counter()
        session = proto.start(0, eps, ctr)
        session.run()
        preds = session.fitted().predict(Xte)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        st = session.state
        self.read_counts(len(st.components), "neural backbone")
        self.require(all(math.isfinite(c.alpha) for c in st.components),
                     "non-finite alpha")
        acc = float((preds == cte).float().mean())
        # one fit on the card and on the CPU from the same draws, within
        # 5e-4 max|logit| (the float32 forward's readings: ~4e-5); the
        # control, the same fit on the card with the forward in bf16, must
        # fall outside
        draws = ChannelDraws().fit(E.key_data(0), 0, 0)
        n = ctr.shape[0]
        w = torch.full((n,), 1.0 / n)
        logits = {}
        for name, dev in (("cuda", "cuda"), ("cpu", "cpu"),
                          ("cuda_bf16", "cuda")):
            nb = NeuralBackbone(cfg=cfg, steps=BACKBONE_STEPS, device=dev)
            X = Xtr[0].to(dev)
            t1 = time.perf_counter()
            with (mock.patch.object(neural, "logits", _bf16_backbone_logits)
                  if name == "cuda_bf16" else contextlib.nullcontext()):
                params = nb.fit(draws, X, ctr.to(dev), w.to(dev), 10)
                logits[name] = nb.core(10).logits(params, X).detach().cpu()
            logits[name + "_s"] = time.perf_counter() - t1
        scale = float(logits["cpu"].abs().max())
        tol = 5e-4 * scale
        gap = self._logits_gap(logits["cuda"], logits["cpu"], tol)
        control = self._logits_gap(logits["cuda_bf16"], logits["cpu"], tol)
        self.require(gap["max_err"] <= tol and not gap["parted_off_near_ties"],
                     f"backbone card vs CPU: {gap} beyond {tol:.3g}")
        self.require(control["max_err"] > tol, f"the bf16-forward control is "
                     f"within the limit {tol:.3g}: {control}; the check "
                     f"cannot see a bf16 forward")
        return (f"(d) NeuralBackbone qwen3-0.6b width (d_model 1024, 16/8 "
                f"heads of 128, d_ff 3072, vocab 151936) cut to 2 layers and "
                f"{BACKBONE_STEPS} steps, agent 0 of blob n_train=700 beside 3 "
                f"trees, 2 "
                f"rounds: components={len(st.components)} acc={acc:.4f}; "
                f"session {secs:.2f} s, {statistics.median(fit_ms):.0f} ms a "
                f"backbone fit, peak device memory {peak_gib:.3f} GiB; one "
                f"fit card vs cpu ({logits['cuda_s']:.2f} s / "
                f"{logits['cpu_s']:.2f} s): max |logit err| "
                f"{gap['max_err']:.6g} ({gap['max_err'] / scale:.3g} of "
                f"max|logit| {scale:.6g}) <= {tol:.6g} (5e-4 max|logit|), "
                f"predictions parted {gap['parted']}; bf16-forward control "
                f"{control['max_err']:.6g} ({control['max_err'] / scale:.3g})"
                f" > the limit, refused")

    # ------------------------------------------------------ control plane
    @staticmethod
    def _coded_counts(transport, ladder, n: int, block: tuple) -> dict:
        """Expected quantize launches from the ledger, each entry's codec
        read off its bits (the ladder's rungs price each shape apart)."""
        from repro_torch.comm.codecs import QuantCodec
        counts = {"quantize_dequant_tiles": 0, "quantize_dequant_block": 0}
        for e in transport.log.entries:
            if e["kind"] not in ("ignorance", "score_block"):
                continue
            shape = n if e["kind"] == "ignorance" else block
            codecs = [c for c in ladder if c.wire_bits(shape) == e["bits"]]
            if not codecs:
                continue                       # raw float32, no codec
            if len(codecs) != 1:
                raise AssertionError(f"bits {e['bits']} name no one rung")
            if isinstance(codecs[0], QuantCodec):
                name = ("quantize_dequant_tiles" if e["kind"] == "ignorance"
                        else "quantize_dequant_block")
                counts[name] += 1
        return counts

    def _read_control_counts(self, session, transport, ladder, n: int,
                             block: tuple, where: str) -> None:
        """Read a control-plane session's launches: a fused ignorance
        update a shipped hop (an async merge instead: one unnormalized
        launch a component), quantize launches off the ledger's bits."""
        stale = session.scheduler.stale
        comps = len(session.state.components)
        self.read_counts(
            0 if stale else sum(e["kind"] == "ignorance"
                                for e in transport.log.entries), where,
            ignorance_update_unnormalized=comps if stale else 0,
            **self._coded_counts(transport, ladder, n, block))

    def _control_cli(self, configs: list) -> str:
        """Each control-plane config through ``cli.run`` itself, on its
        default data (blob3, n 600, tree agents): on the card, on the CPU,
        and on the card paused after 2 rounds and resumed from its
        checkpoint (the run keys checked by the CLI).  The CPU's and the
        resumed run's final w bit-equal the card's, the CPU's line the
        card's."""
        torch = self.torch
        from repro_torch.comm.budget import DEFAULT_LADDER
        from repro_torch.comm.codecs import make_codec
        from repro_torch.launch import session as cli
        out = []
        for argv in configs:
            name = " ".join(argv)
            runs = {}
            for device in ("cuda", "cpu"):
                args = cli.parser().parse_args(["--device", device, *argv])
                if device == "cuda":
                    self.reset_counts()
                with contextlib.redirect_stdout(io.StringIO()):
                    runs[device] = cli.run(args)
                if device == "cuda":
                    torch.cuda.synchronize()
                    run = runs[device]
                    n = int(run.session.state.w.shape[0])
                    self._read_control_counts(
                        run.session, run.transport,
                        DEFAULT_LADDER if not args.codec
                        else (make_codec(args.codec),), n,
                        (args.n - n, run.session.cfg.num_classes),
                        f"cli {name}")
            card, cpu = runs["cuda"], runs["cpu"]
            ckpt = tempfile.mkdtemp(dir=SMOKE_DIR)
            try:
                base = ["--device", "cuda", *argv, "--ckpt-dir", ckpt]
                with contextlib.redirect_stdout(io.StringIO()):
                    paused = cli.run(cli.parser().parse_args(
                        base + ["--stop-after", "2"]))
                    resumed = cli.run(cli.parser().parse_args(
                        base + ["--resume"]))
            finally:
                shutil.rmtree(ckpt, ignore_errors=True)
            self.require(card.line == cpu.line, f"cli {name}: card line "
                         f"{card.line} != cpu line {cpu.line}")
            self.require(torch.equal(card.session.state.w.cpu(),
                                     cpu.session.state.w),
                         f"cli {name}: card and CPU w differ")
            self.require(paused.paused, f"cli {name}: the run did not pause")
            self.require(torch.equal(resumed.session.state.w,
                                     card.session.state.w),
                         f"cli {name}: resumed w is not bit-identical")
            out.append(f"[{name}] {card.line}")
        return ("blob3 through cli.run, card = cpu (line, w) and paused at "
                "round 2 then resumed = uninterrupted (w): " + "; ".join(out))

    def control(self) -> str:
        torch = self.torch
        from repro_torch.comm.budget import BudgetSpec
        from repro_torch.comm.codecs import make_codec
        from repro_torch.comm.budget import DEFAULT_LADDER
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import mimic_surrogate
        from repro_torch.launch import session as cli
        from repro_torch.learners.tree import DecisionTree

        def data(device):
            ds = mimic_surrogate(torch.Generator().manual_seed(0), n=15000,
                                 device=device)
            return self._split(ds)

        n, m, n_te = 10500, 2, 4500
        costs = BudgetSpec().hop_costs(n)
        budget_bits = (m - 1) * 2 * n * 32 + sum(costs) + 100
        configs = [["--controller", "resid"],
                   ["--controller", "entropy", "--serve-controller",
                    "margin"],
                   ["--scheduler", "budget-aware", "--byte-budget",
                    str(-(-budget_bits // 8))],
                   ["--variant", "async", "--codec", "int8"]]
        out = []
        for argv in configs:
            name = " ".join(argv)
            runs = {}
            for device in ("cuda", "cpu"):
                args = cli.parser().parse_args(["--device", device, *argv])
                cli.check_args(args)
                transport = cli.make_transport(args)
                scheduler, upstream = cli.make_scheduler(args)
                rungs = []
                if transport.controller is not None:
                    inner = transport._controller_rung

                    def step(w_prev, w_out, _inner=inner, _rungs=rungs):
                        _rungs.append(int(_inner(w_prev, w_out)))
                        return _rungs[-1]
                    transport._controller_rung = step
                Xtr, ctr, Xte, cte = data(device)
                proto = E.Protocol(E.SessionConfig(num_classes=2,
                                                   max_rounds=10,
                                                   upstream=upstream),
                                   scheduler=scheduler, transport=transport,
                                   device=device)
                eps = E.endpoints_for([DecisionTree(depth=4,
                                                    num_thresholds=16,
                                                    device=device)
                                       for _ in Xtr], Xtr)
                if device == "cuda":
                    self.reset_counts()
                t0 = time.perf_counter()
                session = proto.start(0, eps, ctr)
                session.run()
                served = session.predict_distributed(Xte)
                fitted = session.fitted().predict(Xte)
                if device == "cuda":
                    torch.cuda.synchronize()
                    self._read_control_counts(
                        session, transport,
                        DEFAULT_LADDER if not args.codec
                        else (make_codec(args.codec),), n, (n_te, 2),
                        f"mimic {name}")
                runs[device] = (session, transport, rungs, served.cpu(),
                                fitted.cpu(), cte.cpu(),
                                time.perf_counter() - t0)
            (gs, gt, grungs, gserve, gfit, cte, gsec), \
                (cs, ct, crungs, cserve, cfit, _, csec) = (runs["cuda"],
                                                            runs["cpu"])
            self.require(grungs == crungs,
                         f"{name}: rung sequences differ between card and "
                         f"CPU: {grungs} vs {crungs}")
            self.require(gt.log.entries == ct.log.entries,
                         f"{name}: card and CPU ledgers differ")
            self.require((gs.state.round, gs.state.stopped)
                         == (cs.state.round, cs.state.stopped),
                         f"{name}: stop rounds differ")
            self.require([(c.agent, c.round) for c in gs.state.components]
                         == [(c.agent, c.round) for c in cs.state.components],
                         f"{name}: round orders or components differ")
            torch.testing.assert_close(
                torch.tensor([c.alpha for c in gs.state.components]),
                torch.tensor([c.alpha for c in cs.state.components]),
                rtol=1e-5, atol=0)
            self.require(torch.equal(gserve, cserve)
                         and torch.equal(gfit, cfit),
                         f"{name}: predictions differ between card and CPU")
            extra = ""
            if grungs:
                extra += f" rungs={grungs}"
                self.require(len(set(grungs)) > 1,
                             f"{name}: the controller never moved")
            if hasattr(gt, "budget"):
                used = sorted({e["rung"] for e in gt.log.entries
                               if "rung" in e})
                self.require(3 in used, f"{name}: the walk never reached "
                             f"int4: rungs {used}")
                orders: dict = {}
                for c in gs.state.components:
                    orders.setdefault(c.round, []).append(c.agent)
                extra += (f" ladder_rungs={used} skipped={len(gt.skipped)}"
                          f" exhausted={gt.exhausted} orders="
                          f"{list(orders.values())}")
            if gs.scheduler.stale:
                extra += (f" barrier_releases="
                          f"{sum(e['src'] == 'barrier' for e in gt.log.entries)}")
            kinds = gt.log.bits_by_kind()
            acc = float((gserve == cte).float().mean())
            out.append(f"[{name}] components={len(gs.state.components)} "
                       f"rounds={gs.state.round}{extra} ignorance_bits="
                       f"{kinds.get('ignorance', 0)} score_block_bits="
                       f"{kinds.get('score_block', 0)} serve_acc={acc:.4f} "
                       f"w_bit_equal={torch.equal(gs.state.w.cpu(), cs.state.w)}"
                       f" card {gsec:.2f} s cpu {csec:.2f} s")
        cli_configs = [a if a[0] != "--scheduler" else
                       ["--scheduler", "budget-aware", "--byte-budget",
                        "30000"] for a in configs]
        return ("mimic through the CLI's transport and scheduler builders, "
                "card = cpu (rungs, orders, ledgers, stops, predictions "
                "exact; alphas rtol 1e-5): " + "; ".join(out) + "; "
                + self._control_cli(cli_configs))

    # ---------------------------------------------------- compiled backend
    def compiled(self) -> str:
        """Phase 14: (a)-(e) of the module note; every part runs, then the
        phase fails if one did."""
        out, failed = [], []
        for part in (self._batched_kernel, self._compiled_fashion,
                     self._compiled_mimic, self._fleets,
                     self._no_host_reads):
            t0 = time.perf_counter()
            try:
                out.append(part())
                print(f"phase 14 part ({time.perf_counter() - t0:.1f} s): "
                      f"{out[-1]}", flush=True)
            except Exception as e:  # the phase fails below, after the rest
                traceback.print_exc()
                failed.append(f"{part.__name__}: {type(e).__name__}: {e}")
        if failed:
            raise AssertionError("; ".join(failed))
        return "; ".join(out)

    def _compiled_counts(self, plan, fleet: bool, where: str,
                         served: int = 0) -> None:
        """A compiled run's launches: every slot's update (one batched
        launch a hop for a fleet), every slot's quantize for each int rung
        of the ladder, and for each of ``served`` compiled serve steps one
        block quantize a non-head agent and int rung of the serve
        ladder."""
        from repro_torch.comm.codecs import QuantCodec
        hops = plan.max_rounds * plan.num_agents
        quant = sum(isinstance(c, QuantCodec) for c in plan.ladder)
        channel = {"quantize_dequant_tiles": hops * quant}
        if fleet:
            channel["ignorance_update_batched"] = hops
        if served:
            channel["quantize_dequant_block"] = (
                served * self._serve_quant(plan))
        self.read_counts(0 if fleet else hops, where, **channel)

    @staticmethod
    def _serve_quant(plan) -> int:
        """Block quantize launches of one compiled serve step: one a
        non-head agent and int rung of the serve ladder (every rung is
        evaluated, shipped or not)."""
        from repro_torch.comm.codecs import QuantCodec
        return (plan.num_agents - 1) * sum(
            isinstance(c, QuantCodec) for c in plan.serve_ladder)

    def _batched_kernel(self) -> str:
        """(d) the batched update against its plain version and F single
        launches, bit for bit; its times beside its bound."""
        torch = self.torch
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        gen = torch.Generator(device=self.dev).manual_seed(14)
        floor = self.floor_ms
        if floor is None:
            floor = self.floor_ms = self._launch_floor()
        rows_out, checked = [], []
        for rows, n in ((32, 15000), (8, 42000), (32, 10500), (8, 420),
                        (3, 2 ** 17 + 5), (ig.MAX_ROWS + 2, 3)):
            w = torch.rand((rows, n), generator=gen, device=self.dev) + 0.01
            w /= w.sum(dim=1, keepdim=True)
            r = (torch.rand((rows, n), generator=gen, device=self.dev)
                 > 0.4).float()
            a = torch.rand(rows, generator=gen, device=self.dev) * 3 - 0.5
            got = ig.ignorance_update_batched(w, r, a)
            plain = ig.ignorance_update_batched_plain(w, r, a)
            singles = torch.stack([ops.ignorance_update(w[f], r[f], a[f])
                                   for f in range(min(rows, 64))])
            torch.cuda.synchronize()
            self.require(torch.equal(got, plain), f"[{rows}, {n}]: the "
                         f"batched update differs from its plain version "
                         f"(max abs {float((got - plain).abs().max())})")
            self.require(torch.equal(got[:singles.shape[0]], singles),
                         f"[{rows}, {n}]: a row differs from its single "
                         f"launch")
            self.require(torch.equal(ig.ignorance_update_batched(w, r, a),
                                     got), f"[{rows}, {n}]: two runs differ")
            checked.append([rows, n])
            if (rows, n) not in ((32, 15000), (8, 42000), (3, 2 ** 17 + 5)):
                continue
            bound, by = _bound_ms(4 * (3 * rows * n + rows), 4 * rows * n)

            def batched(w=w, r=r, a=a):
                ig.ignorance_update_batched(w, r, a)

            def single_launches(w=w, r=r, a=a, rows=rows):
                for f in range(rows):
                    ops.ignorance_update(w[f], r[f], a[f])
            row = {"shape": [rows, n],
                   "ms": _cuda_time_ms(batched),
                   "device_ms": _kernel_device_ms(batched, ""),
                   "plain_ms": _cuda_time_ms(
                       lambda w=w, r=r, a=a:
                       ig.ignorance_update_batched_plain(w, r, a)),
                   "singles_ms": _cuda_time_ms(single_launches, reps=20),
                   "bound_ms": bound, "bound_by": by,
                   "launch_floor_device_ms": floor}
            if (rows, n) == (32, 15000):
                per_call, seen = _device_kernels_per_call(batched)
                self.require(per_call == 1, f"the batched update at [32, "
                             f"15000]: {per_call} device kernels a call "
                             f"{seen}")
                self.kernels["ignorance_update_batched"] = {
                    "source": "src/repro_torch/csrc/ignorance.cu",
                    "replaces": "src/repro/kernels/ignorance.py:46",
                    "max_abs_err": float((got - plain).abs().max()),
                    "ms": row["ms"], "device_ms": row["device_ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": bound,
                    "bound_by": by, "library_ms": None}
            rows_out.append(row)
        print("batched_table " + json.dumps(rows_out), flush=True)
        from repro_torch.kernels import quantize as tq
        decoded = []
        for rows, n in ((32, 10501), (8, 7)):
            x = torch.randn((rows, n), generator=gen, device=self.dev)
            u = torch.rand((rows, n), generator=gen, device=self.dev)
            tile = tq.tile_for(n)
            packed, scales = tq.quantize_pack_int4_rows(x, u, 7.0, tile)
            got = tq.unpack_dequant_int4_rows(packed, scales, n, tile)
            self.require(torch.equal(got, tq.unpack_dequant_int4_rows_plain(
                packed, scales, n, tile)), f"the int4 rows decode at "
                f"[{rows}, {n}] differs from its plain version")
            decoded.append([rows, n])
        return (f"(d) batched ignorance update at {checked} = plain = single "
                f"launches bit for bit, two runs identical, one device "
                f"kernel a call; [32, 15000] device "
                f"{rows_out[0]['device_ms']:.5f} ms (bound "
                f"{rows_out[0]['bound_ms']:.5f}, launch floor {floor:.5f}); "
                f"the int4 rows decode at odd n {decoded} = plain bit for "
                f"bit")

    def _timed_fit(self, backend, key, learners, Xtr, ctr, cfg,
                   transport=None, scheduler=None):
        """One session through Protocol.fit on the card: (protocol, fitted,
        seconds, peak GiB, fit ms list for eager)."""
        torch = self.torch
        from repro_torch.core import engine as E
        proto = E.Protocol(cfg, scheduler=scheduler, transport=transport
                           if transport is not None
                           else E.MeteredTransport(), backend=backend,
                           device="cuda")
        eps = E.endpoints_for(learners, Xtr)
        fit_ms = self._timed_fits(eps) if backend == "eager" else []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fitted = proto.fit(key, eps, ctr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (proto, fitted, secs,
                torch.cuda.max_memory_allocated() / 2 ** 30, fit_ms)

    def _compiled_fashion(self) -> str:
        """(a) the Fashion MLP session, compiled against eager."""
        torch = self.torch
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.learners.mlp import MLP
        Xtr, ctr, Xte, cte = self._fashion_data()
        rounds = COMPILED_FASHION_ROUNDS
        cfg = E.SessionConfig(num_classes=10, max_rounds=rounds)
        runs = {}
        for backend in ("eager", "compiled"):
            self.reset_counts()
            runs[backend] = self._timed_fit(
                backend, 0, [MLP(hidden=(128, 64), steps=200,
                                 device="cuda")] * 2, Xtr, ctr, cfg)
            proto = runs[backend][0]
            if backend == "eager":
                self.read_counts(len(proto._session.state.components),
                                 "fashion mlp eager")
            else:
                plan = C.plan_for([MLP(hidden=(128, 64), steps=200,
                                       device="cuda")] * 2, 10,
                                  max_rounds=rounds)
                self._compiled_counts(plan, False, "fashion mlp compiled")
        (ep, ef, esec, epeak, fit_ms), (cp, cf, csec, cpeak, _) = (
            runs["eager"], runs["compiled"])
        self.require([(c.agent, c.round) for c in cf.components]
                     == [(c.agent, c.round) for c in ef.components],
                     "fashion mlp: components differ, compiled vs eager")
        self.require(len(cf.history) == len(ef.history),
                     "fashion mlp: stop rounds differ")
        self.require(torch.equal(cf.predict(Xte), ef.predict(Xte)),
                     "fashion mlp: predictions differ")
        same_w = torch.equal(cp._compiled_result.w, ep._session.state.w)
        self.require(same_w, "fashion mlp: compiled w is not the eager w "
                     "bit for bit (the same ops in the same order)")
        acc = float((cf.predict(Xte) == cte).float().mean())
        fits = rounds * 2
        return (f"(a) fashion MLP(128,64) 200 steps {rounds} rounds: "
                f"compiled = "
                f"eager (components {len(cf.components)}, stop, "
                f"predictions, w bit-equal), acc {acc:.4f}; eager "
                f"{esec:.2f} s ({statistics.median(fit_ms):.1f} ms a fit, "
                f"peak {epeak:.3f} GiB), compiled {csec:.2f} s "
                f"({csec * 1e3 / fits:.1f} ms a fit slot, {fits} slots, "
                f"peak {cpeak:.3f} GiB)")

    def _mimic_data(self, device="cuda"):
        from repro_torch.data.synthetic import mimic_surrogate
        ds = mimic_surrogate(self.torch.Generator().manual_seed(0), n=15000,
                             device=device)
        return self._split(ds)

    def _compiled_mimic(self) -> str:
        """(b) MIMIC's nine configs through the CLI's builders, compiled =
        eager on the card (the async variant: phase 18(a))."""
        torch = self.torch
        from repro_torch.comm.budget import BudgetSpec
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.launch import session as cli
        Xtr, ctr, Xte, cte = self._mimic_data()
        n, m, n_te = 10500, 2, 4500
        costs = BudgetSpec().hop_costs(n)
        budget = str(-(-((m - 1) * 2 * n * 32 + sum(costs) + 100) // 8))
        configs = [[], ["--codec", "int8"],
                   ["--codec", "int4", "--serve-codec", "int8"],
                   ["--codec", "topk"],
                   ["--dp-epsilon", "1.0", "--accountant", "rdp"],
                   ["--byte-budget", budget],
                   ["--controller", "resid"], ["--controller", "entropy"],
                   ["--scheduler", "budget-aware", "--byte-budget", budget]]
        out = []
        for argv in configs:
            name = " ".join(argv) or "fp32"
            runs = {}
            for backend in ("eager", "compiled"):
                args = cli.parser().parse_args(
                    ["--device", "cuda", "--learner", "logistic", "--steps",
                     str(MIMIC_STEPS), "--backend", backend, *argv])
                cli.check_args(args)
                transport = cli.make_transport(args)
                scheduler, upstream = cli.make_scheduler(args)
                rungs = []
                if backend == "eager" and transport.controller is not None:
                    inner = transport._controller_rung

                    def step(w_prev, w_out, _inner=inner, _rungs=rungs):
                        _rungs.append(int(_inner(w_prev, w_out)))
                        return _rungs[-1]
                    transport._controller_rung = step
                cfg = E.SessionConfig(num_classes=2,
                                      max_rounds=COMPILED_MIMIC_ROUNDS,
                                      upstream=upstream)
                self.reset_counts()
                proto, fitted, secs, _, _ = self._timed_fit(
                    backend, 0, [cli.LEARNERS["logistic"](args)
                                 for _ in Xtr], Xtr, ctr, cfg,
                    transport=transport, scheduler=scheduler)
                served = proto.predict_distributed(Xte)
                torch.cuda.synchronize()
                ladder = (transport.budget.ladder if hasattr(transport,
                                                            "budget")
                          else transport.controller.ladder
                          if transport.controller is not None
                          else (transport.codec,))
                if backend == "eager":
                    self._read_control_counts(
                        proto._session, transport,
                        [c for c in (*ladder, transport.serve_codec)
                         if c is not None], n, (n_te, 2),
                        f"mimic eager {name}")
                else:
                    res = proto._compiled_result
                    sent = res.sent.cpu()
                    rungs = [int(x) for x in res.codec_idx.cpu()[sent]]
                    plan = C.plan_for(
                        [cli.LEARNERS["logistic"](args) for _ in Xtr], 2,
                        max_rounds=COMPILED_MIMIC_ROUNDS,
                        codec=transport.codec, privacy=transport.privacy,
                        budget=getattr(transport, "budget", None),
                        controller=transport.controller,
                        serve_codec=transport.serve_codec,
                        serve_controller=transport.serve_controller)
                    self._compiled_counts(
                        plan, False, f"mimic compiled {name}", served=1)
                w = (proto._compiled_result.w if backend == "compiled"
                     else proto._session.state.w)
                runs[backend] = (proto, fitted, transport, rungs,
                                 served.cpu(), fitted.predict(Xte).cpu(), w,
                                 secs)
            (ep, ef, et, er, eserve, efit, ew, esec), \
                (cp, cf, ct, cr, cserve, cfit, cw, csec) = (
                    runs["eager"], runs["compiled"])
            self.require(et.log.entries == ct.log.entries,
                         f"{name}: compiled and eager ledgers differ")
            self.require([(c.agent, c.round) for c in cf.components]
                         == [(c.agent, c.round) for c in ef.components],
                         f"{name}: components or round orders differ")
            self.require(len(cf.history) == len(ef.history),
                         f"{name}: stop rounds differ")
            self.require(torch.equal(cserve, eserve)
                         and torch.equal(cfit, efit),
                         f"{name}: predictions differ")
            self.require(torch.equal(cw, ew), f"{name}: w is not bit-equal")
            if hasattr(et, "budget"):
                erungs = [e["rung"] for e in et.log.entries if "rung" in e
                          and e["kind"] == "ignorance"]
                self.require(cr == erungs, f"{name}: rungs {cr} != eager "
                             f"{erungs}")
                self.require((ct.skipped, ct.exhausted)
                             == (et.skipped, et.exhausted),
                             f"{name}: skips or exhaustion differ")
            elif et.controller is not None:
                self.require(cr == er, f"{name}: controller rungs {cr} != "
                             f"eager {er}")
            if et.accountant is not None:
                self.require(ct.accountant.releases
                             == et.accountant.releases,
                             f"{name}: DP releases differ")
            acc = float((cserve == cte.cpu()).float().mean())
            out.append(f"[{name}] components={len(cf.components)} "
                       f"rounds={len(cf.history)} acc={acc:.4f} "
                       f"bits={ct.total_bits} eager {esec:.2f} s compiled "
                       f"{csec:.2f} s")
        return (f"(b) mimic logistic({MIMIC_STEPS}) "
                f"{COMPILED_MIMIC_ROUNDS} rounds, compiled = "
                "eager on the "
                "card (ledgers, rungs, orders, stops, predictions, w "
                "bit-equal): " + "; ".join(out))

    def _fleet_vs_single(self, plan, fleet, keys, held, Xs, ctr, Xte,
                         learners, name, logits_limit=None):
        """The fleet's sessions ``held`` (positions in ``keys``) against
        compiled_session with their keys (timed): the slots run, the
        sends, rungs and orders exact; w and the alphas bit-equal.  With ``logits_limit`` (an MLP:
        the fleet's vmapped backward sums its gradients in another order
        than a lone fit's, fleet_bits.json) a session may part instead, at
        a hop that rounding decides (``_parting_hop``), and its held-out
        predictions must still agree >= 0.999.  Returns (notes, seconds of
        the single sessions)."""
        torch = self.torch
        from repro_torch.core import compiled as C
        notes, secs, exact_count = [], [], 0
        for f in held:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = C.compiled_session(plan, keys[f], Xs, ctr)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            part = C.SessionResult(*[
                C.tree_map(lambda x, _f=f: x[_f], v) for v in fleet])
            for field in ("executed", "valid", "sent", "codec_idx",
                          "order"):
                self.require(torch.equal(getattr(part, field),
                                         getattr(single, field)),
                             f"{name} session {f}: {field} differs from "
                             f"compiled_session")
            if (torch.equal(part.w, single.w)
                    and torch.equal(part.alphas, single.alphas)
                    and torch.equal(part.w_trace, single.w_trace)):
                exact_count += 1
                continue
            self.require(logits_limit is not None, f"{name} session {f}: "
                         f"w or alphas differ from compiled_session")
            reading = self._parting_hop(plan, part, single, Xs, ctr,
                                        logits_limit, f"{name} session {f}")
            agree = float((C.fitted_from_result(plan, single, learners)
                           .predict(Xte)
                           == C.fitted_from_result(plan, part, learners)
                           .predict(Xte)).float().mean())
            self.require(agree >= 0.999, f"{name} session {f}: {reading}; "
                         f"held-out predictions agree {agree:.4f} < 0.999")
            notes.append(f"session {f}: {reading}; held-out predictions "
                         f"agree {agree:.4f}")
        notes.insert(0, f"{exact_count} of {len(held)} sessions bit-equal "
                     f"to compiled_session (w, alphas, w after every hop)")
        return notes, secs

    def _parting_hop(self, plan, part, single, Xs, ctr, limit,
                     where) -> str:
        """The first hop (in visit order) where a fleet's session and its
        compiled_session differ in alpha or in w after the hop.  Before it
        both are bit-equal, so the hop's two fits had the same inputs and
        differ by the products' rounding alone: their logits must lie
        within ``limit`` (12(a)'s), their reward vectors must differ (else
        alpha and w would be equal), and every row whose prediction parted
        must be a near-tie, its top-2 logit gap within ``limit`` in both
        fits.  Returns the reading."""
        torch = self.torch
        from repro_torch.core import compiled as C
        T, M = single.alphas.shape
        hop = next((t, j) for t in range(T) for j in range(M)
                   if not (torch.equal(part.alphas[t, j], single.alphas[t, j])
                           and torch.equal(part.w_trace[t, j],
                                           single.w_trace[t, j])))
        t, j = hop
        core = plan.cores[j]
        logits = [core.logits(C.tree_map(lambda x: x[t], r.params[j]),
                              Xs[j]).detach() for r in (single, part)]
        rewards = [(lg.argmax(-1) == ctr) for lg in logits]
        gaps = [self._logits_gap(a, b, limit)
                for a, b in ((logits[1], logits[0]), (logits[0], logits[1]))]
        reading = (f"parts at hop (round {t}, slot {j}): its fits' max"
                   f"|dlogit| {gaps[0]['max_err']:.4g} (limit {limit:.4g}), "
                   f"{gaps[0]['parted']} predictions parted, "
                   f"{int((rewards[0] != rewards[1]).sum())} rewards, "
                   f"{gaps[0]['parted_off_near_ties']}/"
                   f"{gaps[1]['parted_off_near_ties']} off near-ties; after "
                   f"it max|dw| {float((part.w - single.w).abs().max()):.3g}")
        self.require(gaps[0]["max_err"] <= limit,
                     f"{where}: {reading}: beyond 12(a)'s limit")
        self.require(not torch.equal(rewards[0], rewards[1]),
                     f"{where}: {reading}: the rewards are equal, so the "
                     f"hop's inputs, not its fits, differ")
        self.require(gaps[0]["parted_off_near_ties"] == 0
                     and gaps[1]["parted_off_near_ties"] == 0,
                     f"{where}: {reading}: a parted prediction is no "
                     f"near-tie")
        return reading

    def _eager_sessions(self, learners, Xtr, ctr, cfg, keys,
                        transport_fn, where) -> list:
        """One eager Protocol.fit on the card a key; their seconds.  A
        session's launches are read off its ledger."""
        torch = self.torch
        from repro_torch.core import engine as E
        secs = []
        for key in keys:
            transport = transport_fn()
            proto = E.Protocol(cfg, transport=transport, backend="eager",
                               device="cuda")
            eps = E.endpoints_for(learners, Xtr)
            self.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proto.fit(key, eps, ctr)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            hops = sum(e["kind"] == "ignorance"
                       for e in transport.log.entries)
            quant = ({"quantize_dequant_tiles": hops}
                     if transport.codec is not None else {})
            self.read_counts(hops, where, **quant)
        self.reset_counts()
        return secs

    def _fleets(self) -> str:
        """(c) a MIMIC int8 seed fleet of 32 and a Fashion-MLP fleet of 2 on
        shared data; each against compiled_session calls and eager
        sessions: both Fashion sessions, and 2 of the 32 MIMIC ones (the
        first and the last; 32 of each took 150 s on the card, more
        than phase 14's share of the script's time limit; 8 and 8 took 99
        s, 4 and 4 60 s).  The Fashion fleet runs 2 rounds of the session's 5
        (FASHION_FLEET_ROUNDS), to leave phases 16 to 18 their share of
        the script's time."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.learners.mlp import MLP
        out = []
        fleets = (
            ("mimic int8", MIMIC_FLEET, self._mimic_data(),
             [LogisticRegression(steps=MIMIC_STEPS, device="cuda")] * 2, 2,
             10, lambda: QuantCodec(8)),
            ("fashion MLP", FASHION_FLEET, self._fashion_data(),
             [MLP(hidden=(128, 64), steps=200, device="cuda")] * 2, 10,
             FASHION_FLEET_ROUNDS, lambda: None))
        for name, F, (Xtr, ctr, Xte, _), learners, k, rounds, codec \
                in fleets:
            plan = C.plan_for(learners, k, max_rounds=rounds, codec=codec())
            keys = list(range(F))
            held = list(MIMIC_HELD) if F == MIMIC_FLEET else keys
            self.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fleet = C.fleet_run(plan, keys, Xtr, ctr)
            torch.cuda.synchronize()
            fsec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            self._compiled_counts(plan, True, f"{name} fleet")
            limit = (self._mlp_fit_limit(Xtr, ctr)[0]
                     if name.startswith("fashion") else None)
            notes, ssec = self._fleet_vs_single(plan, fleet, keys, held,
                                                Xtr, ctr, Xte, learners,
                                                f"{name} fleet",
                                                logits_limit=limit)
            esec = self._eager_sessions(
                learners, Xtr, ctr, E.SessionConfig(num_classes=k,
                                                    max_rounds=rounds),
                [keys[f] for f in held],
                lambda: E.MeteredTransport(codec=codec()), f"{name} eager")
            h = len(held)
            out.append(
                f"{name} F={F}: fleet {fsec:.3f} s = {F / fsec:.4g} "
                f"sessions/s (peak {peak:.3f} GiB), {h} compiled_session "
                f"calls {sum(ssec):.3f} s = {h / sum(ssec):.4g} sessions/s "
                f"(range {min(ssec):.3f}-{max(ssec):.3f} s), {h} eager "
                f"sessions {sum(esec):.3f} s = {h / sum(esec):.4g} "
                f"sessions/s (range {min(esec):.3f}-{max(esec):.3f} s); "
                + "; ".join(notes))
        return "(c) fleets, one batched update a hop: " + " | ".join(out)

    def _no_host_reads(self) -> str:
        """(e) a compiled session and a fleet under sync debug mode
        "error": any host read inside raises."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        Xtr, ctr, _, _ = self._mimic_data()
        plan = C.plan_for([LogisticRegression(steps=MIMIC_STEPS,
                                              device="cuda")] * 2,
                          2, max_rounds=SYNC_CHECK_ROUNDS,
                          codec=QuantCodec(8))
        shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
        fn = C.make_session_fn(plan, shapes)
        single = C._draws_for(plan, E.key_data(0), int(ctr.shape[0]), shapes,
                              ctr.device, None, fleet=False)
        fleet = C._draws_for(plan, [E.key_data(k) for k in range(4)],
                             int(ctr.shape[0]), shapes, ctr.device, None,
                             fleet=True)
        vfn = torch.func.vmap(fn, in_dims=(0, None, None))
        results = {}
        for name, run in (("session", lambda: fn(single, tuple(Xtr), ctr)),
                          ("fleet", lambda: vfn(fleet, tuple(Xtr), ctr))):
            run()                       # warm-up: first-use set-up syncs
            torch.cuda.synchronize()
            self.reset_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                results[name] = run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            self._compiled_counts(plan, name == "fleet",
                                  f"sync-checked {name}")
        self.require(torch.equal(results["fleet"].executed[0],
                                 results["session"].executed),
                     "the sync-checked fleet's session 0 did not run as the "
                     "session did")
        return ("(e) a compiled session and a 4-session fleet (mimic int8) "
                "ran under set_sync_debug_mode('error'): no host read")

    # ------------------------------------------------------ the serve path
    def serve_path(self) -> str:
        """Phase 15: (a)-(d) of the module note; every part runs, then the
        phase fails if one did."""
        out, failed = [], []
        for part in (self._block_rows_kernel, self._serve_compiled_vs_eager,
                     self._serve_engine, self._serve_no_host_reads):
            t0 = time.perf_counter()
            try:
                out.append(part())
                print(f"phase 15 part ({time.perf_counter() - t0:.1f} s): "
                      f"{out[-1]}", flush=True)
            except Exception as e:  # the phase fails below, after the rest
                traceback.print_exc()
                failed.append(f"{part.__name__}: {type(e).__name__}: {e}")
        if failed:
            raise AssertionError("; ".join(failed))
        return "; ".join(out)

    def _block_rows_kernel(self) -> str:
        """(c) the batched block quantize against its plain version, B
        lone launches and the vmap rule, bit for bit; one device kernel a
        call; its times beside its bound and the launch floor."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        gen = torch.Generator(device=self.dev).manual_seed(15)
        floor = self.floor_ms
        if floor is None:
            floor = self.floor_ms = self._launch_floor()
        table = []
        for b, n, k in ((8, 1024, 2), (8, 4500, 2), (8, 1024, 10)):
            x = torch.randn((b, n, k), generator=gen, device=self.dev) * 5
            u = torch.rand((b, n, k), generator=gen, device=self.dev)
            for qmax in (127.0, 7.0):
                got = q.quantize_dequant_block_rows(x, u, qmax)
                plain = q.quantize_dequant_block_rows_plain(x, u, qmax)
                vm = torch.func.vmap(lambda a, c, _q=qmax:
                                     ops.quantize_dequant_block(a, c, _q))(
                    x, u)
                again = q.quantize_dequant_block_rows(x, u, qmax)
                lone = [q.quantize_dequant_block(x[i], u[i], qmax)
                        for i in range(b)]
                torch.cuda.synchronize()
                for name, other in (("plain", plain), ("vmap", vm),
                                    ("a second run", again)):
                    self.require(all(torch.equal(g, o)
                                     for g, o in zip(got, other)),
                                 f"[{b}, {n}, {k}] qmax {qmax}: the batched "
                                 f"block quantize differs from {name}")
                for i in range(b):
                    self.require(all(torch.equal(g[i], o)
                                     for g, o in zip(got, lone[i])),
                                 f"[{b}, {n}, {k}] qmax {qmax}: block {i} "
                                 f"differs from its lone launch")

            def rows(x=x, u=u):
                q.quantize_dequant_block_rows(x, u, 127.0)

            def lone_launches(x=x, u=u, b=b):
                for i in range(b):
                    q.quantize_dequant_block(x[i], u[i], 127.0)
            per_call, seen = _device_kernels_per_call(rows)
            self.require(per_call == 1, f"the batched block quantize at "
                         f"[{b}, {n}, {k}]: {per_call} device kernels a "
                         f"call {seen}")
            got = q.quantize_dequant_block_rows(x, u, 127.0)
            plain = q.quantize_dequant_block_rows_plain(x, u, 127.0)
            bound, by = _bound_ms(13 * x.numel() + 4 * got[2].numel(),
                                  8 * x.numel())
            row = {"shape": [b, n, k], "ms": _cuda_time_ms(rows),
                   "device_ms": _kernel_device_ms(rows, ""),
                   "plain_ms": _cuda_time_ms(
                       lambda x=x, u=u:
                       q.quantize_dequant_block_rows_plain(x, u, 127.0)),
                   "lone_launches_ms": _cuda_time_ms(lone_launches,
                                                     reps=50),
                   "bound_ms": bound, "bound_by": by,
                   "launch_floor_device_ms": floor,
                   "kernels_a_call": per_call,
                   "max_abs_err": float((got[0] - plain[0]).abs().max())}
            table.append(row)
            if (b, n, k) == (8, 1024, 2):       # a MIMIC bucket of 8
                self.kernels["quantize_dequant_block_rows"] = {
                    "source": "src/repro_torch/csrc/quantize.cu",
                    "replaces": "src/repro/kernels/quantize.py:178",
                    **{key: row[key] for key in
                       ("max_abs_err", "ms", "device_ms", "plain_ms",
                        "bound_ms", "bound_by")},
                    "library_ms": None}
        print("block_rows_table " + json.dumps(table), flush=True)
        first = table[0]
        return (f"(c) batched block quantize at [8, 1024, 2], [8, 4500, 2], "
                f"[8, 1024, 10] = plain = vmap = B lone launches bit for "
                f"bit (int8 and int4), two runs identical, one device "
                f"kernel a call; [8, 1024, 2] device "
                f"{first['device_ms']:.5f} ms, call {first['ms']:.5f} ms "
                f"(bound {first['bound_ms']:.6f}, launch floor "
                f"{floor:.5f}, 8 lone launches {first['lone_launches_ms']:.5f}"
                f" ms)")

    def _serve_fit(self, backend, key, transport, data, rounds=10):
        """One MIMIC logistic session fitted on the card, as phase 14(b)."""
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        Xtr, ctr = data[:2]
        proto = E.Protocol(E.SessionConfig(num_classes=2, max_rounds=rounds),
                           transport=transport, backend=backend,
                           device="cuda")
        proto.fit(key, E.endpoints_for(
            [LogisticRegression(steps=SERVE_STEPS, device="cuda")
             for _ in Xtr], Xtr), ctr)
        return proto

    def _serve_compiled_vs_eager(self) -> str:
        """(a) five serve channels at MIMIC size, the compiled serve step
        against the eager serve on the card, on the 4500 held-out rows:
        four tagged or untagged calls and one with max_round 4.  For the
        ladder walk, the budget's carried-over spend is set after the fit
        so that fp32, fp16 and int8 blocks fit, and then nothing."""
        torch = self.torch
        from repro_torch.comm import codecs
        from repro_torch.comm.budget import BudgetSpec, BudgetedTransport
        from repro_torch.comm.privacy import GaussianMechanism
        from repro_torch.control.accounting import RDPAccountant
        from repro_torch.control.adaptive import ServeController
        from repro_torch.core import engine as E
        data = self._mimic_data()
        Xte = data[2]
        n, m, block = 10500, 2, (4500, 2)
        spec = BudgetSpec()
        serve_costs = spec.serve_costs(block)
        room = serve_costs[0] + serve_costs[1] + serve_costs[2] + 10
        session_bits = ((m - 1) * 2 * n * 32 + 10 * m * spec.hop_costs(n)[0]
                        + 4 * serve_costs[0])
        channels = {
            "int8": lambda: E.MeteredTransport(
                serve_codec=codecs.QuantCodec(8)),
            "int4 dp rdp": lambda: E.MeteredTransport(
                serve_codec=codecs.QuantCodec(4),
                privacy=GaussianMechanism(epsilon=1.0),
                accountant=RDPAccountant()),
            "budget walk": lambda: BudgetedTransport(
                BudgetSpec(session_bits=session_bits)),
            "margin": lambda: E.MeteredTransport(
                serve_controller=ServeController(stat="margin")),
            "entropy": lambda: E.MeteredTransport(
                serve_controller=ServeController(stat="entropy")),
        }
        calls = ((None, None), (None, 1), (None, 2), (None, 3), (4, 9))
        out = []
        for name, make in channels.items():
            runs = {}
            for backend in ("eager", "compiled"):
                transport = make()
                proto = self._serve_fit(backend, 0, transport, data)
                if hasattr(transport, "budget"):
                    self.require(not transport.exhausted,
                                 f"{name}: the fit exhausted the budget")
                    transport.carryover_bits = (session_bits - room
                                                - transport.log.total_bits)
                blocks = []
                if backend == "eager":
                    inner = transport.serve_block

                    def record(*a, _inner=inner, _blocks=blocks, **kw):
                        got = _inner(*a, **kw)
                        _blocks.append(None if got is None else got.clone())
                        return got
                    transport.serve_block = record
                else:
                    inner = proto._replay_serve

                    def record(endpoints, serve, shape, plan, _inner=inner,
                               _blocks=blocks):
                        _blocks.append(serve.blocks[1].clone()
                                       if bool(serve.sent[1]) else None)
                        return _inner(endpoints, serve, shape, plan)
                    proto._replay_serve = record
                before = len(transport.log.entries)
                self.reset_counts()
                preds = [proto.predict_distributed(Xte, max_round=mr,
                                                   request=rq).cpu()
                         for mr, rq in calls]
                torch.cuda.synchronize()
                served = transport.log.entries[before:]
                if backend == "eager":
                    ladder = ((transport.budget.ladder
                               if hasattr(transport, "budget") else ())
                              + ((transport.serve_controller.ladder
                                  if transport.serve_controller else ())
                                 + (transport.serve_codec,)))
                    quant = sum(
                        any(isinstance(c, codecs.QuantCodec)
                            and c.wire_bits(block) == e["bits"]
                            for c in ladder if c is not None)
                        for e in served)
                else:
                    quant = len(calls) * self._serve_quant(
                        proto._compiled_ctx[1])
                self.read_counts(0, f"serve {name} {backend}",
                                 quantize_dequant_block=quant)
                runs[backend] = (preds, blocks, transport, served)
            (ep, eb, et, es), (cp, cb, ct, cs) = (runs["eager"],
                                                  runs["compiled"])
            self.require(all(torch.equal(a, b) for a, b in zip(ep, cp)),
                         f"{name}: compiled and eager predictions differ")
            self.require(len(eb) == len(cb) and all(
                (a is None and b is None) or (a is not None and b is not None
                                              and torch.equal(a, b))
                for a, b in zip(eb, cb)),
                f"{name}: the shipped blocks differ, compiled vs eager")
            self.require(et.log.entries == ct.log.entries,
                         f"{name}: the ledgers differ")
            if hasattr(et, "budget"):
                self.require((ct.skipped, ct.exhausted, ct.link_spent)
                             == (et.skipped, et.exhausted, et.link_spent),
                             f"{name}: skips, exhaustion or link spend "
                             f"differ")
                rungs = [e.get("rung") for e in cs]
                self.require(rungs == [0, 1, 2] and ct.exhausted,
                             f"{name}: the serve walk was {rungs}, "
                             f"exhausted {ct.exhausted}")
            if et.accountant is not None:
                self.require(ct.accountant.releases
                             == et.accountant.releases,
                             f"{name}: DP releases differ")
            acc = float((cp[0] == data[3].cpu()).float().mean())
            out.append(f"[{name}] {len(cs)} blocks, "
                       f"{sum(e['bits'] for e in cs)} bits, shipped "
                       f"{sum(b is not None for b in cb)}/{len(cb)}, acc "
                       f"{acc:.4f}")
        return ("(a) compiled serve = eager serve on the card, mimic 4500 "
                "held-out rows, max_round None and 4 (predictions, shipped "
                "blocks, ledgers, skips, exhaustion, link spend, releases "
                "bit for bit): " + "; ".join(out))

    def _serve_stream(self, count: int, sessions: int, tenants: int,
                      n_te: int, seed: int = 0) -> list:
        """A request stream drawn from ``seed``: (tenant, session, 1024
        held-out row indices on the card)."""
        import numpy as np
        rng = np.random.default_rng(seed)
        return [(f"t{i % tenants}", f"s{int(rng.integers(sessions))}",
                 self.torch.as_tensor(rng.choice(n_te, size=1024,
                                                 replace=False),
                                      device=self.dev))
                for i in range(count)]

    def _run_engine(self, engine, stream, Xte, flush_every: int) -> dict:
        """Submit ``stream`` with request ids 0.., flushing every
        ``flush_every``; returns {rid: decision}."""
        decisions = {}
        for rid, (tenant, sid, rows) in enumerate(stream):
            decisions[rid] = engine.submit(tenant, sid,
                                           [x[rows] for x in Xte],
                                           request=rid)[1]
            if (rid + 1) % flush_every == 0:
                engine.flush()
        engine.flush()
        return decisions

    def _serve_engine(self) -> str:
        """(b) the serve engine: 8 resident MIMIC int8 sessions behind a
        cache of 4, batches of 8, 4 tenants, 256 requests of 1024 held-out
        rows, a flush every 32; every request against a standalone
        predict_distributed.  Then an engine under a per-tenant byte cap,
        DP epsilon 1 and an epsilon cap, degrading and then denying, each
        against a sequential replay of its stream."""
        torch = self.torch
        from repro_torch.comm import codecs
        from repro_torch.comm.privacy import GaussianMechanism
        from repro_torch.core import engine as E
        from repro_torch.serve import (AdmissionController, AdmissionPolicy,
                                       ServeEngine)
        data = self._mimic_data()
        Xte = data[2]
        n_te = int(Xte[0].shape[0])
        t0 = time.perf_counter()
        protos = {f"s{s}": self._serve_fit(
            "compiled", s, E.MeteredTransport(
                serve_codec=codecs.QuantCodec(8)), data,
            rounds=ENGINE_FIT_ROUNDS) for s in range(8)}
        fit_s = time.perf_counter() - t0
        self.serve_protos = protos
        engine = ServeEngine(cache_capacity=4, max_batch=8, device="cuda")
        for sid, proto in protos.items():
            engine.add_session(sid, proto)
        stream = self._serve_stream(256, 8, 4, n_te)
        self.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._run_engine(engine, stream, Xte, 32)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats, cache = engine.batcher.stats(), engine.cache.stats()
        plan = next(iter(protos.values()))._compiled_ctx[1]
        self.read_counts(0, "serve engine",
                         quantize_dequant_block_rows=stats["batches_run"]
                         * self._serve_quant(plan))
        p50 = engine.registry.quantile_all("request_seconds", 0.5)
        p99 = engine.registry.quantile_all("request_seconds", 0.99)
        checked = 0
        for rid, (tenant, sid, rows) in enumerate(stream):
            transport = protos[sid].transport
            before = len(transport.log.entries)
            base = protos[sid].predict_distributed([x[rows] for x in Xte],
                                                   request=rid)
            got = engine.outcomes[rid]
            self.require(bool((torch.as_tensor(got.preds)
                               == base.cpu()).all()),
                         f"request {rid} ({sid}): batched predictions "
                         f"differ from the standalone serve")
            bits = sum(e["bits"] for e in transport.log.entries[before:])
            self.require((got.bits, got.releases) == (bits, 0),
                         f"request {rid}: bits {got.bits} != {bits}")
            checked += 1
        self.require(cache["spills"] > 0 and cache["restores"] > 0,
                     f"the cache never spilled and restored: {cache}")
        # one more flush of 32 requests under the profiler: where a
        # flush's time goes, and the device's idle share
        extra = self._serve_stream(32, 8, 4, n_te, seed=2)

        def one_flush():
            for i, (tenant, sid, rows) in enumerate(extra):
                engine.submit(tenant, sid, [x[rows] for x in Xte],
                              request=256 + i)
            engine.flush()
        print("serve_engine_profile "
              + json.dumps(_device_profile(one_flush)), flush=True)
        engine.close()
        line = (f"(b) serve engine, 8 mimic int8 sessions (fit "
                f"{fit_s:.1f} s), cache 4, batch 8, 4 tenants, 256 "
                f"requests of 1024 rows in {secs:.3f} s = "
                f"{256 / secs:.1f} requests/s, request_seconds p50 "
                f"{p50:.5f} p99 {p99:.5f}; batches {stats['batches_run']} "
                f"slots {stats['slots_run']} pads {stats['padded_slots']}, "
                f"cache hits {cache['hits']} spills {cache['spills']} "
                f"restores {cache['restores']}; all {checked} requests = "
                f"standalone predict_distributed (preds, bits, releases)")
        print("serve_engine " + json.dumps(
            {"requests": 256, "seconds": secs, "requests_per_s": 256 / secs,
             "p50_s": p50, "p99_s": p99, **stats, **cache}), flush=True)
        # the admission gates: DP sessions, a byte cap of five full
        # requests a tenant and an epsilon cap of eight releases
        mech = GaussianMechanism(epsilon=1.0)
        dp = {f"s{s}": self._serve_fit(
            "compiled", s, E.MeteredTransport(
                serve_codec=codecs.QuantCodec(8), privacy=mech), data,
            rounds=ENGINE_FIT_ROUNDS) for s in range(4)}
        full = codecs.QuantCodec(8).wire_bits((1024, 2))
        stream = self._serve_stream(64, 4, 4, n_te, seed=1)
        shown = []
        for allow in (True, False):
            results = []
            for every in (16, 1):           # batched, then sequential
                eng = ServeEngine(
                    cache_capacity=4, max_batch=8, device="cuda",
                    admission=AdmissionController(
                        AdmissionPolicy(allow_degrade=allow,
                                        epsilon_cap=8.0),
                        tenant_bits=5 * full, mechanism=mech))
                for sid, proto in dp.items():
                    eng.add_session(sid, proto)
                decisions = self._run_engine(eng, stream, Xte, every)
                results.append((decisions, eng.admission.counters(),
                                {rid: (None if o.preds is None
                                       else o.preds.tolist(), o.bits,
                                       o.releases)
                                 for rid, o in eng.outcomes.items()},
                                {sid: dict(meta.accountant.releases)
                                 for sid, meta in eng.sessions.items()}))
                eng.close()
            (bd, bc, bo, br), (sd, sc, so, sr) = results
            self.require([d.outcome for d in bd.values()]
                         == [d.outcome for d in sd.values()],
                         f"allow_degrade={allow}: batched and sequential "
                         f"decisions differ")
            self.require(bc == sc and bo == so and br == sr,
                         f"allow_degrade={allow}: batched and sequential "
                         f"counters or outcomes differ")
            outcomes = {d.outcome for d in bd.values()}
            want = {"accept", "degrade" if allow else "deny"}
            self.require(outcomes == want, f"allow_degrade={allow}: "
                         f"outcomes {outcomes}, expected {want}")
            shown.append(f"allow_degrade={allow}: " + ", ".join(
                f"{o} {sum(d.outcome == o for d in bd.values())}"
                for o in sorted(outcomes)) + f" (tenant t0 {bc['t0']})")
        return (line + "; admission (4 DP sessions, byte cap 5 requests, "
                "epsilon cap 8, 64 requests) = sequential replay: "
                + "; ".join(shown))

    def _serve_no_host_reads(self) -> str:
        """(d) serve_batch on inputs already on the card under
        set_sync_debug_mode("error"): no host read inside."""
        torch = self.torch
        from repro_torch.comm import codecs
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        data = self._mimic_data()
        Xte = data[2]
        proto = self._serve_fit("compiled", 0, E.MeteredTransport(
            serve_codec=codecs.QuantCodec(8)), data)
        _, plan, result = proto._compiled_ctx
        m = plan.num_agents
        slots = [{"Xs": [x[b * 400:b * 400 + 1024] for x in Xte],
                  "params": result.params, "alphas": result.alphas,
                  "valid": result.valid,
                  "rem_session": torch.full((), C._INT32_MAX,
                                            dtype=torch.int32,
                                            device=self.dev),
                  "rem_link": torch.full((m,), C._INT32_MAX,
                                         dtype=torch.int32, device=self.dev),
                  "deliver": torch.ones(m, dtype=torch.bool,
                                        device=self.dev)} for b in range(8)]
        key = proto._session.state.key
        draws = C._serve_draws_for(plan, [key] * 8, list(range(8)), 1024,
                                   self.dev, [None] * 8)
        C.serve_batch(plan, slots, draws=draws)     # warm-up
        torch.cuda.synchronize()
        self.reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = C.serve_batch(plan, slots, draws=draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.read_counts(0, "sync-checked serve_batch",
                         quantize_dequant_block_rows=self._serve_quant(plan))
        alone = C.serve_session(plan, result, key, slots[3]["Xs"],
                                request=3)
        self.require(all(torch.equal(f[3], g) for f, g in zip(res, alone)),
                     "the sync-checked batch's slot 3 differs from "
                     "serve_session")
        return ("(d) serve_batch of 8 mimic slots ran under "
                "set_sync_debug_mode('error'): no host read; slot 3 = "
                "serve_session")

    # ------------------------------------------- scenarios and protocols
    def scenarios(self) -> str:
        t0 = time.perf_counter()
        parts = [self._scenario_ascii(), self._scenario_al(),
                 self._scenario_fedavg(), self._scenario_sync()]
        secs = time.perf_counter() - t0
        return "; ".join(parts) + f"; phase 16 {secs:.1f} s"

    def _scenario_ascii(self) -> str:
        """(a) MIMIC ASCII under the churn, noniid and subsample presets and
        the async barrier with a clock skew of (0, 2): card = CPU bit for
        bit (participants, components, alphas, ledger, predictions); one
        ignorance launch a participating hop (an unnormalized one a
        positive alpha in the async merge)."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.learners.tree import DecisionTree
        from repro_torch.scenarios import PRESETS, Scenario
        configs = [("churn", PRESETS["churn"], False),
                   ("noniid", PRESETS["noniid"], False),
                   ("subsample", PRESETS["subsample"], False),
                   ("async clock_skew=(0,2)",
                    Scenario("skew", clock_skew=(0, 2)), True)]
        out = []
        for name, scen, stale in configs:
            runs = {}
            for device in ("cuda", "cpu"):
                Xtr, ctr, Xte, cte = self._mimic_data(device)
                proto = E.Protocol(
                    E.SessionConfig(num_classes=2, max_rounds=10),
                    scheduler=(E.AsyncStaleScheduler() if stale
                               else E.SequentialScheduler()),
                    transport=E.MeteredTransport(), scenario=scen,
                    device=device)
                eps = E.endpoints_for([DecisionTree(depth=4,
                                                    num_thresholds=16,
                                                    device=device)
                                       for _ in Xtr], Xtr)
                if device == "cuda":
                    self.reset_counts()
                t0 = time.perf_counter()
                session = proto.start(0, eps, ctr)
                session.run()
                preds = session.fitted().predict(Xte)
                if device == "cuda":
                    torch.cuda.synchronize()
                    comps = len(session.state.components)
                    if stale:
                        self.read_counts(0, f"mimic {name}",
                                         ignorance_update_unnormalized=comps)
                    else:
                        self.read_counts(comps, f"mimic {name}")
                runs[device] = (session, preds.cpu(), cte.cpu(),
                                time.perf_counter() - t0)
            (gs, gp, cte, gsec), (cs, cp, _, csec) = runs["cuda"], runs["cpu"]
            self.require(gs.state.history == cs.state.history,
                         f"{name}: participants, alphas or accuracies "
                         f"differ between card and CPU")
            self.require([(c.agent, c.round, c.alpha)
                          for c in gs.state.components]
                         == [(c.agent, c.round, c.alpha)
                             for c in cs.state.components],
                         f"{name}: components differ between card and CPU")
            self.require(gs.transport.log.entries
                         == cs.transport.log.entries,
                         f"{name}: ledgers differ between card and CPU")
            self.require(torch.equal(gp, cp),
                         f"{name}: predictions differ between card and CPU")
            w_err = float((gs.state.w.cpu() - cs.state.w).abs().max())
            self.require(w_err <= 1e-6, f"{name}: w differs by {w_err}")
            hist = gs.state.history
            sizes = [len(r["participants"]) for r in hist]
            if scen.has_churn:
                self.require(min(sizes) < 2, f"{name}: no round churned")
            acc = float((gp == cte).float().mean())
            out.append(f"[{name}] rounds={len(hist)} participants={sizes} "
                       f"components={len(gs.state.components)} "
                       f"acc={acc:.4f} w_bit_equal="
                       f"{torch.equal(gs.state.w.cpu(), cs.state.w)} "
                       f"card {gsec:.2f} s cpu {csec:.2f} s")
        return ("(a) mimic ascii under scenarios, card = cpu bit for bit: "
                + " ".join(out))

    def _scenario_al(self) -> str:
        """(b) MIMIC Assisted Learning through the CLI's make_transport:
        int8, int4 with DP epsilon 1, a byte budget that degrades fp32 -> int4
        and then exhausts; card = CPU: ledger = wire_bits exactly,
        residuals within 1e-5 of max|R|; one block quantize an int-coded
        shipped hop."""
        torch = self.torch
        from repro_torch.comm.budget import BudgetSpec
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import engine as E
        from repro_torch.launch import session as cli
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.scenarios import make_variant
        n, m = 10500, 2
        block = (n, 2)
        costs = BudgetSpec().payload_costs(block)
        budget = -(-((m - 1) * 2 * n * 32 + sum(costs) + 100) // 8)
        configs = [["--codec", "int8"],
                   ["--codec", "int4", "--dp-epsilon", "1"],
                   ["--byte-budget", str(budget)]]
        out = []
        for argv in configs:
            name = " ".join(argv)
            runs = {}
            for device in ("cuda", "cpu"):
                args = cli.parser().parse_args(
                    ["--device", device, "--protocol", "al", *argv])
                cli.check_args(args)
                scen = cli.make_scenario(args)
                transport = cli.make_transport(args, scen)
                Xtr, ctr, Xte, cte = self._mimic_data(device)
                proto = E.Protocol(E.SessionConfig(num_classes=2,
                                                   max_rounds=10),
                                   transport=transport,
                                   variant=make_variant("al"), device=device)
                eps = E.endpoints_for([LogisticRegression(device=device)
                                       for _ in Xtr], Xtr)
                if device == "cuda":
                    self.reset_counts()
                t0 = time.perf_counter()
                session = proto.start(0, eps, ctr)
                session.run()
                preds = session.fitted().predict(Xte)
                if device == "cuda":
                    torch.cuda.synchronize()
                runs[device] = (session, transport, preds.cpu(), cte.cpu(),
                                time.perf_counter() - t0)
            (gs, gt, gp, cte, gsec), (cs, ct, cp, _, csec) = (runs["cuda"],
                                                               runs["cpu"])
            coded = 0
            for e in gt.log.entries:
                if e["kind"] != "residual":
                    continue
                codec = (gt.budget.ladder[e["rung"]] if "rung" in e
                         else gt.codec)
                self.require(e["bits"] == codec.wire_bits(block),
                             f"al {name}: ledger entry {e} != wire_bits")
                coded += isinstance(codec, QuantCodec)
            self.read_counts(0, f"al {name}", quantize_dequant_block=coded)
            self.require(gt.log.entries == ct.log.entries,
                         f"al {name}: card and CPU ledgers differ")
            self.require([(c.agent, c.round) for c in gs.state.components]
                         == [(c.agent, c.round)
                             for c in cs.state.components],
                         f"al {name}: components differ")
            gR, cR = gs.state.proto["R"].cpu(), cs.state.proto["R"]
            r_err = float((gR - cR).abs().max())
            r_tol = 1e-5 * max(1.0, float(cR.abs().max()))
            self.require(r_err <= r_tol,
                         f"al {name}: residual differs by {r_err} > {r_tol}")
            agree = float((gp == cp).float().mean())
            extra = ""
            if hasattr(gt, "budget"):
                used = sorted({e["rung"] for e in gt.log.entries
                               if "rung" in e})
                self.require(used == [0, 1, 2, 3] and gt.exhausted,
                             f"al {name}: the walk used rungs {used}, "
                             f"exhausted={gt.exhausted}")
                extra = (f" rungs={used} skipped={len(gt.skipped)} "
                         f"exhausted={gt.exhausted}")
            if gt.privacy is not None:
                extra += f" releases={sum(gt.accountant.releases.values())}"
            out.append(f"[{name}] components={len(gs.state.components)}"
                       f"{extra} residual_bits="
                       f"{gt.log.bits_by_kind().get('residual', 0)} "
                       f"block_quantize={coded} R_err={r_err:.3g} "
                       f"acc={float((gp == cte).float().mean()):.4f} "
                       f"predictions_agree={agree:.4f} card {gsec:.2f} s "
                       f"cpu {csec:.2f} s")
        return ("(b) mimic assisted learning [10500, 2] residuals, card = "
                "cpu ledgers, R within 1e-5 max|R|: " + " ".join(out))

    def _fedavg_budget(self, d: int, n: int) -> int:
        """Bytes that setup, one fp32 round and an fp16 uplink use up:
        round 1 degrades, round 2 skips and exhausts."""
        return -(-((2 - 1) * 2 * n * 32 + 2 * d * 32 + d * 16 + d * 8)
                 // 8)

    def _scenario_fedavg(self) -> str:
        """(c) Fashion FedAvg at full width, logistic and the paper's
        MLP(128, 64), FEDAVG_STEPS steps a round, FEDAVG_ROUNDS rounds, under fp32,
        int8, int4, DP epsilon 1 with subsampled-rdp under the subsample
        preset, and a byte budget: the card's one-program FedAvg = its
        eager FedAvg bit for bit (g, history, ledger, rungs, skips,
        releases, exhaustion); quantize launches = int-coded shipped
        uplinks eager, slots x int rungs compiled; int4 encode -> decode
        of a real uplink = its roundtrip."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import engine as E
        from repro_torch.launch import session as cli
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.learners.mlp import MLP
        from repro_torch.scenarios import make_variant
        from repro_torch.scenarios.protocols import param_template
        Xtr, ctr, Xte, cte = self._fashion_data()
        n = int(ctr.shape[0])
        learners = {
            f"logistic({FEDAVG_STEPS})": lambda: LogisticRegression(
                steps=FEDAVG_STEPS, device="cuda"),
            "mlp(128,64)": lambda: MLP(hidden=(128, 64), steps=FEDAVG_STEPS,
                                       device="cuda")}
        ascii_acc = (f"{self.fashion_fp32[4]:.4f}" if self.fashion_fp32
                     else "not run")
        out = []
        for lname, make in learners.items():
            core = make().core(10)
            d = param_template(core, (int(Xtr[0].shape[1]),)).size
            channels = [[], ["--codec", "int8"], ["--codec", "int4"],
                        ["--dp-epsilon", "1", "--accountant",
                         "subsampled-rdp", "--scenario", "subsample"],
                        ["--byte-budget", str(self._fedavg_budget(d, n))]]
            for argv in channels:
                name = " ".join(argv) or "fp32"
                runs = {}
                for backend in ("eager", "compiled"):
                    args = cli.parser().parse_args(
                        ["--protocol", "fedavg", "--learner", "logistic",
                         "--backend", backend, *argv])
                    cli.check_args(args)
                    scen = cli.make_scenario(args)
                    transport = cli.make_transport(args, scen)
                    captured = []
                    if backend == "eager" and argv == ["--codec", "int4"]:
                        inner = transport.ship

                        def ship(src, dst, payload, wrap, *, draws=None,
                                 _inner=inner):
                            if not captured:
                                captured.append((payload.clone(), draws))
                            return _inner(src, dst, payload, wrap,
                                          draws=draws)
                        transport.ship = ship
                    proto = E.Protocol(
                        E.SessionConfig(num_classes=10,
                                        max_rounds=FEDAVG_ROUNDS),
                        transport=transport, variant=make_variant("fedavg"),
                        scenario=None if scen.trivial else scen,
                        backend=backend, device="cuda")
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    self.reset_counts()
                    t0 = time.perf_counter()
                    fit = proto.fit(0, E.endpoints_for(
                        [make() for _ in Xtr], Xtr), ctr)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    ladder = (transport.budget.ladder
                              if hasattr(transport, "budget")
                              else (transport.codec,))
                    if backend == "eager":
                        want = sum(
                            isinstance(ladder[e.get("rung", 0)], QuantCodec)
                            for e in transport.log.entries
                            if e["kind"] == "gradient"
                            and e["src"] != "agent0")
                    else:
                        want = FEDAVG_ROUNDS * (len(Xtr) - 1) * sum(
                            isinstance(c, QuantCodec) for c in ladder)
                    self.read_counts(0, f"fedavg {lname} {name} {backend}",
                                     quantize_dequant_tiles=want)
                    acc = float((fit.predict(Xte) == cte).float().mean())
                    runs[backend] = (fit, transport, secs, peak, acc, want)
                    if captured:
                        out.append(self._int4_uplink(*captured[0]))
                (ef, et, esec, epeak, eacc, ewant), \
                    (cf, ct, csec, cpeak, _, cwant) = (runs["eager"],
                                                       runs["compiled"])
                where = f"fedavg {lname} {name}"
                self.require(torch.equal(cf.g, ef.g),
                             f"{where}: compiled g != eager g")
                self.require(cf.history == ef.history,
                             f"{where}: compiled history != eager")
                self.require(ct.log.entries == et.log.entries,
                             f"{where}: compiled ledger != eager")
                for attr in ("skipped", "exhausted", "link_spent"):
                    self.require(getattr(ct, attr, None)
                                 == getattr(et, attr, None),
                                 f"{where}: {attr} differs")
                if et.accountant is not None:
                    self.require(ct.accountant.releases
                                 == et.accountant.releases,
                                 f"{where}: DP releases differ")
                extra = ""
                if hasattr(et, "budget"):
                    used = sorted({e["rung"] for e in et.log.entries
                                   if "rung" in e})
                    self.require(et.exhausted and et.skipped,
                                 f"{where}: the budget never ran dry")
                    extra = (f" rungs={used} skipped={len(et.skipped)} "
                             f"exhausted={et.exhausted}")
                if et.accountant is not None:
                    rep = et.accountant.report(et.privacy)
                    eps = max(r["epsilon"] for r in rep.values())
                    extra += (" releases=" + json.dumps(
                        {a: r["releases"] for a, r in rep.items()})
                        + f" eps={eps:.3f}")
                rounds = max(1, len(ef.history))
                out.append(
                    f"[{lname} {name}] d={d} rounds={len(ef.history)} "
                    f"acc={eacc:.4f} (ascii fp32 {ascii_acc}) "
                    f"bits={et.total_bits}{extra} quantize eager={ewant} "
                    f"compiled={cwant}; eager {esec:.2f} s "
                    f"({esec * 1e3 / rounds:.0f} ms a round, peak "
                    f"{epeak:.3f} GiB), compiled {csec:.2f} s "
                    f"({csec * 1e3 / FEDAVG_ROUNDS:.0f} ms a round, peak "
                    f"{cpeak:.3f} GiB); g, history, ledger bit-equal")
        return (f"(c) fashion fedavg n_train=42000 agents=(392,392) "
                f"{FEDAVG_ROUNDS} rounds, compiled = eager on the card: "
                + " ".join(out))

    def _int4_uplink(self, delta, draws) -> str:
        """int4's encode (quantize with the pack fused in) then decode
        (the unpack fused with the dequantize) of a real uplink's delta =
        its roundtrip; each one launch."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        codec = QuantCodec(bits=4)
        self.reset_counts()
        wire, _ = codec.encode(delta, draws)
        decoded = codec.decode(wire)
        fused, _ = codec.roundtrip(delta, draws)
        torch.cuda.synchronize()
        self.read_counts(0, "int4 uplink encode/decode",
                         quantize_pack_int4=1, unpack_dequant_int4=1,
                         quantize_dequant_tiles=1)
        self.require(torch.equal(decoded, fused),
                     "int4 encode -> decode != roundtrip on an uplink")
        step = float(wire[1].max())
        self.require(float((decoded - delta).abs().max()) <= step,
                     "int4: an uplink element is more than one step off")
        return (f"[int4 uplink d={delta.numel()}] encode -> decode = "
                f"roundtrip, within one step")

    def _scenario_sync(self) -> str:
        """(d) One Fashion FedAvg program (logistic, 30 steps, DP and a
        byte budget, the churn preset) under set_sync_debug_mode("error")
        after a warm-up: no host read."""
        torch = self.torch
        from repro_torch.comm import BudgetSpec, GaussianMechanism
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.scenarios import PRESETS
        from repro_torch.scenarios import compiled as SC
        from repro_torch.scenarios.protocols import fedavg_fit_weights
        Xtr, ctr, _, _ = self._fashion_data()
        n = int(ctr.shape[0])
        core = LogisticRegression(steps=30, device="cuda").core(10)
        shape = (int(Xtr[0].shape[1]),)
        plan = SC.FedAvgPlan(
            core=core, num_classes=10, num_agents=2, max_rounds=5,
            privacy=GaussianMechanism(epsilon=1.0, nonneg=False),
            budget=BudgetSpec(session_bits=8 * self._fedavg_budget(3930,
                                                                   n)))
        draws = SC.draws_for(plan, 0, n, shape, self.dev)
        mask = torch.from_numpy(PRESETS["churn"].participation(5, 2)).to(
            self.dev)
        fit_w = fedavg_fit_weights(ctr, 2)
        fn = SC.make_fedavg_fn(plan, shape)
        fn(draws, tuple(Xtr), ctr, mask, fit_w)         # warm-up
        torch.cuda.synchronize()
        self.reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn(draws, tuple(Xtr), ctr, mask, fit_w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.read_counts(0, "sync-checked fedavg program",
                         quantize_dequant_tiles=5 * 2)
        again = SC.fedavg_session(plan, 0, Xtr, ctr, mask, fit_w)
        self.require(torch.equal(res.g, again.g),
                     "the sync-checked program's g != fedavg_session's")
        return ("(d) one fashion fedavg program (DP, budget, churn) under "
                "set_sync_debug_mode('error'): no host read; = "
                "fedavg_session")

    # ----------------------------------------------------------- telemetry
    def telemetry(self) -> str:
        """Phase 17: telemetry on = off, card = CPU registries, live
        programs, the serve engine's spans and taps, the profiler."""
        table: dict = {"part_seconds": {}}
        parts = []
        for part in (self._tele_sessions, self._tele_live, self._tele_serve,
                     self._tele_profile):
            t0 = time.perf_counter()
            parts.append(part(table))
            table["part_seconds"][part.__name__] = time.perf_counter() - t0
        print("telemetry_table " + json.dumps(table), flush=True)
        return " ".join(parts)

    @staticmethod
    def _launch_snapshot() -> dict:
        return {name: fn.launches for name, fn in _counters().items()}

    #: phase 17's timed runs, telemetry off (False) and on (True), in
    #: alternating order so that neither side always runs first
    TELE_ORDER = (False, True, True, False, False, True)

    @staticmethod
    def _tele_overhead(off: list, on: list) -> tuple[dict, str]:
        """Each run's seconds, the medians, telemetry's overhead as the
        ratio of the medians, and each side's spread ((max - min) /
        median); the row and its text."""
        m_off, m_on = statistics.median(off), statistics.median(on)
        row = {"seconds_off": off, "seconds_on": on, "median_off": m_off,
               "median_on": m_on, "overhead": m_on / m_off - 1,
               "spread_off": (max(off) - min(off)) / m_off,
               "spread_on": (max(on) - min(on)) / m_on}
        text = (f"off {m_off:.3f} s ({min(off):.3f}-{max(off):.3f}) on "
                f"{m_on:.3f} s ({min(on):.3f}-{max(on):.3f}), medians' "
                f"overhead {row['overhead']:+.3f}, spread off "
                f"{row['spread_off']:.3f} on {row['spread_on']:.3f}")
        return row, text

    @staticmethod
    def _tele_counters(reg) -> dict:
        return {name: reg.series(name) for name in reg.counter_names()}

    def _tele_tree(self, tracer, want: set, where: str) -> None:
        """The span tree is well formed, and its (name, parent's name)
        pairs are ``want``."""
        by_id = {s.span_id: s for s in tracer.spans}
        got = {(s.name, None if s.parent_id is None
                else by_id[s.parent_id].name) for s in tracer.spans}
        self.require(tracer.well_formed() and got == want,
                     f"{where}: span tree {sorted(got, key=str)} != "
                     f"{sorted(want, key=str)}")

    def _tele_artifacts(self, tele, transport, name: str) -> None:
        """Trace, snapshot and .prom of ``tele`` pass the checker, and the
        trace reloads the registry's counters."""
        from repro_torch.telemetry import check as tcheck
        from repro_torch.telemetry import export as texport
        base = os.path.join(SMOKE_DIR, f"telemetry_{name}")
        paths = [base + s for s in (".jsonl", ".json", ".prom")]
        tele.write_artifacts(trace=paths[0], metrics_out=paths[1],
                             transport=transport)
        tele.write_artifacts(metrics_out=paths[2])
        for path in paths:
            errors = tcheck.validate_file(path)
            self.require(not errors, f"{path}: {errors[:3]}")
        self.require(self._tele_counters(texport.load_registry(paths[0]))
                     == self._tele_counters(tele.registry),
                     f"{name}: the trace does not reload the registry")

    def _tele_sessions(self, table: dict) -> str:
        """(a) MIMIC trees eager and MIMIC logistic(SERVE_STEPS) compiled
        (the resid controller, an int8 serve codec, DP epsilon 1), each three
        times with and three times without Telemetry on the card, in
        ``TELE_ORDER``, and with it on the CPU."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.launch import session as cli
        from repro_torch.learners.tree import DecisionTree
        from repro_torch.telemetry import Telemetry
        data = {d: self._mimic_data(d) for d in ("cuda", "cpu")}
        argv = ["--learner", "logistic", "--backend", "compiled",
                "--controller", "resid", "--serve-codec", "int8",
                "--dp-epsilon", "1"]

        def build(kind, device, steps=SERVE_STEPS):
            if kind == "eager":
                cfg = E.SessionConfig(num_classes=2, max_rounds=10)
                transport = E.MeteredTransport()
                learners = [DecisionTree(depth=4, num_thresholds=16,
                                         device=device) for _ in range(2)]
                return cfg, transport, learners, "eager"
            args = cli.parser().parse_args(["--device", device, "--steps",
                                            str(steps), *argv])
            cli.check_args(args)
            return (E.SessionConfig(num_classes=2, max_rounds=10),
                    cli.make_transport(args),
                    [cli.LEARNERS["logistic"](args) for _ in range(2)],
                    "compiled")

        def run(kind, device, tele):
            Xtr, ctr, Xte, _ = data[device]
            cfg, transport, learners, backend = build(kind, device)
            proto = E.Protocol(cfg, transport=transport, backend=backend,
                               telemetry=tele, device=device)
            eps = E.endpoints_for(learners, Xtr)
            self.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fitted = proto.fit(0, eps, ctr)
            preds = proto.predict_distributed(Xte)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            snap = self._launch_snapshot()
            where = f"telemetry {kind} {'on' if tele else 'off'}"
            if device == "cuda" and kind == "eager":
                self.read_counts(len(fitted.components), where)
            elif device == "cuda":
                self._compiled_counts(proto._compiled_ctx[1], False, where,
                                      served=1)
            w = (proto._compiled_result.w if backend == "compiled"
                 else proto._session.state.w)
            return dict(proto=proto, fitted=fitted, preds=preds.cpu(),
                        w=w.cpu(), secs=secs, snap=snap, tele=tele)

        out, self.tele_dark = [], {}
        for kind in ("eager", "compiled"):
            # an untimed dark run first (the reference of the checks), so
            # that no timed run pays a first call's warm-up
            dark = run(kind, "cuda", None)
            runs = [run(kind, "cuda", Telemetry() if lit else None)
                    for lit in self.TELE_ORDER]
            cpu = run(kind, "cpu", Telemetry())
            lit = runs[self.TELE_ORDER.index(True)]
            self.tele_dark[kind] = dict(
                dark, build=lambda steps=SERVE_STEPS, _kind=kind: build(
                    _kind, "cuda", steps))
            for other in runs:
                t_d, t_o = dark["proto"].transport, other["proto"].transport
                self.require(torch.equal(other["w"], dark["w"])
                             and torch.equal(other["preds"], dark["preds"]),
                             f"{kind}: w or predictions differ with "
                             f"telemetry")
                self.require(t_o.log.entries == t_d.log.entries,
                             f"{kind}: ledgers differ with telemetry")
                self.require([c.alpha for c in other["fitted"].components]
                             == [c.alpha for c in dark["fitted"]
                                 .components], f"{kind}: alphas differ")
                if t_d.accountant is not None:
                    self.require(t_o.accountant.releases
                                 == t_d.accountant.releases,
                                 f"{kind}: DP releases differ")
                self.require(other["snap"] == dark["snap"],
                             f"{kind}: launches {other['snap']} != "
                             f"{dark['snap']} without telemetry")
            reg = lit["tele"].registry
            self.require(self._tele_counters(reg)
                         == self._tele_counters(cpu["tele"].registry),
                         f"{kind}: the card's counters differ from the "
                         f"CPU's")
            self.require(reg.total("wire_bits_total")
                         == lit["proto"].transport.log.total_bits,
                         f"{kind}: wire_bits_total != the ledger")
            want = ({("session", None), ("round", "session"),
                     ("hop", "round"), ("serve", None)} if kind == "eager"
                    else {("session", None), ("replay", None),
                          ("serve", None)})
            self._tele_tree(lit["tele"].tracer, want, kind)
            self._tele_artifacts(lit["tele"], lit["proto"].transport, kind)
            row, timing = self._tele_overhead(
                [r["secs"] for r, on in zip(runs, self.TELE_ORDER)
                 if not on],
                [r["secs"] for r, on in zip(runs, self.TELE_ORDER) if on])
            row["bits"] = lit["proto"].transport.total_bits
            if kind == "eager":
                for name in ("session", "round", "hop"):
                    row[f"{name}_p50_s"] = reg.quantile(
                        "span_seconds", 0.5, name=name)
            table[f"{kind}_session"] = row
            out.append(f"[{kind}] on = off (w, ledger, releases, "
                       f"predictions, launches), card counters = CPU's, "
                       f"{timing}")
        return ("(a) mimic trees eager, logistic compiled (resid "
                "controller, int8 serve, DP 1): " + "; ".join(out)
                + "; span trees well formed, trace/json/prom pass the "
                "checker")

    def _tele_live(self, table: dict) -> str:
        """(b) the compiled session of (a) with live taps, a fleet of 8
        MIMIC int8 sessions with live taps, and both under
        set_sync_debug_mode("error")."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.core.engine import LabelsMsg, SampleIdsMsg
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.telemetry import MetricsRegistry, Telemetry
        from repro_torch.telemetry.live import LiveSink, installed
        dark = self.tele_dark["compiled"]
        Xtr, ctr, Xte, _ = self._mimic_data()
        n = int(ctr.shape[0])
        # the Protocol run with Telemetry(live=True) against (a)'s dark run
        tele = Telemetry(live=True)
        dproto = dark["proto"]
        cfg, transport, learners, backend = dark["build"]()
        proto = E.Protocol(cfg, transport=transport, backend=backend,
                           telemetry=tele, device="cuda")
        self.reset_counts()
        proto.fit(0, E.endpoints_for(learners, Xtr), ctr)
        preds = proto.predict_distributed(Xte).cpu()
        torch.cuda.synchronize()
        self.require(self._launch_snapshot() == dark["snap"],
                     "live session: launches differ from the dark run's")
        plan = proto._compiled_ctx[1]
        self._compiled_counts(plan, False, "live session", served=1)
        self.require(torch.equal(proto._compiled_result.w.cpu(), dark["w"])
                     and torch.equal(preds, dark["preds"])
                     and transport.log.entries
                     == dproto.transport.log.entries
                     and transport.accountant.releases
                     == dproto.transport.accountant.releases,
                     "live session != its dark run")
        reg = tele.registry
        for live_name, name, kind in (
                ("live_wire_bits_total", "wire_bits_total", None),
                ("live_messages_total", "messages_total", "ignorance"),
                ("live_messages_total", "messages_total", "score_block"),
                ("live_budget_skips_total", "budget_skips_total", None)):
            got = (reg.total(live_name) if kind is None
                   else reg.value(live_name, kind=kind))
            want = (reg.total(name) if kind is None
                    else reg.value(name, kind=kind))
            self.require(got == want, f"live session: {live_name}"
                         f"{'' if kind is None else '{' + kind + '}'} "
                         f"{got} != replay-booked {want}")
        session_copies = tele.live.copies
        # the same program, its draws taken first, under sync debug mode
        shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
        fn = C.make_session_fn(plan, shapes, live=True)
        draws = C._draws_for(plan, E.key_data(0), n, shapes, self.dev, None,
                             fleet=False)
        sink = LiveSink(MetricsRegistry())
        with installed(sink):
            self.reset_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = fn(draws, tuple(Xtr), ctr)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self._compiled_counts(plan, False, "sync-checked live session")
        fit_bits = sum(e["bits"] for e in transport.log.entries
                       if e["kind"] != "score_block")
        self.require(torch.equal(res.w, proto._compiled_result.w)
                     and sink.registry.total("live_wire_bits_total")
                     == fit_bits, "the sync-checked live session differs")
        # every device operation of a dark and a live session program: the
        # hand-written kernels' launches are equal (above), the taps add
        # their pricing and packing ops and one copy a round.  Counted at
        # one logistic step a fit: the taps do not depend on the steps,
        # and the profiler takes about a minute over 50 steps' ~80000
        # kernels
        cfg1, transport1, learners1, _ = dark["build"](steps=1)
        proto1 = E.Protocol(cfg1, transport=transport1, backend="compiled",
                            device="cuda")
        proto1.fit(0, E.endpoints_for(learners1, Xtr), ctr)
        plan1 = proto1._compiled_ctx[1]
        draws1 = C._draws_for(plan1, E.key_data(0), n, shapes, self.dev,
                              None, fleet=False)
        ops = {}
        for mode in ("dark", "live"):
            fn1 = C.make_session_fn(plan1, shapes, live=mode == "live")
            sink = LiveSink(MetricsRegistry())
            with installed(sink if mode == "live" else None):
                ops[mode] = _device_op_counts(
                    lambda: fn1(draws1, tuple(Xtr), ctr))
        ops["tap_copies"] = sink.copies
        # a fleet of 8 MIMIC int8 sessions, dark and live
        fplan = C.plan_for([LogisticRegression(steps=SERVE_STEPS,
                                               device="cuda")] * 2, 2,
                           max_rounds=10, codec=QuantCodec(8))
        keys = list(range(8))
        runs = {}
        for mode in ("dark", "live", "checked"):
            sink = LiveSink(MetricsRegistry())
            self.reset_counts()
            with installed(sink if mode != "dark" else None):
                if mode == "checked":
                    vfn = torch.func.vmap(
                        C.make_session_fn(fplan, shapes, live=True),
                        in_dims=(0, None, None))
                    fdraws = C._draws_for(fplan, [E.key_data(k)
                                                  for k in keys], n, shapes,
                                          self.dev, None, fleet=True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        res = vfn(fdraws, tuple(Xtr), ctr)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = C.fleet_run(fplan, keys, Xtr, ctr,
                                      live=mode != "dark")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            snap = self._launch_snapshot()
            self._compiled_counts(fplan, True, f"{mode} fleet")
            runs[mode] = (res, sink, snap, secs)
        fdark = runs["dark"][0]
        for mode in ("live", "checked"):
            res, sink, snap, _ = runs[mode]
            self.require(all(torch.equal(a, b) for a, b in zip(res, fdark)
                             if isinstance(a, torch.Tensor)),
                         f"{mode} fleet != the dark fleet")
            self.require(snap == runs["dark"][2],
                         f"{mode} fleet: launches differ")
        # the fleet's sums = the sessions' priced one by one from the dark
        # fleet's result, as each session's replay books them
        setup = LabelsMsg("", "", n).bits + SampleIdsMsg("", "", n).bits
        hop = QuantCodec(8).wire_bits(n) + 32
        sent = fdark.sent.cpu()
        want = {"live_wire_bits_total": sum(
                    setup + hop * int(sent[f].sum()) for f in keys),
                "live_rounds_total": int(fdark.executed.cpu().any(-1).sum()),
                "live_messages_total": int(sent.sum())}
        for mode in ("live", "checked"):
            got = {name: runs[mode][1].registry.total(name) for name in want}
            self.require(got == want, f"{mode} fleet: live sums {got} != "
                         f"the sessions' {want}")
        fleet_copies = runs["live"][1].copies
        table["live"] = {"session_tap_copies": session_copies,
                         "fleet_tap_copies": fleet_copies,
                         "fleet_seconds": {m: runs[m][3] for m in runs},
                         "session_device_ops": ops}
        added = {k: ops["live"][k] - ops["dark"][k] for k in ops["dark"]}
        return (f"(b) live compiled session = dark (w, ledger, releases, "
                f"predictions, launches), live_* = replay, "
                f"{session_copies} tap copies (10 rounds + 1 serve); live "
                f"fleet of 8 mimic int8 = dark, live sums = the sessions' "
                f"({want['live_wire_bits_total']} bits), {fleet_copies} "
                f"tap copies; session and fleet under "
                f"set_sync_debug_mode('error'): no host read; the session "
                f"program's device ops at 1 step a fit dark {ops['dark']} "
                f"live {ops['live']}: the taps add {added} beside "
                f"{ops['tap_copies']} tap copies")

    def _tele_serve(self, table: dict) -> str:
        """(c) 15(b)'s engine cut to 64 requests, three times dark and
        three times with Telemetry(live=True) and a streamed trace; a live
        serve_batch under set_sync_debug_mode("error"), and the device
        operations of a dark and a live serve_batch."""
        import numpy as np
        torch = self.torch
        from repro_torch.comm import codecs
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.serve import ServeEngine
        from repro_torch.telemetry import MetricsRegistry, Telemetry
        from repro_torch.telemetry.live import LiveSink, installed
        data = self._mimic_data()
        Xte = data[2]
        n_te = int(Xte[0].shape[0])
        protos = self.serve_protos or {
            f"s{s}": self._serve_fit("compiled", s, E.MeteredTransport(
                serve_codec=codecs.QuantCodec(8)), data,
                rounds=ENGINE_FIT_ROUNDS) for s in range(8)}
        plan = protos["s0"]._compiled_ctx[1]
        stream = self._serve_stream(64, 8, 4, n_te)
        runs = []
        for lit in self.TELE_ORDER:
            tele = Telemetry(live=True) if lit else None
            trace = os.path.join(SMOKE_DIR, "telemetry_serve.jsonl")
            if lit:
                tele.stream_trace(trace)
            engine = ServeEngine(cache_capacity=4, max_batch=8,
                                 telemetry=tele, device="cuda")
            for sid, proto in protos.items():
                engine.add_session(sid, proto)
            self.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._run_engine(engine, stream, Xte, 32)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            stats = engine.batcher.stats()
            snap = self._launch_snapshot()
            self.read_counts(0, f"telemetry serve engine lit={lit}",
                             quantize_dequant_block_rows=stats["batches_run"]
                             * self._serve_quant(plan))
            outcomes = {rid: (np.asarray(o.preds).tolist(), o.bits,
                              o.releases)
                        for rid, o in engine.outcomes.items()}
            engine.close()
            runs.append((tele, outcomes, snap, secs, stats))
        _, dark, dsnap, _, _ = runs[0]
        for other_tele, other, osnap, _, _ in runs[1:]:
            self.require(other == dark, "a request differs between the "
                         "engine's runs with and without telemetry "
                         "(predictions, bits, releases)")
            self.require(osnap == dsnap, "serve engine: launches differ "
                         "with telemetry")
        # the last run with telemetry wrote the streamed trace
        tele, lit, _, _, stats = [r for r in runs if r[0] is not None][-1]
        reg = tele.registry
        names = {s.name for s in tele.tracer.spans}
        self.require({"flush", "flush_wave", "bucket_dispatch"} <= names
                     and tele.tracer.well_formed(),
                     f"serve spans {names}")
        delivered = len(lit)
        self.require(reg.total("live_serve_requests_total") == delivered
                     == reg.total("serve_requests_total") == 64,
                     f"live_serve_requests_total "
                     f"{reg.total('live_serve_requests_total')} != "
                     f"{delivered} delivered")
        self.require(tele.live.copies == stats["batches_run"],
                     f"{tele.live.copies} tap copies != "
                     f"{stats['batches_run']} buckets")
        self._tele_artifacts(tele, None, "serve")
        # a live serve_batch of 8 slots under sync debug mode
        proto = protos["s0"]
        _, plan, result = proto._compiled_ctx
        m = plan.num_agents
        slots = [{"Xs": [x[b * 400:b * 400 + 1024] for x in Xte],
                  "params": result.params, "alphas": result.alphas,
                  "valid": result.valid,
                  "rem_session": torch.full((), C._INT32_MAX,
                                            dtype=torch.int32,
                                            device=self.dev),
                  "rem_link": torch.full((m,), C._INT32_MAX,
                                         dtype=torch.int32, device=self.dev),
                  "deliver": torch.ones(m, dtype=torch.bool,
                                        device=self.dev)} for b in range(8)]
        key = proto._session.state.key
        draws = C._serve_draws_for(plan, [key] * 8, list(range(8)), 1024,
                                   self.dev, [None] * 8)
        self.reset_counts()
        dark_res = C.serve_batch(plan, slots, draws=draws)   # and warm-up
        torch.cuda.synchronize()
        self.read_counts(0, "dark serve_batch",
                         quantize_dequant_block_rows=self._serve_quant(plan))
        sink = LiveSink(MetricsRegistry())
        with installed(sink):
            self.reset_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = C.serve_batch(plan, slots, draws=draws, live=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.read_counts(0, "sync-checked live serve_batch",
                         quantize_dequant_block_rows=self._serve_quant(plan))
        self.require(all(torch.equal(a, b) for a, b in zip(res, dark_res)),
                     "the live serve_batch != the dark one")
        self.require(sink.registry.total("live_serve_requests_total") == 8
                     and sink.copies == 1, "the live serve_batch's taps")
        bops = {"dark": _device_op_counts(
            lambda: C.serve_batch(plan, slots, draws=draws))}
        sink = LiveSink(MetricsRegistry())
        with installed(sink):
            bops["live"] = _device_op_counts(
                lambda: C.serve_batch(plan, slots, draws=draws, live=True))
        bops["tap_copies"] = sink.copies
        badded = {k: bops["live"][k] - bops["dark"][k] for k in bops["dark"]}
        p50 = reg.quantile("span_seconds", 0.5, name="flush_wave")
        row, timing = self._tele_overhead(
            [r[3] for r in runs if r[0] is None],
            [r[3] for r in runs if r[0] is not None])
        table["serve_engine"] = dict(row, requests=64, flush_wave_p50_s=p50,
                                     tap_copies=tele.live.copies,
                                     serve_batch_device_ops=bops)
        return (f"(c) serve engine 64 requests, live telemetry = dark "
                f"(predictions, bits, releases, launches), spans flush/"
                f"flush_wave/bucket_dispatch, live_serve_requests_total = "
                f"{delivered}, {tele.live.copies} tap copies (one a "
                f"bucket), {timing}; a live "
                f"serve_batch of 8 under set_sync_debug_mode('error'): no "
                f"host read, = dark; its device ops dark {bops['dark']} "
                f"live {bops['live']}: the taps add {badded} beside "
                f"{bops['tap_copies']} tap copy")

    def _tele_profile(self, table: dict) -> str:
        """(d) the session CLI on blob3 with --profile-dir and --trace on
        the card: the profiler's trace holds the spans as ranges."""
        from repro_torch.launch import session as cli
        from repro_torch.telemetry import check as tcheck
        out = os.path.join(SMOKE_DIR, "telemetry_profile")
        shutil.rmtree(out, ignore_errors=True)
        trace = os.path.join(SMOKE_DIR, "telemetry_cli.jsonl")
        self.reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            run = cli.run(cli.parser().parse_args(
                ["--device", "cuda", "--profile-dir", out, "--trace",
                 trace]))
        hops = sum(e["kind"] == "ignorance"
                   for e in run.transport.log.entries)
        self.read_counts(hops, "telemetry profile CLI")
        with open(os.path.join(out, "session.pt.trace.json")) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        want = {"session", "round#0", "round#5", "hop", "serve"}
        self.require(want <= names, f"profiler ranges missing: "
                     f"{sorted(want - names)}")
        kernels = sum(e.get("cat") == "kernel" for e in events)
        self.require(kernels > 0, "the profiler saw no device kernel")
        errors = tcheck.validate_file(trace)
        self.require(not errors, f"{trace}: {errors[:3]}")
        table["profile"] = {"device_kernels": kernels, "hops": hops}
        return (f"(d) session CLI --profile-dir --trace on blob3: the "
                f"profiler's trace has {sorted(want)} as ranges and "
                f"{kernels} device kernels; the trace passes the checker")

    # ------------------------------------ the rest of the compiled backend
    def compiled_rest(self) -> str:
        """Phase 18: (a)-(d) of the module note; every part runs, then the
        phase fails if one did."""
        out, failed = [], []
        for part in (self._qmax_routes, self._async_compiled,
                     self._codec_sweep, self._control_sweep):
            t0 = time.perf_counter()
            try:
                out.append(part())
                print(f"phase 18 part ({time.perf_counter() - t0:.1f} s): "
                      f"{out[-1]}", flush=True)
            except Exception as e:  # the phase fails below, after the rest
                traceback.print_exc()
                failed.append(f"{part.__name__}: {type(e).__name__}: {e}")
        if failed:
            raise AssertionError("; ".join(failed))
        return "; ".join(out)

    def _qmax_routes(self) -> str:
        """(d) the device-qmax routes against their plain versions and
        lone launches at the float range, bit for bit, two runs identical,
        one device kernel a call; ``qmax_rows_table``."""
        torch = self.torch
        from repro_torch.kernels import quantize as q
        gen = torch.Generator(device=self.dev).manual_seed(18)
        floor = self.floor_ms
        if floor is None:
            floor = self.floor_ms = self._launch_floor()
        table = []
        # (JSON name, shape, ranges, route, plain, lone call, the TPU
        # kernel's line, the main path's shape: the sweep's hop and its
        # serve axis's blocks, which the JSON line reports)
        cases = (("quantize_dequant_rows_qmax", (3, 15000),
                  [127.0, 31.0, 7.0], q.quantize_dequant_rows,
                  q.quantize_dequant_rows_plain, q.quantize_dequant_tiles,
                  73, True),
                 ("quantize_dequant_block_rows_qmax", (3, 4500, 2),
                  [127.0, 31.0, 7.0], q.quantize_dequant_block_rows,
                  q.quantize_dequant_block_rows_plain,
                  q.quantize_dequant_block, 178, True),
                 ("quantize_dequant_block_rows_qmax", (8, 1024, 2),
                  [127.0, 100.0, 63.0, 31.0, 15.0, 7.0, 3.0, 1.0],
                  q.quantize_dequant_block_rows,
                  q.quantize_dequant_block_rows_plain,
                  q.quantize_dequant_block, 178, False))
        for name, shape, qm, route, plain_fn, lone_fn, line, main in cases:
            x = torch.randn(shape, generator=gen, device=self.dev) * 5
            u = torch.rand(shape, generator=gen, device=self.dev)
            qmax = torch.tensor(qm, device=self.dev)
            got, again = route(x, u, qmax), route(x, u, qmax)
            plain = plain_fn(x, u, qmax)
            torch.cuda.synchronize()
            for what, other in (("plain", plain), ("a second run", again)):
                self.require(all(torch.equal(g, o)
                                 for g, o in zip(got, other)),
                             f"{name} {list(shape)}: differs from {what}")
            for s, qs in enumerate(qm):
                self.require(all(torch.equal(g[s], o) for g, o in zip(
                    got, lone_fn(x[s], u[s], qs))),
                    f"{name} {list(shape)}: row {s} differs from its lone "
                    f"launch at qmax {qs}")

            def call(x=x, u=u, qmax=qmax, route=route):
                route(x, u, qmax)
            per_call, seen = _device_kernels_per_call(call)
            self.require(per_call == 1, f"{name} {list(shape)}: {per_call} "
                         f"device kernels a call {seen}")
            numel, tiles = x.numel(), got[2].numel()
            bound, by = _bound_ms(13 * numel + 4 * tiles + 4 * len(qm),
                                  8 * numel)
            row = {"route": name, "shape": list(shape), "qmax": qm,
                   "ms": _cuda_time_ms(call),
                   "device_ms": _kernel_device_ms(call, ""),
                   "plain_ms": _cuda_time_ms(
                       lambda x=x, u=u, qmax=qmax, f=plain_fn:
                       f(x, u, qmax)),
                   "bound_ms": bound, "bound_by": by,
                   "launch_floor_device_ms": floor,
                   "kernels_a_call": per_call,
                   "max_abs_err": float((got[0] - plain[0]).abs().max())}
            table.append(row)
            if not main:
                continue
            self.kernels[name] = {
                "source": "src/repro_torch/csrc/quantize.cu",
                "replaces": f"src/repro/kernels/quantize.py:{line}",
                **{k: row[k] for k in ("max_abs_err", "ms", "device_ms",
                                       "plain_ms", "bound_ms",
                                       "bound_by")},
                "library_ms": None}
        print(f"qmax_rows_table {self.card} " + json.dumps(table),
              flush=True)
        return ("(d) " + "; ".join(
            f"{r['route']} {r['shape']} = plain = lone launches bit for "
            f"bit, two runs identical, one device kernel a call: call "
            f"{r['ms']:.5f} ms, device {r['device_ms']:.5f} ms (plain "
            f"{r['plain_ms']:.5f}, bound {r['bound_ms']:.7f}, launch floor "
            f"{floor:.6f})" for r in table))

    def _async_channels(self, n: int, m: int) -> dict:
        """The reference's five async channels at MIMIC size: plain, int8,
        DP, and two budgets on the (int8, int4) ladder rescaled from
        ``payload_costs(n)``: one that ten rounds' releases at int8 never
        exhaust, one that ships three int8 releases and an int4 one, then
        runs dry (each round's alphas booked before its walk)."""
        from repro_torch.comm import (BudgetSpec, BudgetedTransport,
                                      GaussianMechanism)
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import engine as E
        ladder = (QuantCodec(bits=8), QuantCodec(bits=4))
        costs = BudgetSpec(ladder=ladder).payload_costs(n)
        setup, alphas = (m - 1) * 2 * n * 32, 32 * m
        roomy = setup + 10 * (alphas + costs[0]) + 100
        tight = setup + 3 * (alphas + costs[0]) + alphas + costs[1] + 100
        return {
            "plain": lambda: E.MeteredTransport(),
            "int8": lambda: E.MeteredTransport(codec=QuantCodec(bits=8)),
            "dp": lambda: E.MeteredTransport(
                privacy=GaussianMechanism(epsilon=2.0, clip=0.1)),
            "budget": lambda: BudgetedTransport(BudgetSpec(
                session_bits=roomy, ladder=ladder)),
            "budget-tight": lambda: BudgetedTransport(BudgetSpec(
                session_bits=tight, ladder=ladder))}

    def _async_compiled(self) -> str:
        """(a) MIMIC async, logistic(MIMIC_STEPS), the five channels:
        compiled = eager on the card; the program under sync debug
        mode."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        Xtr, ctr, Xte, cte = self._mimic_data()
        n, m, rounds = int(ctr.shape[0]), len(Xtr), ASYNC_ROUNDS
        n_te = int(cte.shape[0])
        cfg = E.SessionConfig(num_classes=2, max_rounds=rounds)
        out = []
        for name, make in self._async_channels(n, m).items():
            runs = {}
            for backend in ("eager", "compiled"):
                transport = make()
                learners = [LogisticRegression(steps=MIMIC_STEPS,
                                               device="cuda")
                            for _ in Xtr]
                self.reset_counts()
                proto, fitted, secs, _, _ = self._timed_fit(
                    backend, 0, learners, Xtr, ctr, cfg,
                    transport=transport, scheduler=E.AsyncStaleScheduler())
                served = proto.predict_distributed(Xte)
                torch.cuda.synchronize()
                ladder = (transport.budget.ladder
                          if hasattr(transport, "budget")
                          else (transport.codec,))
                plan = C.plan_for(learners, 2, max_rounds=rounds,
                                  codec=transport.codec,
                                  privacy=transport.privacy,
                                  budget=getattr(transport, "budget", None),
                                  scheduler=C.AsyncStalePlan())
                if backend == "eager":
                    self.read_counts(
                        0, f"async eager {name}",
                        ignorance_update_unnormalized=len(
                            fitted.components),
                        **self._coded_counts(
                            transport, [c for c in ladder if c is not None],
                            n, (n_te, 2)))
                else:
                    int_rungs = sum(isinstance(c, QuantCodec)
                                    for c in plan.ladder)
                    self.read_counts(
                        0, f"async compiled {name}",
                        ignorance_update_unnormalized=rounds * m,
                        quantize_dequant_tiles=(rounds * int_rungs
                                                if plan.has_channel else 0),
                        quantize_dequant_block=self._serve_quant(plan))
                runs[backend] = (proto, fitted, transport, served.cpu(),
                                 fitted.predict(Xte).cpu(),
                                 proto._session.state.w, secs)
            (ep, ef, et, eserve, efit, ew, esec), \
                (cp, cf, ct, cserve, cfit, cw, csec) = (runs["eager"],
                                                        runs["compiled"])
            self.require([(c.agent, c.round, c.alpha) for c in cf.components]
                         == [(c.agent, c.round, c.alpha)
                             for c in ef.components],
                         f"async {name}: components or alphas differ")
            self.require(cf.history == ef.history,
                         f"async {name}: histories differ")
            self.require(torch.equal(cw, ew), f"async {name}: w differs")
            self.require(ct.log.entries == et.log.entries,
                         f"async {name}: ledgers differ")
            self.require(torch.equal(cserve, eserve)
                         and torch.equal(cfit, efit),
                         f"async {name}: predictions differ")
            res = cp._compiled_result
            rungs = [int(r) for r in res.codec_idx.cpu()[res.sent.cpu()]]
            erungs = [e.get("rung", 0) for e in et.log.entries
                      if e["src"] == "barrier"]
            if et.has_channel:
                self.require(rungs == erungs, f"async {name}: release rungs "
                             f"{rungs} != eager {erungs}")
            if hasattr(et, "budget"):
                self.require((ct.skipped, ct.exhausted, ct.link_spent)
                             == (et.skipped, et.exhausted, et.link_spent),
                             f"async {name}: skips, exhaustion or spend "
                             f"differ")
                # the fit's own flag (the serve walk after it may run the
                # budget dry too)
                dry = bool(cp._compiled_result.exhausted)
                self.require(dry == (name == "budget-tight"),
                             f"async {name}: the fit ran dry: {dry}")
            if et.accountant is not None:
                self.require(ct.accountant.releases
                             == et.accountant.releases,
                             f"async {name}: DP releases differ")
            acc = float((cserve == cte.cpu()).float().mean())
            out.append(f"[{name}] rounds={len(cf.history)} "
                       f"components={len(cf.components)} rungs={rungs} "
                       f"bits={ct.total_bits} acc={acc:.4f} eager "
                       f"{esec:.2f} s compiled {csec:.2f} s")
        return (f"(a) mimic async logistic({MIMIC_STEPS}) {rounds} rounds, "
                f"compiled = eager on the card (components, alphas, w, "
                f"ledgers, rungs, skips, releases, predictions bit-equal); "
                + "; ".join(out) + "; " + self._async_no_host_read())

    def _async_no_host_read(self) -> str:
        """The async program (the tight budget with DP noise) under sync
        debug mode "error", after a warm-up."""
        torch = self.torch
        from repro_torch.comm.privacy import GaussianMechanism
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        Xtr, ctr, _, _ = self._mimic_data()
        budget = self._async_channels(int(ctr.shape[0]), len(Xtr))[
            "budget-tight"]().budget
        plan = C.plan_for([LogisticRegression(steps=MIMIC_STEPS,
                                              device="cuda")] * len(Xtr),
                          2, max_rounds=10, budget=budget,
                          privacy=GaussianMechanism(epsilon=2.0),
                          scheduler=C.AsyncStalePlan())
        shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
        fn = C.make_async_session_fn(plan, shapes)
        draws = C._draws_for(plan, E.key_data(0), int(ctr.shape[0]), shapes,
                             ctr.device, None, fleet=False)
        fn(draws, tuple(Xtr), ctr)            # warm-up
        torch.cuda.synchronize()
        self.reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn(draws, tuple(Xtr), ctr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.read_counts(0, "sync-checked async program",
                         ignorance_update_unnormalized=10 * len(Xtr),
                         quantize_dequant_tiles=10 * 2)
        return (f"the async program (tight budget + DP) under "
                f"set_sync_debug_mode('error'): no host read, "
                f"{int(res.executed.any(1).sum())} rounds ran")

    def _codec_sweep(self) -> str:
        """(b) ``quant_sweep_run`` at qmax [127, 31, 7], equal keys, with
        the serve axis: rows = per-config compiled and eager runs; one
        quantize launch a hop for 1 or 3 sessions."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec, quant_bits_per_element
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.kernels import quantize as q
        from repro_torch.learners.logistic import LogisticRegression
        Xtr, ctr, Xte, cte = self._mimic_data()
        n, m, rounds = int(ctr.shape[0]), len(Xtr), SWEEP_ROUNDS
        n_te, hops = int(cte.shape[0]), rounds * len(Xtr)
        qmaxes, bits_of = [127.0, 31.0, 7.0], {127.0: 8, 31.0: 6, 7.0: 4}

        def plan(bits):
            return C.plan_for([LogisticRegression(steps=MIMIC_STEPS,
                                                  device="cuda")] * m, 2,
                              max_rounds=rounds, codec=QuantCodec(bits=bits))
        sweeps, secs = {}, {}
        for qm in (qmaxes, [31.0]):
            self.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweeps[len(qm)] = C.quant_sweep_run(plan(8), [0] * len(qm), Xtr,
                                                ctr, qm, serve_Xs=Xte)
            torch.cuda.synchronize()
            secs[len(qm)] = time.perf_counter() - t0
            self.read_counts(0, f"codec sweep S={len(qm)}",
                             ignorance_update_batched=hops,
                             quantize_dequant_tiles=hops,
                             quantize_dequant_block_rows=m - 1)
            for route, counter in QMAX_ROUTES.items():
                self.launches[route] += getattr(q, counter).launches
        res, serve = sweeps[3]
        one, one_serve = sweeps[1]
        self.require(torch.equal(one.w[0], res.w[1])
                     and torch.equal(one_serve.preds[0], serve.preds[1]),
                     "the one-range sweep differs from row 1 of three")
        rows = []
        for s, qm in enumerate(qmaxes):
            p = plan(bits_of[qm])
            self.reset_counts()
            single = C.compiled_session(p, 0, Xtr, ctr)
            sv = C.serve_session(p, single, 0, Xte)
            self._compiled_counts(p, False, f"codec sweep's config {qm}",
                                  served=1)
            for field in single._fields:
                if field != "params":
                    self.require(torch.equal(getattr(res, field)[s],
                                             getattr(single, field)),
                                 f"sweep row {s} (qmax {qm}): {field} "
                                 f"differs from compiled_session")
            # the fits' params under vmap: their products may round apart
            # from a lone fit's (14(c)), whatever their predictions; held
            # to ROADMAP Queue 3's logistic tolerance
            pairs = [(x[s], y) for pa, pb in zip(res.params, single.params)
                     for x, y in zip(_leaves(pa), _leaves(pb))]
            dparams = max(float((x - y).abs().max()) for x, y in pairs)
            self.require(all(torch.allclose(x, y, rtol=1e-5, atol=1e-5)
                             for x, y in pairs),
                         f"sweep row {s} (qmax {qm}): the fits' params "
                         f"part from compiled_session's beyond atol 1e-5 + "
                         f"rtol 1e-5 (max {dparams:.3g})")
            for field in sv._fields:
                self.require(torch.equal(getattr(serve, field)[s],
                                         getattr(sv, field)),
                             f"sweep row {s} (qmax {qm}): serve {field} "
                             f"differs from serve_session")
            self.reset_counts()
            proto, fitted, _, _, _ = self._timed_fit(
                "eager", 0, [LogisticRegression(steps=MIMIC_STEPS,
                                                device="cuda")] * m,
                Xtr, ctr, E.SessionConfig(num_classes=2, max_rounds=rounds),
                transport=E.MeteredTransport(codec=p.codec))
            preds = proto.predict_distributed(Xte)
            self.read_counts(
                sum(e["kind"] == "ignorance"
                    for e in proto.transport.log.entries),
                f"codec sweep's eager config {qm}",
                **self._coded_counts(proto.transport, [p.codec], n,
                                     (n_te, 2)))
            self.require(torch.equal(proto._session.state.w, res.w[s])
                         and torch.equal(preds, serve.preds[s]),
                         f"sweep row {s} (qmax {qm}): differs from the "
                         f"eager run")
            bpe = quant_bits_per_element(qm)
            train_bits = int(res.sent[s].sum()) * (bpe * n + 32)
            serve_bits = (m - 1) * (bpe * n_te * 2 + 32)
            rows.append({"qmax": qm, "bits_per_element": bpe,
                         "max_abs_dparams": dparams,
                         "interchange_bits": train_bits,
                         "serve_bits": serve_bits,
                         "acc": float((serve.preds[s] == cte).float()
                                      .mean())})
        print(f"codec_sweep_rows {self.card} " + json.dumps(rows),
              flush=True)
        return (f"(b) quant_sweep_run mimic int8 plan at qmax {qmaxes}, "
                f"equal keys, serve axis on {n_te} rows: every row = "
                f"compiled_session + serve_session and = the eager run bit "
                f"for bit (w, w_trace, alphas, sends, rungs, predictions, "
                f"blocks; the fits' params within "
                f"{max(r['max_abs_dparams'] for r in rows):.3g}, held to "
                f"atol 1e-5 + rtol 1e-5); one "
                f"quantize launch a hop and one block launch a "
                f"non-head agent for 3 sessions as for 1 ({hops} and "
                f"{m - 1}); sweep of 3 {secs[3]:.2f} s, of 1 "
                f"{secs[1]:.2f} s; " + ", ".join(
                    f"qmax {r['qmax']:g}: {r['bits_per_element']} bits, "
                    f"acc {r['acc']:.4f}" for r in rows))

    def _control_sweep(self) -> str:
        """(c) ``control_sweep_run``: the reference's four (cut, beta)
        configs and four session caps (one None, one that runs dry before
        the last round), each row = the static compile, one build a sweep;
        ``live=True`` = dark, the taps' counters = the replayed ledgers."""
        torch = self.torch
        from repro_torch.comm import BudgetSpec, BudgetedTransport
        from repro_torch.comm.codecs import Fp16Codec, QuantCodec
        from repro_torch.control.adaptive import AdaptiveController
        from repro_torch.core import compiled as C
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        from repro_torch.telemetry import MetricsRegistry
        from repro_torch.telemetry.live import LiveSink, installed
        Xtr, ctr, _, _ = self._mimic_data()
        n, m, rounds = int(ctr.shape[0]), len(Xtr), CONTROL_ROUNDS
        hops = rounds * m

        def learners():
            return [LogisticRegression(steps=MIMIC_STEPS, device="cuda")] * m

        def rows_equal(sweep, s, single, what):
            for field in ("alphas", "accs", "executed", "valid", "w",
                          "w_trace", "sent", "codec_idx", "exhausted",
                          "order", "ctrl_ema"):
                self.require(torch.equal(getattr(sweep, field)[s],
                                         getattr(single, field)),
                             f"{what}: {field} differs from the static "
                             f"compile")
        ladder = (Fp16Codec(), QuantCodec(bits=4))
        configs = [((0.5,), 0.0), ((0.1,), 0.0), ((0.9,), 0.5),
                   ((0.3,), 0.9)]

        def ctrl_plan(cut, beta):
            return C.plan_for(learners(), 2, max_rounds=rounds,
                              controller=AdaptiveController(
                                  ladder=ladder, thresholds=cut, beta=beta))
        C.TRACE_COUNTS.clear()
        self.reset_counts()
        sweep = C.control_sweep_run(ctrl_plan(*configs[0]), [0] * 4, Xtr, ctr,
                                    cuts=[c for c, _ in configs],
                                    betas=[b for _, b in configs])
        torch.cuda.synchronize()
        self.require(C.TRACE_COUNTS == {"control_sweep": 1},
                     f"TRACE_COUNTS {C.TRACE_COUNTS}")
        self.read_counts(0, "controller sweep",
                         ignorance_update_batched=hops,
                         quantize_dequant_tiles=hops)
        rungs = []
        for s, (cut, beta) in enumerate(configs):
            self.reset_counts()
            p = ctrl_plan(cut, beta)
            single = C.compiled_session(p, 0, Xtr, ctr)
            self._compiled_counts(p, False, f"controller config {s}")
            rows_equal(sweep, s, single, f"controller config {cut}, {beta}")
            rungs.append(int((single.codec_idx == 1).sum()))
        blad = (QuantCodec(bits=8), QuantCodec(bits=4))
        hop8 = BudgetSpec(ladder=blad).hop_costs(n)[0]
        setup = (m - 1) * 2 * n * 32
        caps = [None, setup + (hops + 1) * hop8,
                setup + 13 * hop8 + 100, setup + 5 * hop8 + 100]
        C.TRACE_COUNTS.clear()
        self.reset_counts()
        base = C.plan_for(learners(), 2, max_rounds=rounds,
                          budget=BudgetSpec(session_bits=caps[1],
                                            ladder=blad))
        dark = C.control_sweep_run(base, [0] * 4, Xtr, ctr,
                                   session_bits=caps)
        torch.cuda.synchronize()
        self.require(C.TRACE_COUNTS == {"control_sweep": 1},
                     f"TRACE_COUNTS {C.TRACE_COUNTS}")
        self.read_counts(0, "cap sweep", ignorance_update_batched=hops,
                         quantize_dequant_tiles=2 * hops)
        ledger = {"bits": 0, "ignorance": 0, "skips": 0}
        ran = []
        for s, cap in enumerate(caps):
            self.reset_counts()
            transport = BudgetedTransport(BudgetSpec(session_bits=cap,
                                                     ladder=blad))
            proto = E.Protocol(E.SessionConfig(num_classes=2,
                                               max_rounds=rounds),
                               transport=transport, backend="compiled",
                               device="cuda")
            proto.fit(0, E.endpoints_for(learners(), Xtr), ctr)
            self._compiled_counts(proto._compiled_ctx[1], False,
                                  f"static cap {cap}")
            rows_equal(dark, s, proto._compiled_result, f"cap {cap}")
            ledger["bits"] += transport.total_bits
            ledger["ignorance"] += sum(e["kind"] == "ignorance"
                                       for e in transport.log.entries)
            ledger["skips"] += len(transport.skipped)
            ran.append(int(dark.executed[s].any(1).sum()))
        self.require(not bool(dark.exhausted[0]),
                     "the uncapped row ran dry")
        self.require(any(bool(dark.exhausted[s]) and ran[s] < rounds
                         for s in range(4)),
                     f"no cap ran dry before the last round: rounds {ran}")
        sink = LiveSink(MetricsRegistry())
        self.reset_counts()
        with installed(sink):
            live = C.control_sweep_run(base, [0] * 4, Xtr, ctr,
                                       session_bits=caps, live=True)
        torch.cuda.synchronize()
        self.read_counts(0, "live cap sweep", ignorance_update_batched=hops,
                         quantize_dequant_tiles=2 * hops)
        for field in ("alphas", "w", "sent", "codec_idx", "exhausted",
                      "executed"):
            self.require(torch.equal(getattr(live, field),
                                     getattr(dark, field)),
                         f"live cap sweep: {field} differs from dark")
        reg = sink.registry
        taps = {"bits": reg.total("live_wire_bits_total"),
                "ignorance": reg.value("live_messages_total",
                                       kind="ignorance"),
                "skips": reg.total("live_budget_skips_total")}
        self.require(taps == ledger, f"live taps {taps} != the replayed "
                     f"ledgers {ledger}")
        self.require(reg.total("live_rounds_total") == sum(ran)
                     and sink.copies == rounds,
                     f"live rounds {reg.total('live_rounds_total')} != "
                     f"{sum(ran)} or copies {sink.copies} != {rounds}")
        return (f"(c) control_sweep_run, mimic logistic({MIMIC_STEPS}): "
                f"four (cut, beta) configs on (fp16, int4), int4 hops "
                f"{rungs}, and caps {caps} on (int8, int4), rounds {ran}, "
                f"exhausted {dark.exhausted.tolist()}: each row = the "
                f"static compile bit for bit, TRACE_COUNTS "
                f"{{'control_sweep': 1}} a sweep, one launch a hop; live = "
                f"dark, taps {taps} = the replayed ledgers, "
                f"{sink.copies} tap copies")

    # ------------------------------------------------------- the model zoo
    def zoo(self) -> str:
        """19. The rest of the model zoo at full width (ZOO_SERVE)."""
        table = {}
        out = [self._zoo_serve(arch, table) for arch in ZOO_SERVE]
        out.append(self._zoo_train(table))
        print("zoo_table " + json.dumps({"card": self.card, "rows": table}),
              flush=True)
        out += [self._zoo_moe(), self._zoo_ssm(), self._zoo_card_vs_cpu(),
                self._zoo_ascii()]
        return "; ".join(out)

    def _zoo_serve(self, arch: str, table: dict) -> str:
        """(a) One arch through the serve CLI's ``run``: einsum and flash
        paths, bf16 and int8 caches; then flash against einsum on the
        float32 copies (:meth:`_zoo_flash_vs_einsum`)."""
        torch = self.torch
        from repro_torch.launch import serve as cli
        from repro_torch.models import api
        layers, batch, prompt, gen = ZOO_SERVE[arch]
        cfg = _zoo_cfg(arch, layers)
        flashable = cfg.attention == "gqa"

        def args(g, extra):
            return cli.parser().parse_args(
                ["--arch", arch, "--no-reduced", "--batch", str(batch),
                 "--prompt_len", str(prompt), "--gen", str(g), "--device",
                 "cuda", "--seed", "0", *extra])

        paths = [("einsum", [])]
        if flashable:
            paths += [("einsum_int8", ["--kv_quant"]),
                      ("flash", ["--use_flash"]),
                      ("flash_int8", ["--use_flash", "--kv_quant"])]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        params = api.init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(0))
        n_params = api.count_params(params)
        cli.run(args(2, []), params, cfg)    # warm-up (libraries), uncounted
        n_pre, n_dec = _zoo_attention(cfg)
        rows, kept = {}, None
        for name, extra in paths:
            flash = "--use_flash" in extra
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            run = cli.run(args(gen, extra), params, cfg)
            launches = {"flash_attention": n_pre if flash else 0,
                        "flash_decode": n_dec * (gen - 1) if flash else 0}
            self.read_counts(0, f"zoo serve {arch} {name}", **launches)
            toks = run.tokens
            self.require(tuple(toks.shape) == (batch, gen)
                         and int(toks.min()) >= 0
                         and int(toks.max()) < cfg.vocab_size,
                         f"zoo serve {arch} {name}: tokens "
                         f"{tuple(toks.shape)} out of range")
            rows[name] = {
                "prefill_ms": run.prefill_s * 1e3,
                "decode_ms_a_step": run.decode_s * 1e3 / (gen - 1),
                "tokens_s": (gen - 1) * batch / run.decode_s,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                **launches}
            if name == ("flash" if flashable else "einsum"):
                kept = (run.prompt, run.frontend, run.tokens)
            del run
        del params
        table[arch] = {"layers": cfg.num_layers, "params": n_params,
                       "batch": batch, "prompt": prompt, "gen": gen,
                       "paths": rows}
        print(f"zoo_serve {arch} " + json.dumps(rows), flush=True)
        line = (f"(a) {arch} ({cfg.num_layers} layers, {n_params} params, "
                f"bf16) batch {batch} prompt {prompt} gen {gen}: "
                + ", ".join(f"[{k}] {v['prefill_ms']:.1f} ms prefill, "
                            f"{v['decode_ms_a_step']:.2f} ms/step"
                            for k, v in rows.items()))
        if flashable:
            worst = self._zoo_flash_vs_einsum(cfg, *kept)
            table[arch]["flash_vs_einsum"] = worst
            line += "; float32 copies, worst " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items())
        return line

    def _zoo_flash_vs_einsum(self, cfg, prompt, frontend, tokens) -> dict:
        """The flash and the einsum paths, teacher-forced on a run's prompt,
        frontend inputs and continuation, with the bf16 weights and their
        float32 copies, each with the bf16 and the int8 cache: the float32
        flash path within 1e-4 max|logits| of the float32 einsum path (1e-3
        with the int8 cache, both paths decoding from the einsum path's
        quantized prefill cache: an int8 value at a rounding boundary
        follows ulps of K) at the prefill and every step, its greedy
        choice the same at every row but a near-tie (top-2 gap within
        twice the row's difference), and the bf16 flash path no further
        from it than 1.25 x the bf16 einsum path, on the mean over the
        prefill and the steps.  Cut to 2 layers (jamba:
        its one unit; whisper: all of its 4 + 4).  The bf16 weights are
        cast up in place, leaf by leaf: jamba's unit holds 26 GB in bf16
        and 52 GB in float32."""
        torch = self.torch
        from repro_torch.models import api
        cut = (cfg if cfg.layer_pattern or cfg.cross_attention
               else cfg.with_overrides(num_layers=min(cfg.num_layers, 2)))
        cut = cut.with_overrides(dtype="bfloat16")
        params = api.init_params(
            cut, torch.Generator(device=self.dev).manual_seed(0))
        b, s = prompt.shape
        off = cut.num_frontend_tokens if "patch_emb" in frontend else 0
        s_cache = off + s + tokens.shape[1]

        def path(c, quant, start=None):
            """Prefill and every teacher-forced step's logits, and the
            int8 prefill cache the steps started from (``start``: that of
            another path, copied)."""
            with torch.no_grad():
                lg, cache, _ = api.forward(params, {"tokens": prompt,
                                                    **frontend}, c)
                out = [lg.float()]
                cache = api.pad_prefill_cache(cache, c, s_cache)
                if quant:
                    cache = api.quantize_cache(cache, c) if start is None \
                        else start
                    start = _clone_cache(cache)
                for i in range(tokens.shape[1] - 1):
                    lg, cache = api.decode_step(params, cache,
                                                tokens[:, i:i + 1],
                                                off + s + i, c)
                    out.append(lg[:, -1].float())
            return out, start

        out = {}
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32":
                _upcast_in_place(params)
            for quant in (False, True):
                start = None     # both paths decode from einsum's int8 cache
                for flash in (False, True):
                    c = cut.with_overrides(dtype=dtype, use_flash=flash)
                    out[(flash, dtype, quant)], start = path(c, quant, start)
        del params, start
        torch.cuda.empty_cache()

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        worst = {"flash_f32": 0.0, "flash_f32_int8": 0.0, "near_ties": 0}
        for quant in (False, True):
            ref = out[(False, "float32", quant)]
            bound, tag = (1e-3, "_int8") if quant else (1e-4, "")
            bf16 = {"flash": [], "einsum": []}
            for j, want in enumerate(ref):
                where = f"{cfg.name} quant={quant} step {j}"
                e32 = rel(out[(True, "float32", quant)][j], want)
                for flash, name in ((True, "flash"), (False, "einsum")):
                    bf16[name].append(rel(out[(flash, "bfloat16", quant)][j],
                                          want))
                self.require(math.isfinite(e32) and all(
                    math.isfinite(v[-1]) for v in bf16.values()),
                    f"{where}: non-finite logits")
                self.require(e32 <= bound, f"{where}: float32 flash path "
                             f"{e32} > {bound} max|logits| from einsum")
                got = out[(True, "float32", quant)][j]
                last = (want[:, -1], got[:, -1]) if j == 0 else (want, got)
                top2 = last[0].topk(2, dim=-1).values
                diff = (last[1] - last[0]).abs().amax(-1)
                parted = last[1].argmax(-1) != last[0].argmax(-1)
                near = (top2[:, 0] - top2[:, 1]) <= 2 * diff
                self.require(not bool((parted & ~near).any()),
                             f"{where}: float32 greedy tokens part off a "
                             f"near-tie")
                worst["near_ties"] += int(parted.sum())
                worst["flash_f32" + tag] = max(worst["flash_f32" + tag], e32)
            # the bf16 paths' distance from float32, the mean over the
            # prefill and the steps: an MoE's bf16 roundings flip experts
            # of near-tied tokens, a jump in one step's distance either way
            mean = {k: statistics.fmean(v) for k, v in bf16.items()}
            print(f"zoo_bf16 {cfg.name} quant={quant} " + json.dumps(bf16),
                  flush=True)
            self.require(mean["flash"] <= 1.25 * mean["einsum"],
                         f"{cfg.name} quant={quant}: the bf16 flash path's "
                         f"mean distance {mean['flash']} from float32 > "
                         f"1.25 x the bf16 einsum path's {mean['einsum']}")
            for k, v in mean.items():
                worst[f"{k}_bf16{tag}_mean"] = v
        return worst

    def _zoo_train(self, table: dict) -> str:
        """(e) Training through the train CLI at full width, and the kernel
        loss against the plain loss on the same logits."""
        torch = self.torch
        from repro_torch.kernels import weighted_ce as wce
        from repro_torch.launch import train as cli
        from repro_torch.models import api
        out = []
        for arch in ZOO_TRAIN:
            self.reset_counts()
            run = cli.run(cli.parser().parse_args(
                ["--arch", arch, "--steps", str(ZOO_TRAIN_STEPS), "--batch",
                 "4", "--seq", "256", "--device", "cuda", "--seed", "0"]))
            self.read_counts(0, f"zoo train {arch}",
                             weighted_ce_fwd=ZOO_TRAIN_STEPS,
                             weighted_ce_bwd=ZOO_TRAIN_STEPS)
            cfg = run.cfg
            losses = [h["loss"] for h in run.history]
            aux = [h["aux_loss"] for h in run.history]
            self.require(len(losses) == ZOO_TRAIN_STEPS
                         and all(math.isfinite(x) for x in losses + aux),
                         f"zoo train {arch}: losses {losses}, aux {aux}")
            self.require((aux[0] > 0) == cfg.is_moe,
                         f"zoo train {arch}: aux {aux}")
            batch = self._train_batch(cfg, 11)
            with torch.no_grad():
                logits, _ = api.forward_train(run.params, batch, cfg)
                lk = float(api.weighted_next_token_loss(logits, batch, cfg))
                rows, lab, w = api.next_token_rows(logits, batch, cfg)
                lp = float(wce.weighted_ce_fwd_plain(rows, lab, w)[0].sum()
                           / w.sum().clamp(min=1e-9))
            self.require(abs(lk - lp) <= 1e-5 * abs(lp),
                         f"zoo train {arch}: kernel loss {lk} != plain {lp}")
            step_ms = statistics.median(run.step_s[1:]) * 1e3
            table.setdefault(arch, {})["train"] = {
                "steps": ZOO_TRAIN_STEPS, "batch": 4, "seq": 256,
                "step_ms": step_ms, "tokens_s": 4 * 256 / step_ms * 1e3,
                "peak_gib": run.peak_bytes / 2 ** 30,
                "weighted_ce_fwd": ZOO_TRAIN_STEPS,
                "weighted_ce_bwd": ZOO_TRAIN_STEPS}
            out.append(f"{arch} ({api.count_params(run.params)} params) "
                       f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, aux "
                       f"{aux[-1]:.4f}, step {step_ms:.1f} ms, kernel loss "
                       f"{lk:.6f} = plain {lp:.6f}")
            del run, logits, rows
            torch.cuda.empty_cache()
        return (f"(e) train, batch 4 seq 256, {ZOO_TRAIN_STEPS} steps: "
                + "; ".join(out))

    def _zoo_moe(self) -> str:
        """(b) One full-width MoE layer of each MoE arch in float32 at 512
        tokens: grouped = dense within 1e-5 max|y|, two grouped runs the
        same bits, the router's indices on the card = the CPU's (a row may
        part only where two of its first k + 1 probabilities lie within
        1e-6)."""
        torch = self.torch
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import moe
        out = []
        for arch in ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b"):
            cfg = ARCHS[arch]
            gen = torch.Generator(device=self.dev).manual_seed(5)
            p = moe.moe_init(gen, cfg, torch.float32, device=self.dev)
            x = torch.randn(1, 512, cfg.d_model, generator=gen,
                            device=self.dev)
            with torch.no_grad():
                dense, aux_d = moe.moe_apply(p, x, cfg, "dense")
                gmm, aux_g = moe.moe_apply(p, x, cfg, "gmm")
                again, _ = moe.moe_apply(p, x, cfg, "gmm")
                dense_ms = _cuda_time_ms(
                    lambda: moe.moe_apply(p, x, cfg, "dense"), 5, 1)
                gmm_ms = _cuda_time_ms(
                    lambda: moe.moe_apply(p, x, cfg, "gmm"), 5, 1)
                _, idx, _ = moe.router_topk(p, x[0], cfg)
                router = {"router": p["router"].cpu()}
                _, cidx, _ = moe.router_topk(router, x[0].cpu(), cfg)
                full = torch.softmax(x[0].cpu() @ router["router"], -1)
            err = float((gmm - dense).abs().max() / dense.abs().max())
            self.require(err <= 1e-5, f"{arch}: gmm {err} from dense")
            self.require(torch.equal(gmm, again) and torch.equal(aux_d, aux_g),
                         f"{arch}: two grouped runs differ")
            top = full.sort(-1, descending=True).values[:, :cfg.top_k + 1]
            near = (top[:, :-1] - top[:, 1:]).min(-1).values <= 1e-6
            parted = (idx.cpu() != cidx).any(-1)
            self.require(not bool((parted & ~near).any()),
                         f"{arch}: router indices part off near-ties")
            out.append(f"{arch} (E {cfg.num_experts}, k {cfg.top_k}, d "
                       f"{cfg.d_model}, f {cfg.moe_d_ff}): gmm - dense "
                       f"{err:.3g} max|y|, dense {dense_ms:.2f} ms, gmm "
                       f"{gmm_ms:.2f} ms, router rows parted card/CPU "
                       f"{int(parted.sum())} (near-ties)")
            del p, dense, gmm, again
            torch.cuda.empty_cache()
        return "(b) one MoE layer, float32, 512 tokens: " + "; ".join(out)

    def _zoo_ssm(self) -> str:
        """(c) mamba2-130m in float32, full width, chunk 128: a prefill of
        384 then 128 decode steps give every step the logits of one
        prefill of 512 at that position, within 1e-4 max|logits|."""
        torch = self.torch
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import api
        cfg = ARCHS["mamba2-130m"].with_overrides(dtype="float32")
        gen = torch.Generator(device=self.dev).manual_seed(6)
        params = api.init_params(cfg, gen)
        tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                               device=self.dev)
        worst = 0.0
        with torch.no_grad():
            full, _, _ = api.forward(params, {"tokens": tokens}, cfg)
            _, caches, _ = api.forward(params, {"tokens": tokens[:, :384]},
                                       cfg)
            caches = api.pad_prefill_cache(caches, cfg, 512)
            for i in range(384, 512):
                lg, caches = api.decode_step(params, caches,
                                             tokens[:, i:i + 1], i, cfg)
                worst = max(worst, float((lg[:, 0] - full[:, i]).abs().max()
                                         / full[:, i].abs().max()))
        self.require(worst <= 1e-4, f"mamba2 state handoff: {worst} of "
                     f"max|logits| > 1e-4")
        return (f"(c) mamba2-130m float32, chunk {cfg.ssm_chunk}: prefill "
                f"384 + 128 steps = prefill 512 within {worst:.3g} "
                f"max|logits| (<= 1e-4)")

    def _zoo_card_vs_cpu(self) -> str:
        """(d) The card's float32 einsum path against the CPU's on the same
        weights and inputs: the prefill's logits and 4 steps fed the CPU's
        greedy tokens within 1e-4 max|logits|, the greedy choices equal
        but at near-ties."""
        torch = self.torch
        from repro_torch.data.pipeline import frontend_inputs
        from repro_torch.models import api
        out = []
        for arch, cut in ZOO_CPU.items():
            cfg = _zoo_cfg(arch, cut).with_overrides(dtype="float32")
            gen = torch.Generator().manual_seed(7)
            params = api.init_params(cfg, gen)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                             generator=gen),
                     **frontend_inputs(cfg, 2, gen)}
            off = cfg.num_frontend_tokens if "patch_emb" in batch else 0
            runs = {}
            for name, dev in (("cpu", "cpu"), ("card", self.dev)):
                p = _tree_to(params, dev)
                b = {k: v.to(dev) for k, v in batch.items()}
                fed = runs["cpu"][1] if runs else None   # the CPU's tokens
                toks, t0 = [], time.perf_counter()
                with torch.no_grad():
                    lg, cache, _ = api.forward(p, b, cfg)
                    logits = [lg.float().cpu()]
                    cache = api.pad_prefill_cache(cache, cfg, off + 64 + 4)
                    for i in range(4):
                        tok = (fed[i] if fed else torch.argmax(
                            logits[-1][:, -1], -1).to(torch.int32)[:, None])
                        toks.append(tok)
                        lg, cache = api.decode_step(p, cache, tok.to(dev),
                                                    off + 64 + i, cfg)
                        logits.append(lg.float().cpu())
                runs[name] = (logits, toks, time.perf_counter() - t0)
            worst, parted = 0.0, 0
            for g, w in zip(runs["card"][0], runs["cpu"][0]):
                diff = (g - w).abs()
                worst = max(worst, float(diff.max() / w.abs().max()))
                gap = self._logits_gap(g[:, -1], w[:, -1],
                                       2 * float(diff[:, -1].max()))
                self.require(not gap["parted_off_near_ties"],
                             f"{arch}: card greedy tokens part off a "
                             f"near-tie: {gap}")
                parted += gap["parted"]
            self.require(worst <= 1e-4, f"{arch}: card vs CPU {worst} of "
                         f"max|logits| > 1e-4")
            out.append(f"{arch} ({cfg.num_layers} layers, d {cfg.d_model}) "
                       f"{worst:.3g}, parted {parted}, cpu "
                       f"{runs['cpu'][2]:.1f} s")
            del params, runs
        return ("(d) card = CPU, float32 einsum, prefill + 4 steps, worst "
                "max|dlogits| / max|logits| (<= 1e-4): " + "; ".join(out))

    def _zoo_ascii(self) -> str:
        """(e) ASCII: a NeuralBackbone agent over each ZOO_TRAIN arch's
        width cut to 2 layers (ZOO_BACKBONE_STEPS steps) beside three
        trees on the blob, as 12(d): ignorance launches = hops; one fit
        on the card and on the CPU from the same draws within 5e-4
        max|logit|."""
        torch = self.torch
        from repro_torch.comm.draws import ChannelDraws
        from repro_torch.configs.registry import ARCHS
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import blob_fig3
        from repro_torch.learners.neural import NeuralBackbone
        from repro_torch.learners.tree import DecisionTree
        ds = blob_fig3(torch.Generator().manual_seed(0), n=1000,
                       device="cuda")
        Xtr, ctr, Xte, cte = self._split(ds)
        out = []
        for arch in ZOO_TRAIN:
            cfg = ARCHS[arch].with_overrides(num_layers=2)
            learners = [NeuralBackbone(cfg=cfg, steps=ZOO_BACKBONE_STEPS,
                                       device="cuda")] + [
                DecisionTree(depth=4, device="cuda") for _ in range(3)]
            proto = E.Protocol(E.SessionConfig(num_classes=10,
                                               max_rounds=2),
                               transport=E.MeteredTransport(), device="cuda")
            self.reset_counts()
            t0 = time.perf_counter()
            session = proto.start(0, E.endpoints_for(learners, Xtr), ctr)
            session.run()
            preds = session.fitted().predict(Xte)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            st = session.state
            self.read_counts(len(st.components), f"zoo ascii {arch}")
            self.require(all(math.isfinite(c.alpha) for c in st.components),
                         f"zoo ascii {arch}: non-finite alpha")
            acc = float((preds == cte).float().mean())
            draws = ChannelDraws().fit(E.key_data(0), 0, 0)
            n = ctr.shape[0]
            logits, fit_s = {}, {}
            for name, dev in (("card", str(self.dev)), ("cpu", "cpu")):
                nb = NeuralBackbone(cfg=cfg, steps=ZOO_BACKBONE_STEPS,
                                    device=dev)
                X = Xtr[0].to(dev)
                t1 = time.perf_counter()
                params = nb.fit(draws, X, ctr.to(dev),
                                torch.full((n,), 1.0 / n, device=dev), 10)
                logits[name] = nb.core(10).logits(params, X).detach().cpu()
                fit_s[name] = time.perf_counter() - t1
            scale = float(logits["cpu"].abs().max())
            tol = 5e-4 * scale
            gap = self._logits_gap(logits["card"], logits["cpu"], tol)
            self.require(gap["max_err"] <= tol
                         and not gap["parted_off_near_ties"],
                         f"zoo ascii {arch}: card vs CPU {gap} beyond "
                         f"{tol:.3g}")
            out.append(f"{arch} width, 2 layers: components "
                       f"{len(st.components)}, acc {acc:.4f}, session "
                       f"{secs:.2f} s; fit card {fit_s['card']:.2f} s, cpu "
                       f"{fit_s['cpu']:.2f} s, max|logit err| "
                       f"{gap['max_err'] / scale:.3g} of max|logit| "
                       f"(<= 5e-4)")
        return (f"(e) ASCII, a NeuralBackbone ({ZOO_BACKBONE_STEPS} steps) "
                f"beside 3 trees, blob n_train=700, 2 rounds: "
                + "; ".join(out))

    # ------------------------------------------------------- multi-device
    def distributed(self) -> str:
        """20. The multi-device layer over NCCL at world size 1: a
        one-rank group on the card, destroyed at the end."""
        torch = self.torch
        import torch.distributed as dist
        self.require(not dist.is_initialized(),
                     "a process group is already initialised")
        t0 = time.perf_counter()
        torch.cuda.set_device(0)     # the rank's device, before the mesh
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            self.require(dist.get_backend() == "nccl",
                         f"backend {dist.get_backend()}, not nccl")
            table = {"card": self.card, "nccl": ".".join(
                map(str, torch.cuda.nccl.version())),
                "init_s": time.perf_counter() - t0}
            out = []
            for key, check in (("a", self._dist_normalizer),
                               ("b", self._dist_mimic),
                               ("c", self._dist_fleet), ("d", self._dist_ep),
                               ("e", self._dist_trainer)):
                before = dict(self.launches)
                out.append(check(table))
                table[key]["launches"] = {
                    k: n - before[k] for k, n in self.launches.items()
                    if n != before[k]}
        finally:
            dist.destroy_process_group()
        print("dist_table " + json.dumps(table), flush=True)
        return (f"nccl {table['nccl']}, world 1: " + "; ".join(out))

    def _dist_normalizer(self, table: dict) -> str:
        """(a) ``ops.ignorance_update(group=)`` and the ring on a (1, 1)
        mesh = ``ops.ignorance_update``'s bits, one unnormalized launch
        (one device kernel) and one all-reduce a hop."""
        torch = self.torch
        from repro_torch.core.collectives import make_ring_interchange
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        from repro_torch.sharding.context import make_mesh
        t0 = time.perf_counter()
        mesh = make_mesh((1, 1), ("agent", "data"), "cuda")
        group, ring = mesh.group("data"), make_ring_interchange(mesh)
        rows = []
        for n in (15000, 42000):
            gen = torch.Generator(device=self.dev).manual_seed(n)
            w = torch.rand(n, generator=gen, device=self.dev) + 0.1
            w = w / w.sum()
            r = (torch.rand(n, generator=gen, device=self.dev) > 0.4).float()
            a = torch.tensor(0.75, device=self.dev)
            self.reset_counts()
            ig.ignorance_update_group.all_reduces = 0
            grouped = ops.ignorance_update(w, r, a, group=group)
            ringed = ring(w[None], r[None], a[None])
            one = ops.ignorance_update(w, r, a)
            torch.cuda.synchronize()
            self.require(ig.ignorance_update_group.all_reduces == 2,
                         f"n={n}: {ig.ignorance_update_group.all_reduces} "
                         f"all-reduces for two hops")
            self.read_counts(1, f"dist normalizer n={n}",
                             ignorance_update_unnormalized=2)
            err = float((grouped - one).abs().max())
            self.require(torch.equal(grouped, one)
                         and torch.equal(ringed[0], one),
                         f"n={n}: the group normalizer parts from the "
                         f"one-launch kernel by {err}")
            kernels, kinds = _device_kernels_per_call(
                lambda: ig.ignorance_update_unnormalized(w, r, a))
            self.require(kernels == 1, f"n={n}: the unnormalized mode is "
                                       f"{kinds} a call")
            rows.append({"n": n, "max_abs_err": err, "device_kernels":
                         kernels, "all_reduces": 2})
        table["a"] = {"rows": rows, "s": time.perf_counter() - t0}
        return ("(a) group normalizer and (1, 1) ring = the one-launch "
                "kernel bit for bit at n = 15000, 42000; one unnormalized "
                "launch (1 device kernel) and one all-reduce a hop")

    def _dist_mimic(self, table: dict) -> str:
        """(b) Phase 4's MIMIC session through MeshRingTransport with a
        mesh = without one, bit for bit."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.learners.tree import DecisionTree
        from repro_torch.sharding.context import make_mesh
        t0 = time.perf_counter()
        mesh = make_mesh((1, 1), ("agent", "data"), "cuda")
        Xtr, ctr, Xte, _ = self._mimic_data()
        runs = []
        for m in (mesh, None):
            proto = E.Protocol(E.SessionConfig(num_classes=2, max_rounds=10),
                               transport=E.MeshRingTransport(mesh=m),
                               device="cuda")
            eps = E.endpoints_for([DecisionTree(depth=4, num_thresholds=16,
                                                device="cuda")
                                   for _ in Xtr], Xtr)
            self.reset_counts()
            session = proto.start(0, eps, ctr)
            session.run()
            preds = session.fitted().predict(Xte)
            torch.cuda.synchronize()
            self.read_counts(len(session.state.components),
                             f"dist mimic mesh={m is not None}")
            runs.append((session.state, preds))
        (sm, pm), (s0, p0) = runs
        self.require(
            [(c.agent, c.round, c.alpha) for c in sm.components]
            == [(c.agent, c.round, c.alpha) for c in s0.components]
            and (sm.round, sm.stopped) == (s0.round, s0.stopped)
            and torch.equal(sm.w, s0.w) and torch.equal(pm, p0)
            and sm.history == s0.history,
            "the MIMIC session with a mesh parts from the one without")
        table["b"] = {"components": len(sm.components), "round": sm.round,
                      "max_abs_err": 0.0, "s": time.perf_counter() - t0}
        return (f"(b) MIMIC trees, MeshRingTransport(mesh=) = without: "
                f"{len(sm.components)} components, stop round {sm.round}, "
                f"w and predictions bit for bit")

    def _dist_fleet(self, table: dict) -> str:
        """(c) ``fleet_run(shard_axis="data")`` on 8 MIMIC int8 sessions,
        2 rounds = ``fleet_run``'s bits."""
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import compiled as C
        from repro_torch.learners.logistic import LogisticRegression
        t0 = time.perf_counter()
        Xtr, ctr, _, _ = self._mimic_data()
        plan = C.plan_for([LogisticRegression(steps=MIMIC_STEPS,
                                              device="cuda")] * 2, 2,
                          max_rounds=2, codec=QuantCodec(8))
        keys = list(range(8))
        res = {}
        for axis in (None, "data"):
            self.reset_counts()
            res[axis] = C.fleet_run(plan, keys, Xtr, ctr, shard_axis=axis)
            torch.cuda.synchronize()
            self._compiled_counts(plan, True, f"dist fleet {axis}")

        def leaves(x):
            if isinstance(x, dict):
                return [y for v in x.values() for y in leaves(v)]
            if isinstance(x, (list, tuple)):
                return [y for v in x for y in leaves(v)]
            return [x]
        pairs = list(zip(leaves(tuple(res["data"])), leaves(tuple(res[None]))))
        self.require(len(pairs) > 10 and all(torch.equal(a, b)
                                             for a, b in pairs),
                     "the sharded fleet parts from the unsharded one")
        table["c"] = {"sessions": 8, "leaves": len(pairs),
                      "max_abs_err": 0.0, "s": time.perf_counter() - t0}
        return (f"(c) sharded fleet of 8 MIMIC int8 sessions, 2 rounds = "
                f"fleet_run, {len(pairs)} leaves bit for bit")

    def _dist_ep(self, table: dict) -> str:
        """(d) One MoE layer of granite-moe and of qwen3-moe, batch 4 x
        512 tokens: ep_a2a at D = 1 against the grouped path, float32
        within 1e-5 of max|y| and no token dropped; bf16 within 1.25 x the
        grouped path's distance from float32 (19(a)'s bf16 rule)."""
        torch = self.torch
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import moe
        from repro_torch.sharding import ep
        from repro_torch.sharding.context import make_mesh, mesh_context
        t0 = time.perf_counter()
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        rows, out = [], []
        for arch in ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b"):
            cfg = ARCHS[arch]
            gen = torch.Generator(device=self.dev).manual_seed(20)
            p = moe.moe_init(gen, cfg, torch.float32, device=self.dev)
            x = torch.randn(4, 512, cfg.d_model, generator=gen,
                            device=self.dev)
            with torch.no_grad():
                _, idx, _ = moe.router_topk(p, x.reshape(-1, cfg.d_model),
                                            cfg)
                cap = ep.capacity(4 * 512, cfg, 1)
                _, keep, _ = ep.dispatch(idx.reshape(-1) // cfg.num_experts,
                                         1, cap)
                self.require(bool(keep.all()), f"{arch}: tokens dropped at "
                                               f"D = 1")
                gmm, aux_g = moe.moe_apply(p, x, cfg, "gmm")
                with mesh_context(mesh):
                    t1 = time.perf_counter()
                    epy, aux_e = moe.moe_apply(p, x, cfg, "ep_a2a")
                    torch.cuda.synchronize()
                    ep_s = time.perf_counter() - t1
                scale = float(gmm.abs().max())
                err = float((epy - gmm).abs().max()) / scale
                self.require(err <= 1e-5 and torch.equal(aux_e, aux_g),
                             f"{arch}: ep_a2a {err} of max|y| from grouped")
                pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
                xb = x.to(torch.bfloat16)
                gb, _ = moe.moe_apply(pb, xb, cfg, "gmm")
                with mesh_context(mesh):
                    eb, _ = moe.moe_apply(pb, xb, cfg, "ep_a2a")
                d_g = float((gb.float() - gmm).abs().max()) / scale
                d_e = float((eb.float() - gmm).abs().max()) / scale
                self.require(d_e <= 1.25 * d_g,
                             f"{arch}: bf16 ep_a2a {d_e} from float32 "
                             f"against grouped's {d_g}")
            rows.append({"arch": arch, "cap": cap, "f32_err": err,
                         "bf16_ep": d_e, "bf16_gmm": d_g, "ep_s": ep_s})
            out.append(f"{arch} f32 {err:.3g}, bf16 {d_e:.3g} vs grouped "
                       f"{d_g:.3g} of max|y|")
            del p, pb, gmm, epy, gb, eb
            torch.cuda.empty_cache()
        table["d"] = {"rows": rows, "s": time.perf_counter() - t0}
        return "(d) ep_a2a (D = 1, none dropped) - grouped: " + "; ".join(out)

    def _dist_trainer(self, table: dict) -> str:
        """(e) ``Trainer(mesh=)`` on qwen3-0.6b at full width, batch 8, seq
        256, 2 steps = the mesh-less Trainer's loss and parameters bit for
        bit; under ``torch.use_deterministic_algorithms`` (the embedding's
        backward accumulates by index, which is not deterministic
        otherwise), and the mesh-less run twice to show that it repeats
        its own bits."""
        torch = self.torch
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import api
        from repro_torch.optim import optimizers as topt
        from repro_torch.sharding.context import make_mesh
        from repro_torch.train.trainer import Trainer, TrainerConfig
        t0 = time.perf_counter()
        cfg = ARCHS["qwen3-0.6b"]
        mesh = make_mesh((1,), ("data",), "cuda")
        params = api.init_params(cfg, torch.Generator(
            device=self.dev).manual_seed(0))
        batches = [self._train_batch(cfg, s) for s in (1, 2)]
        runs = []
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for m in (mesh, None, None):
                opt = topt.adamw(1e-3)
                start = topt.tree_map(torch.clone, params)
                self.reset_counts()
                p, _, hist = Trainer(cfg, opt, TrainerConfig(
                    steps=2, log_every=1), mesh=m).run(
                        None, iter(batches), params=start,
                        opt_state=opt.init(start))
                torch.cuda.synchronize()
                self.read_counts(0, f"dist trainer mesh={m is not None}",
                                 weighted_ce_fwd=2, weighted_ce_bwd=2)
                runs.append((p, [h["loss"] for h in hist]))
        finally:
            torch.use_deterministic_algorithms(was)

        def same(a, b):
            return a[1] == b[1] and all(torch.equal(x, y) for x, y in zip(
                topt.tree_leaves(a[0]), topt.tree_leaves(b[0])))
        self.require(same(runs[1], runs[2]),
                     "the mesh-less trainer does not repeat its own bits")
        (pm, lm), (p0, l0) = runs[:2]
        self.require(same(runs[0], runs[1]), f"the data-parallel trainer "
                                             f"parts from the mesh-less "
                                             f"one: {lm} {l0}")
        table["e"] = {"losses": lm, "max_abs_err": 0.0,
                      "s": time.perf_counter() - t0}
        return (f"(e) Trainer(mesh=) qwen3-0.6b full width, 2 steps = "
                f"mesh-less, losses {lm[0]:.6f} -> {lm[1]:.6f} and "
                f"{len(topt.tree_leaves(pm))} leaves bit for bit")

    # --------------------------------------------------- tensor parallel
    def tensor_parallel(self) -> str:
        """21. The kernels' shard modes at full width, the TP plumbing at
        world 1, the dry run on the card's host."""
        table = {"card": self.card}
        procs, t0 = self._tp_dryrun_start()    # on the host, beside (a)-(c)
        try:
            out = [self._tp_vocab_ce(table), self._tp_length_decode(table),
                   self._tp_world1(table), self._tp_dryrun(table, procs, t0)]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print("tp_table " + json.dumps(table), flush=True)
        return "; ".join(out)

    def _tp_vocab_ce(self, table: dict) -> str:
        """(a) The vocab-shard CE, 16 shards of qwen3-0.6b's vocab."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels import weighted_ce as wce
        from repro_torch.kernels._launch import sm_count
        from repro_torch.sharding import tp
        t, v, parts = 2048, 151936, 16
        v_loc = v // parts
        gen = torch.Generator(device=self.dev).manual_seed(21)
        x = (torch.randn(t, v, generator=gen, device=self.dev) * 2
             ).to(torch.bfloat16)
        lab = torch.randint(0, v, (t,), generator=gen, device=self.dev,
                            dtype=torch.int32)
        lab[:parts] = torch.arange(parts, device=self.dev) * v_loc
        w = torch.rand(t, generator=gen, device=self.dev) + 0.5
        g = torch.rand(t, generator=gen, device=self.dev) + 0.5
        cols = [x[:, r * v_loc:(r + 1) * v_loc] for r in range(parts)]

        def fwd():
            got = [ops.weighted_ce_shard_fwd(c, lab, r * v_loc)
                   for r, c in enumerate(cols)]
            return tp.combine_ce(torch.stack([a for a, _ in got]),
                                 torch.stack([b for _, b in got]))

        def bwd(lse):
            return [ops.weighted_ce_shard_bwd(c, lab, w, lse, g, r * v_loc)
                    for r, c in enumerate(cols)]
        self.reset_counts()
        lse, gold = fwd()
        loss = w * (lse - gold)
        d = torch.cat(bwd(lse), dim=1)
        torch.cuda.synchronize()
        self.read_counts(0, "21(a) vocab-shard CE",
                         weighted_ce_shard_fwd=parts,
                         weighted_ce_shard_bwd=parts)
        whole_loss, whole_lse = wce.weighted_ce_fwd(x, lab, w)
        whole_d = wce.weighted_ce_bwd(x, lab, w, whole_lse, g)
        plain_loss, plain_lse = wce.weighted_ce_fwd_plain(x, lab, w)
        plain_d = wce.weighted_ce_bwd_plain(x, lab, w, plain_lse, g)
        for what, (wl, wlse, wd) in (("whole kernel",
                                      (whole_loss, whole_lse, whole_d)),
                                     ("plain", (plain_loss, plain_lse,
                                                plain_d))):
            self.require(_max_rel(loss, wl) <= 1e-5
                         and _max_rel(lse, wlse) <= 1e-5,
                         f"21(a) shards vs {what}: loss {_max_rel(loss, wl)}"
                         f", lse {_max_rel(lse, wlse)} (rtol 1e-5)")
            elem, row = _dlogits_ratios(d, wd, w, g)
            self.require(elem <= 1 and row <= 1, f"21(a) dlogits vs {what}:"
                         f" {elem}, {row} of their tolerances")
        again = torch.cat(bwd(fwd()[0]), dim=1)
        self.require(torch.equal(again, d), "21(a): two runs differ")
        esize = x.element_size()
        b_fwd, by_fwd = _bound_ms(t * v_loc * esize + 12 * t, 4 * t * v_loc)
        b_bwd, by_bwd = _bound_ms(2 * t * v_loc * esize + 16 * t,
                                  4 * t * v_loc)
        fwd_sum = _graph_ms(lambda: [ops.weighted_ce_shard_fwd(
            c, lab, r * v_loc) for r, c in enumerate(cols)])
        bwd_sum = _graph_ms(lambda: bwd(lse))
        plan = wce.shard_fwd_plan(cols[1], sm_count(
            torch.cuda.current_device()))
        self.require(plan is not None, "21(a): no staged plan for a shard")
        row = {"T": t, "V": v, "shards": parts, "V_loc": v_loc,
               "staged_plan": list(plan),
               "fwd_ms": _cuda_time_ms(lambda: ops.weighted_ce_shard_fwd(
                   cols[1], lab, v_loc), reps=50),
               "bwd_ms": _cuda_time_ms(lambda: ops.weighted_ce_shard_bwd(
                   cols[1], lab, w, lse, g, v_loc), reps=50),
               "fwd_device_ms_shard": fwd_sum / parts,
               "bwd_device_ms_shard": bwd_sum / parts,
               "fwd_device_ms_16": fwd_sum, "bwd_device_ms_16": bwd_sum,
               "whole_fwd_device_ms": _graph_ms(
                   lambda: wce.weighted_ce_fwd(x, lab, w)),
               "whole_bwd_device_ms": _graph_ms(
                   lambda: wce.weighted_ce_bwd(x, lab, w, whole_lse, g)),
               "plain_fwd_ms": _cuda_time_ms(
                   lambda: wce.weighted_ce_shard_fwd_plain(cols[1], lab,
                                                           v_loc),
                   reps=10, warmup=2),
               "plain_bwd_ms": _cuda_time_ms(
                   lambda: wce.weighted_ce_bwd_plain(cols[1], lab, w, lse,
                                                     g, v_loc),
                   reps=10, warmup=2),
               "fwd_bound_ms_shard": b_fwd, "bwd_bound_ms_shard": b_bwd,
               "loss_err": float((loss - plain_loss).abs().max()),
               "dlogits_err": float((d.float() - plain_d.float()
                                     ).abs().max())}
        table["a"] = row
        self.kernels["weighted_ce_shard_fwd"] = {
            "source": "src/repro_torch/csrc/weighted_ce.cu",
            "replaces": "src/repro/kernels/weighted_ce.py:68",
            "max_abs_err": row["loss_err"], "ms": row["fwd_ms"],
            "device_ms": row["fwd_device_ms_shard"],
            "plain_ms": row["plain_fwd_ms"], "bound_ms": b_fwd,
            "bound_by": by_fwd, "library_ms": None}
        self.kernels["weighted_ce_shard_bwd"] = {
            "source": "src/repro_torch/csrc/weighted_ce.cu",
            "replaces": "src/repro/kernels/weighted_ce.py:113",
            "max_abs_err": row["dlogits_err"], "ms": row["bwd_ms"],
            "device_ms": row["bwd_device_ms_shard"],
            "plain_ms": row["plain_bwd_ms"], "bound_ms": b_bwd,
            "bound_by": by_bwd, "library_ms": None}
        return (f"(a) vocab-shard CE {t} x {v} bf16 in {parts} shards of "
                f"{v_loc}: loss, lse and dlogits = the whole kernel and the "
                f"plain version; device ms a shard fwd "
                f"{row['fwd_device_ms_shard']:.4f} (bound {b_fwd:.4f}), bwd "
                f"{row['bwd_device_ms_shard']:.4f} (bound {b_bwd:.4f}); 16 "
                f"shards {fwd_sum:.4f} + {bwd_sum:.4f} against the whole "
                f"{row['whole_fwd_device_ms']:.4f} + "
                f"{row['whole_bwd_device_ms']:.4f}")

    def _tp_length_decode(self, table: dict) -> str:
        """(b) The length-shard decode, 16 chunks of decode_32k's cache."""
        torch = self.torch
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ops
        from repro_torch.sharding import tp
        b, h, kv, s, d, parts = 8, 16, 8, 32768, 128, 16
        n = s // parts
        gen = torch.Generator(device=self.dev).manual_seed(22)
        q = torch.randn(b, h, d, generator=gen, device=self.dev).to(
            torch.bfloat16)
        k, v = (torch.randn(b, s, kv, d, generator=gen, device=self.dev
                            ).to(torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        rows, launches = [], 0
        for pos in (s - 1, 20000, 2 * n):
            def chunks(pos=pos):
                return [ops.flash_decode_shard(
                    q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
                    pos, r * n) for r in range(parts)]

            def merged(parts_ol):
                return tp.merge_partials(
                    torch.stack([o for o, _ in parts_ol]),
                    torch.stack([m for _, m in parts_ol])).to(q.dtype)
            held = sum(fd.valid_range(pos, n, None, r * n)[1]
                       >= fd.valid_range(pos, n, None, r * n)[0]
                       for r in range(parts))
            self.reset_counts()
            per_chunk = chunks()
            torch.cuda.synchronize()
            self.read_counts(0, f"21(b) length-shard decode pos {pos}",
                             flash_decode_shard=held)
            launches += held
            got = merged(per_chunk)
            # each chunk's (o, lse) against the plain shard mode: the lse
            # within 1e-3 (a log2-unit or offset lse moves it by ~1), -inf
            # exactly where the chunk lies past pos; o within 2^-6 of the
            # chunk's max|o|
            lse_err, o_err = 0.0, 0.0
            for r, (o_r, m_r) in enumerate(per_chunk):
                po, pm = fd.flash_decode_plain(
                    q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
                    pos, s0=r * n, return_lse=True)
                fin = torch.isfinite(pm)
                self.require(torch.equal(torch.isfinite(m_r), fin),
                             f"21(b) pos {pos} chunk {r}: lse finite "
                             f"where the plain one is not")
                if bool(fin.any()):
                    lse_err = max(lse_err, float(
                        (m_r[fin] - pm[fin]).abs().max()))
                e = float((o_r - po).abs().max())
                self.require(e <= 2 ** -6 * float(po.abs().max()),
                             f"21(b) pos {pos} chunk {r}: o err {e}")
                o_err = max(o_err, e)
            self.require(lse_err <= 1e-3,
                         f"21(b) pos {pos}: lse err {lse_err} > 1e-3")
            whole = fd.flash_decode(q, k, v, pos)
            plain = fd.flash_decode_plain(q, k, v, pos)
            # the limit scales with the output (its entries are ~1/sqrt
            # of the valid positions, far under max|v|): zeros or a
            # mis-weighted chunk fail it
            ref_max = float(plain.float().abs().max())
            errs = {w: float((got.float() - ref.float()).abs().max())
                    for w, ref in (("whole", whole), ("plain", plain))}
            self.require(max(errs.values()) <= 2 ** -6 * ref_max,
                         f"21(b) pos {pos}: {errs} > 2^-6 * {ref_max}")
            self.require(torch.equal(merged(chunks()), got),
                         f"21(b) pos {pos}: two runs differ")
            rows.append({"pos": pos, "chunks_launched": held, **errs,
                         "max_abs_ref": ref_max, "chunk_lse_err": lse_err,
                         "chunk_o_err": o_err})
        pos = s - 1
        blocks = b * h // fd.heads_per_block(h // kv)
        sms = fd.sm_count(torch.cuda.current_device())
        pass_rows = fd.rows_per_pass(k.dtype, d)
        for pos_ in (s - 1, 20000, 2 * n):      # every chunk 21(b) launches
            for r in range(parts):
                lo, hi = fd.valid_range(pos_, n, None, r * n)
                self.require(hi < lo or fd.decode_plan(
                    lo, hi, blocks, sms, pass_rows)[0]
                    == "flash_decode_cluster",
                    f"21(b): chunk {r} at pos {pos_} takes the split kernel")
        # one device kernel a chunk: the merge runs in the cluster
        nodes, kinds = _device_kernels_per_call(
            lambda: ops.flash_decode_shard(q, k[:, :, :n], v[:, :, :n], pos,
                                           0))
        self.require(kinds.get("kernel") == 1,
                     f"21(b): a chunk enqueued {kinds}, not one kernel")
        shard_sum = _graph_ms(
            lambda: [ops.flash_decode_shard(
                q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
                pos, r * n) for r in range(parts)])
        # a yardstick, not the same function: SDPA over each chunk gives o
        # alone (no lse), in bf16
        qs = q[:, :, None]
        sdpa_sum = _graph_ms(
            lambda: [torch.nn.functional.scaled_dot_product_attention(
                qs, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
                enable_gqa=True) for r in range(parts)])
        b_shard, by = _bound_ms(2 * b * kv * n * d * 2 + b * h * d * 2
                                + b * h * (d + 1) * 4, 4 * b * h * n * d,
                                BF16_OPS_PER_S)
        row = {"B": b, "H": h, "KV": kv, "S": s, "D": d, "chunks": parts,
               "cluster_plan": list(fd.cluster_plan(0, n - 1, blocks, sms,
                                                    pass_rows)),
               "device_ops_chunk": kinds,
               "sdpa_yardstick_device_ms_chunk": sdpa_sum / parts,
               "checks": rows, "ms": _cuda_time_ms(
                   lambda: ops.flash_decode_shard(
                       q, k[:, :, :n], v[:, :, :n], pos, 0), reps=50),
               "device_ms_chunk": shard_sum / parts,
               "device_ms_16": shard_sum,
               "whole_device_ms": _graph_ms(
                   lambda: fd.flash_decode(q, k, v, pos)),
               "plain_ms": _cuda_time_ms(lambda: fd.flash_decode_plain(
                   q, k[:, :, :n], v[:, :, :n], pos, s0=0, return_lse=True),
                   reps=10, warmup=2),
               "bound_ms_chunk": b_shard, "bound_by": by}
        table["b"] = row
        self.kernels["flash_decode_shard"] = {
            "source": "src/repro_torch/csrc/flash_decode_cluster.cu",
            "replaces": "src/repro/kernels/flash_decode.py:96",
            "max_abs_err": max(r["plain"] for r in rows), "ms": row["ms"],
            "device_ms": row["device_ms_chunk"], "plain_ms": row["plain_ms"],
            "bound_ms": b_shard, "bound_by": by, "library_ms": None}
        return (f"(b) length-shard decode B {b} H {h} KV {kv} S {s} D {d} "
                f"in {parts} chunks at pos {[r['pos'] for r in rows]}: = "
                f"the whole kernel and the plain version (max err "
                f"{max(max(r['whole'], r['plain']) for r in rows):.3g} "
                f"against 2^-6 max|ref|, at least "
                f"{min(r['max_abs_ref'] for r in rows) / 64:.3g}; chunk lse "
                f"within {max(r['chunk_lse_err'] for r in rows):.3g} of the "
                f"plain version's), {launches} chunk launches; device ms "
                f"a chunk {row['device_ms_chunk']:.4f} (bound "
                f"{b_shard:.4f}; SDPA's o alone, a yardstick, "
                f"{row['sdpa_yardstick_device_ms_chunk']:.4f}), one device "
                f"kernel a chunk, 16 chunks {shard_sum:.4f} against the "
                f"whole {row['whole_device_ms']:.4f}")

    def _tp_world1(self, table: dict) -> str:
        """(c) Plumbing only: the steps under a (1, 1) mesh over a
        one-rank NCCL group = the mesh-less steps, bit for bit."""
        torch = self.torch
        import torch.distributed as dist
        from repro_torch.configs.registry import ARCHS
        from repro_torch.models import api
        from repro_torch.optim import optimizers as topt
        from repro_torch.sharding import tp
        from repro_torch.sharding.context import make_mesh, mesh_context
        from repro_torch.train.trainer import Trainer, TrainerConfig
        t0 = time.perf_counter()
        self.require(not dist.is_initialized(),
                     "a process group is already initialised")
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
        cfg = ARCHS["qwen3-0.6b"].with_overrides(use_flash=True)
        layers = cfg.num_layers
        params = api.init_params(cfg, torch.Generator(
            device=self.dev).manual_seed(0))
        gen = torch.Generator(device=self.dev).manual_seed(3)
        prompt, steps = 256, 4
        out, checked = {}, []
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            for batch in (4, 1):
                tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                       generator=gen, device=self.dev)
                follow = torch.randint(0, cfg.vocab_size, (batch, steps),
                                       generator=gen, device=self.dev)
                runs = []
                for m in (mesh, None):
                    self.reset_counts()
                    with torch.no_grad(), mesh_context(m):
                        logits, caches = api.make_prefill_step(cfg)(
                            params, {"tokens": tokens})
                        caches = api.pad_prefill_cache(
                            caches, cfg, prompt + steps, batch=batch)
                        split = tp.split_of(caches["sub0"][0]) is not None
                        seq = [logits]
                        for i in range(steps):
                            _, lg, caches = api.make_serve_step(cfg)(
                                params, caches, follow[:, i:i + 1],
                                prompt + i)
                            seq.append(lg)
                    torch.cuda.synchronize()
                    dec = layers * steps
                    self.read_counts(
                        0, f"21(c) batch {batch} mesh={m is not None}",
                        flash_attention=layers,
                        flash_decode=0 if split else dec,
                        flash_decode_shard=dec if split else 0)
                    runs.append((seq, split))
                (tp_seq, split), (seq, _) = runs
                self.require(split == (batch == 1), f"21(c) batch {batch}: "
                             f"length split {split}")
                self.require(all(torch.equal(a, b) for a, b in
                                 zip(tp_seq, seq)), f"21(c) batch {batch}:"
                             f" the (1, 1) mesh's logits part from the "
                             f"mesh-less ones")
                checked.append(f"batch {batch} prefill + {steps} steps "
                               f"({'split along positions' if split else 'heads'})")
            train_cfg = cfg.with_overrides(use_flash=False)
            batches = [self._train_batch(train_cfg, 1)]
            was = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True, warn_only=True)
            trained = []
            try:
                for m in (mesh, None):
                    opt = topt.adamw(1e-3)
                    start = topt.tree_map(torch.clone, params)
                    self.reset_counts()
                    p, _, hist = Trainer(train_cfg, opt, TrainerConfig(
                        steps=1), mesh=m).run(None, iter(batches),
                                              params=start,
                                              opt_state=opt.init(start))
                    torch.cuda.synchronize()
                    self.read_counts(0, f"21(c) train mesh={m is not None}",
                                     weighted_ce_fwd=1, weighted_ce_bwd=1)
                    trained.append((p, hist[0]["loss"]))
            finally:
                torch.use_deterministic_algorithms(was)
            (pm, lm), (p0, l0) = trained
            self.require(lm == l0 and all(torch.equal(a, b) for a, b in zip(
                topt.tree_leaves(pm), topt.tree_leaves(p0))),
                f"21(c) the (1, 1) mesh's train step parts: {lm} {l0}")
            checked.append(f"one AdamW step, loss {lm:.6f}")
        finally:
            dist.destroy_process_group()
        table["c"] = {"checked": checked, "s": time.perf_counter() - t0}
        return ("(c) plumbing only, qwen3-0.6b full width bf16 under a "
                "(1, 1) mesh over NCCL = mesh-less bit for bit: "
                + ", ".join(checked))

    @staticmethod
    def _tp_dryrun_start() -> tuple[dict, float]:
        """(d)'s two dry runs started side by side (the host's CPU only):
        the processes by shape, and their start time."""
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        return {shape: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-0.6b", "--shape", shape, "--out",
             os.path.join(SMOKE_DIR, "dryrun")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for shape in ("train_4k", "decode_32k")}, time.perf_counter()

    def _tp_dryrun(self, table: dict, procs: dict, t0: float) -> str:
        """(d) The dry run on the card's host: a fake world of 256."""
        rows = {}
        out_dir = os.path.join(SMOKE_DIR, "dryrun")
        for shape, proc in procs.items():
            text, _ = proc.communicate(timeout=300)
            self.require(proc.returncode == 0,
                         f"21(d) dryrun {shape}: {text[-3000:]}")
            with open(os.path.join(out_dir,
                                   f"qwen3-0.6b_{shape}_16x16.json")) as f:
                art = json.load(f)
            rows[shape] = {"s": time.perf_counter() - t0,
                           "run_s": art["lower_s"], **art["roofline"],
                           "collectives": art["collectives"],
                           "memory": art["memory"]}
        table["d"] = rows
        return ("(d) dryrun qwen3-0.6b on 16x16, both shapes side by "
                "side and beside (a)-(c) (seconds since their start): "
                ) + "; ".join(
            f"{k} {r['s']:.1f} s, compute {r['compute_s']:.3e} s, memory "
            f"{r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s "
            f"-> {r['bottleneck']}" for k, r in rows.items())

def _zoo_cfg(arch: str, layers):
    """An arch's full config, ``layers`` deep (None: its own depth;
    "reduced": ``reduced()``)."""
    from repro_torch.configs.registry import ARCHS
    if layers == "reduced":
        return ARCHS[arch].reduced()
    return ARCHS[arch] if layers is None else ARCHS[arch].with_overrides(
        num_layers=layers)


def _zoo_attention(cfg) -> tuple[int, int]:
    """The attention layers a prefill and a decode step run under
    use_flash: flash_attention and flash_decode launches."""
    from repro_torch.models import transformer
    if cfg.cross_attention:          # the encoder, self and cross
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    n = (transformer._block_kinds(cfg).count("attn")
         * transformer._num_units(cfg))
    return n, n


def _upcast_in_place(tree: dict) -> None:
    """Every leaf of ``tree`` cast to float32, one at a time, the old
    leaf's memory given back to the card before the next."""
    import torch
    for k in list(tree):
        if isinstance(tree[k], dict):
            _upcast_in_place(tree[k])
        else:
            tree[k] = tree[k].float()
            torch.cuda.empty_cache()


def _clone_cache(tree):
    """A decode cache tree with every tensor copied (decode writes in
    place)."""
    if isinstance(tree, dict):
        return {k: _clone_cache(v) for k, v in tree.items()}
    return type(tree)(*(a.clone() for a in tree))


def _tree_to(tree: dict, device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _leaves(tree) -> list:
    """The tensor leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]

def _bf16_backbone_logits(params: dict, X, cfg):
    """``learners.neural.logits`` with the backbone computed in bf16 (the
    params and features cast down, not up): phase 12(d)'s control."""
    import torch
    from dataclasses import replace
    from repro_torch.models import classifier, transformer
    from repro_torch.optim.optimizers import tree_map
    cfg16 = replace(cfg, dtype="bfloat16")
    p16 = tree_map(lambda t: t.to(torch.bfloat16),
                   {**params, "embed": {"embedding":
                                        params["embed"]["embedding"][:1]}})
    emb = (X.to(torch.bfloat16) @ p16["proj"])[:, None, :]
    tokens = torch.zeros((X.shape[0], 1), dtype=torch.long, device=X.device)
    x = emb + transformer.embed_inputs(p16, {"tokens": tokens}, cfg16)
    return classifier.pooled_logits(p16, transformer.hidden_states(
        p16, x, cfg16))


def main(argv: list[str]) -> int:
    """``--phases 1,8`` runs those phases only (they need phase 1's build
    first), for work on one part; with no arguments, all of them."""
    phases_arg = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            print("usage: chip_smoke.py [--phases N,M,...]", file=sys.stderr)
            return 2
        phases_arg = sorted({int(n) for n in argv[1].split(",")})
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(SMOKE_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = f"card: {smi.stdout.strip().splitlines()[0]}"
    print(card, flush=True)
    s = Smoke()
    s.card = card
    phases = {1: s.build, 2: s.kernel_vs_plain, 3: s.cli_path, 4: s.mimic,
              5: s.fashion, 6: s.mimic_channel, 7: s.fashion_channel,
              8: s.flash_vs_plain, 9: s.serve, 10: s.ce_vs_plain,
              11: s.train, 12: s.learners, 13: s.control,
              14: s.compiled, 15: s.serve_path, 16: s.scenarios,
              17: s.telemetry, 18: s.compiled_rest, 19: s.zoo,
              20: s.distributed, 21: s.tensor_parallel}
    chosen = sorted(phases) if phases_arg is None else phases_arg
    for num in chosen:
        s.phase(num, phases[num])
    if s.failed:
        print(f"chip_smoke: failed {s.failed}", file=sys.stderr)
        return 1
    if chosen != sorted(phases):
        print(f"chip_smoke: phases {chosen} passed (a partial run prints "
              f"no result)")
        return 0
    kernels = [{"name": name, "route": "cuda", **s.kernels[name],
                "launches": s.launches[name]}
               for name in [*_counters(), *QMAX_ROUTES]]
    print(card)  # again near the end, where a reader of the tail finds it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
