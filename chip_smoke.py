#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and no result line is printed):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` (two
   sources, one ``nvcc`` each, started together) and print the compiler's
   register / shared-memory report;
3. hold the fused serving kernel's per-table entry (K4,
   ``fused_serve_pool``) against its plain PyTorch version on the card at
   the serving shapes (int8 QR pair, B=256, L=4, D=16) and over its
   variants: f32, bf16, add, a single table, a projection, empty bags and
   an all-empty (L=0) wave;
4. hold the interaction kernel (K2) against its plain versions in f32 and
   bf16: the top MLP's input ``[z, triangle]`` written from z and the
   features read in place (``dot_interaction_concat``, the model's call),
   with z and feats contiguous, as strided views of one buffer and as
   transposed views, and the stacked ``dot_interaction(x)``, at
   DLRM-Criteo's B=256, F=27, D=16 and at ragged F (2, 33), D (24, 128)
   and B (1, 257);
5. hold the one-hot QR lookups' per-table entries against their plain
   versions on the largest Kaggle table (QR c=4: 2,532,807 + 4 rows, D=16)
   at N=256 Zipf ids: K1 ``qr_gather`` in f32 and bf16, mult and add, and a
   3-D ``idx`` through ``ops.qr_lookup``; K5 ``qr_gather_quant`` on the
   int8 pair;
6. hold the grouped kernels (``csrc/grouped_lookup.cu``) at full width —
   the 26 Kaggle tables as QR pairs (c=4), D=16, raw ids with 0, m-1, m and
   size-1 of every table — against their plain versions and against 26
   per-table launches of the same kernel (max |diff| 0 expected): grouped
   K4 at B=256, L=4 in int8 (mult, add), f32 and bf16 with empty bags, and
   an all-empty (L=0) wave; grouped K5 at B=256 in int8 (mult, add);
   grouped K1 at B=256 in f32 and bf16 (mult, add);
7. hold the QR embedding bag (K3, ``qr_embedding_bag``, the grouped
   kernel's dense pooled case) against its plain version at three shapes:
   serving-like on the largest Kaggle table (QR c=4, B=256, L=4, D=16, f32
   and bf16, mult and add, fractional weights, empty bags, raw ids with 0,
   m-1, m and size-1), the reference kernel bench's (B=32, L=8, m=2048,
   q=16, D=128) and the bandwidth shape (the largest table's QR pair at
   D=128 f32, 16,384 bags of L=32, uniform ids over every category); check
   that the raw-id route (``ops.qr_bag_lookup``) is bit-equal to the
   pre-split entry, that ids and mask are read in place as strided views,
   that empty bags and L=0 are exactly zero, and that a bf16 table's
   weights round to bf16 before they multiply; run the f32-accumulation
   audit (B=8, L=16, D=128, bf16) against an f32 oracle, with a bf16
   running sum failing it;
8. serve the full-width DLRM-Criteo (26 Kaggle tables, QR with 4
   collisions, D=16, int8 tables) through ``RecsysEngine`` over launcher-
   style requests with some empty bags; check that every request is scored
   and finite, that the kernels' launch counts match the waves (one grouped
   K4 and one K2 per wave), and that a sample of scores matches the same
   engine with ``use_kernel=False``; print p50/p99/QPS, peak memory and
   table bytes; profile a full wave, with its device operations and any id
   split, copy or concatenation kernels left;
9. serve the same requests from the hot-row cache (``DeviceHotRowCache``,
   ``[cache]``): at full width, cache off and with the launcher's 4,096
   rows (a wave's unique keys exceed them: admission refused, the wave
   served in-graph through K4) and 1 << 20 rows (the working set fits: a
   64 MiB slab), each a warm pass, a timed pass and a profiled pass of
   1,024 requests — branch counts, hits, misses, evictions, rejections,
   slab bytes, device ms and operations per wave, host ms per wave by
   stage, p50/p99/QPS, and scores within 1e-4 of the cache-off kernel
   engine (and of the plain engine on a sample); then on the reduced
   config (77,339 canonical rows: the speculative slot-map probe) against
   cache off, a 2-row cache (every admission refused, scores equal to
   cache off), ``swap_plan`` from c=4 to c=2 (the residency dropped, the
   scores after it equal a fresh engine's) and the DCN from the cache; one
   K2 per dense stage and K4 exactly on the waves the tables served;
10. score 12 held-out batches of 256 (steps 10,000-10,011, the reference's
   ``paper_tables`` evaluation) with the full-width one-hot DLRM-Criteo
   through ``api(cfg).batch_fn`` / ``loss_fn`` / ``predict``, once with
   f32 tables (one grouped K1 per batch, and K2) and once after int8
   quantization (one grouped K5 per batch, and K2); check the launch
   counts, finite logits, and logits and loss against ``use_kernel=False``;
   print BCE, accuracy, wall and device ms per batch, device operations,
   the device's busy share, table bytes and peak memory;
11. ``[K6]``: hold the QR pairs' backward (``qr_pairs_backward``) at the
   training cell's shape (the 26 Kaggle tables as f32 QR pairs, B=65,536,
   D=16, ids ``floor(S * u ** 1.5)``) against its plain version, bit-equal
   over two calls, one launch a call; time it beside its bound, the plain
   version and ``F.embedding``'s dense backward of the same gradients; then
   train the full-width DLRM-Criteo (plain path, as the reference trains)
   with the paper's Adagrad (1e-2) at B=256 for 200 steps through
   ``Trainer``: finite losses, the mean of the last 10 below step 0's; one
   step's loss and gradients on the card against the CPU's on the same
   parameters and batch; wall and device ms per step, device operations,
   the top device operations, the busy share, the optimizer pass against
   its bytes bound, peak memory, checkpoint save and restore seconds; then
   score the 12 held-out batches with the trained tables through one
   grouped K1 and one K2 per batch (f32) and through K5 and K2 (int8),
   against ``use_kernel=False``; check that each CUDA wrapper raises under
   grad mode for an operand that requires grad; and, at the reduced
   config with ``torch.use_deterministic_algorithms(True)``, that a
   Trainer killed at step 15 and resumed from its step-10 checkpoint ends
   bit-equal to an uninterrupted run;
12. drive K3's own entry point ``ops.qr_bag_lookup`` at the shape of the
   reference's kernel bench and on the largest Kaggle table (one K3 launch
   each), and count its device operations per call (the launch counters
   and the ATen operations dispatched on the card: exactly one);
13. ``[plan]``: solve the full-width DLRM-Criteo's memory plan with the
   port's planner (stats from 24 CPU-drawn batches of 512, a budget of
   0.125 x the full f32 tables, widths {4, 8, 16}) and hold every field to
   the JAX package's plan on the same stats
   (``src/repro_torch/benchmarks/reference_plans.json``, from
   ``tools/plan_reference.py``); build the planned model on the card (22
   full tables and 4 QR pairs, 18 projections) and hold each table's bytes
   to the plan's, f32 and int8; hold grouped K4 at the planned wave (int8
   rows of 4, 8 and 16 bytes, projections in shared memory) against its
   plain version and 26 per-table launches; serve the 2,048 requests int8
   through ``RecsysEngine`` (one grouped K4 and one K2 per wave, scores
   within 1e-4 of the plain engine), then from a 1 << 20-row device cache
   (a slab per width, the per-feature slab branch; scores within 1e-4 of
   cache off); score the 12 held-out batches one-hot in f32 and int8 (one
   K1 or K5 per QR pair and one K2 per batch, against ``use_kernel=False``);
   train it 100 Adagrad steps through ``Trainer`` (the loss falls) and hold
   one step's gradients, projections included, to the CPU's; and swap the
   live uniform c=4 engine of 8 onto the planned model with ``swap_plan``
   (its scores equal a fresh engine's);
14. ``[online]``: on ``[plan]``'s model (int8, kernels on) and the port's
   stream at Kaggle sizes — fit the detector's ``collision_scale`` on 4
   stationary windows of 2,048 requests (the reference drift bench's lane
   1); serve 2,048 ``[serve]`` requests on twin engines, obs off and
   ``Obs(trace=True, collisions=True)``: scores bit-equal, one grouped K4
   and one K2 per wave on both, the stage partition ratio 1 within 1e-9,
   one ``wave`` profiler range per wave in a profiled pass with
   ``profiler_annotations``, obs-off vs obs-on host ms per wave alternated
   7 times, and the obs work itself (the telemetry's record and
   compaction, the stage and trace recording) timed in place per wave; run
   ``ReplanController`` (the reference bench's thresholds, ``min_lookups``
   4 x 256) on an engine with a 1 << 20-row device cache, batching
   ``waves``, beside a twin with no controller, over 3 stationary windows
   (no fire allowed) and up to 6 drifted ones (``DriftSpec(rotate_frac=
   0.5, zipf_after=8)``, ONLINE_ZIPF_AFTER) until the detector fires,
   printing every decision with the QR features' predicted and measured
   masses and the population masses of the stream, of this drift and of
   the reference bench's (zipf_after 0.7).  The detector keeps the
   reference's rel_gap, hysteresis and cooldown; its abs_gap is the
   largest mass measured on the calibration windows (ONLINE_THRESHOLDS).
   No fire fails the phase.  On the fire: the re-plan within the plan's
   budget, 2 drifted windows after the swap (the launches held to the
   cache's branches), p50 / p99 through the swap beside the twin's and the
   reference's bound.  Then, on the installed plan, hold the migration on
   the card against the same call on CPU copies (every leaf within 1e-5
   of its largest |value|, and the served params its re-quantization), a
   fresh cache-off engine on the migrated int8 params (one grouped K4 and
   one K2 per wave, scores within 1e-4 of the swapped engine), the
   migrated model's one-hot
   scoring in f32 and int8 (one K1 / K5 per QR pair and one K2 per batch,
   within 1e-4 of ``use_kernel=False``), and 20 Adagrad steps through
   ``Trainer(obs=Obs(trace=True))`` (20 histogram samples and
   ``train_step`` events, losses bit-equal to an obs-off run with
   deterministic algorithms).  ``drift_bench`` runs on its own;
15. ``[sweep]``: run ``examples/compression_sweep.py`` on the card at its
   defaults — the full tables, then the plan and the uniform-hash control
   at 4 budgets (0.05 to 0.5 of the f32 tables), 9 models of 10 reduced
   tables trained 250 Adagrad steps at B=256 from CPU-drawn parameters on
   CPU-drawn batches — and hold every plan field for field, and every
   held-out loss within its row's tolerance, to the JAX package's run on
   the port's stream (``src/repro_torch/benchmarks/reference_sweep.json``
   from ``tools/sweep_reference.py``: 0.02, or 1.5 times the row's
   JAX-vs-port-CPU gap where that is larger); print whether the quality
   proxy's order agrees with the trained order per budget;
16. ``[dist]``: the data-parallel step with compressed gradient exchange
   on the full-width DLRM-Criteo (Adagrad 1e-2, global batch 256), in
   spawned worlds: (a) NCCL, a world of one — per policy (none, bf16,
   int8, auto) ``init_dp_state`` + ``make_dp_train_step`` for 3 steps, the
   "none" step's gradients, parameters and Adagrad state against
   ``make_train_step``'s (1e-6 of each leaf's largest |value|), the NCCL
   calls ``dist.wire`` recorded (0 bytes at n = 1); (b) gloo, a world of
   4 with every rank on cuda:0 (NCCL takes one rank per card) — per policy
   3 steps with the replicas' parameters bitwise equal after each (gathered
   checksums), recorded bytes equal to ``dp_step_wire_bytes`` within 10%,
   int8 / none below 0.30, ``ef_psum_grads`` on the card equal to the same
   call on the CPU in the same world (int8 and bf16 bit for bit, none
   within 1e-6), "none" against one device on the whole batch (1e-4 of
   each leaf's largest |g|); (c) the "auto" steps through
   ``Trainer(obs=, step_wire=)`` (counters = 3 × each leaf's accounted
   bytes, within 10% of the bytes recorded for it) and the training
   launcher at full width as a world of one; then the tables trained under
   "auto" scored on the 12 held-out batches through one K1 and one K2 per
   batch, against the plain path (1e-4).  Wall ms per step per policy and
   world beside the card's name and power limit;
17. ``[fsdp]``: the full-width model's FSDP step (``make_fsdp_train_step``,
   Adagrad 1e-2, global batch 256) in two spawned worlds: (a) NCCL, a
   world of one, deterministic algorithms — 3 "none" steps bit-equal to
   ``make_train_step``'s, parameters and Adagrad state; (b) gloo, a world
   of 4 on cuda:0 — 3 steps per lane (none, bf16, int8, auto, and auto
   with the bf16 parameter gather) with the replicas' parameters bitwise
   equal after each (the bf16-gather lane's scattered leaves compared at
   bf16: each rank keeps its own shard exact), the recorded bytes per step
   equal to ``fsdp_step_wire_bytes`` exactly, each rank's optimizer state
   1/4 of DP's for the scattered leaves, "none" FSDP's first-step reduced
   gradients within 1e-6 of "none" DP's, "none" FSDP and DP bit-equal on a
   loss whose sums are exact, a checkpoint gathered and written at step 2,
   restored at world 4 and continued to step 3 bit-equal to the
   uninterrupted run, and restored with world-2 shardings equal to the
   full leaves cut; peak memory per rank; then the "auto"-trained tables
   scored through one K1 and one K2 per held-out batch (1e-4 of plain);
18. ``[serve_dist]``: a gloo world of 4 on cuda:0 serves the 2,048
   requests of phase 8 (after 256 warm-up ones) from row-sharded tables,
   ``max_batch=256`` (64 per rank), with the full-width int8 model, again
   from a 1 << 20-row device cache (1,024 requests twice), and with
   ``[plan]``'s planned model: the placement (threshold, sharded
   sub-tables, bytes per rank within ``total/N + replicated + pad``), one
   grouped K4 and one K2 per wave on every rank (the counters, zeroed just
   before), scores equal on every rank and within 1e-4 of a single-device
   engine, the recorded exchange bytes per wave equal to
   ``serve_wave_wire_bytes``, the cache's hits and its keys from replicated
   features only; then ``launch/serve.py --mesh-devices 4`` under
   ``torchrun``;
19. ``[analysis]``: the port's static analyzer (``repro_torch.analysis``)
   on the card, in this process as ``python -m repro_torch.analysis
   --device cuda --world 4 --plan build/serve_dist/plan.json --format json
   --out build/analysis/report.json`` runs it: exit 0 with the ten passes
   clean — ACC-002's eight programs on the card (K1 to K5 each launched,
   the results within rtol 5e-3 of their terms' magnitude against an f64
   oracle, at L=16, D=128 too, where a bf16 running sum fails), WIRE-001's
   eight exchanges in a gloo world of 4 on cuda:0 (bytes intercepted at
   ``torch.distributed`` = ``dist.wire``'s = the closed forms), JIT-002 on
   the small engine, INJ-001 on the 16 swept plans and the full-width plan
   (26 tables, 33,762,577 categories, all exact); JIT-002 again on the
   full-width int8 engine (``max_batch=256``: signatures within the bucket
   bound, none added by the replay, one grouped K4 and one K2 per wave);
   the injected run (``REPRO_ANALYSIS_INJECT=wire --select WIRE-001``)
   exits 1; ``python -m benchmarks.summary_md --analysis ... --no-bench``
   renders the report;
20. ``[lm]``: the full-width TinyLlama-1.1B (``configs/tinyllama_1_1b``:
   vocab 32,000 as a bf16 QR pair of 8,000 + 4 rows x 2,048 combined with
   ``mult``, 22 layers, 32 heads, 4 KV heads, d_ff 5,632; 1,050,904,576
   parameters, 2,101,809,152 bytes) drawn on the card: 48 greedy requests
   (32 prompts of 512 tokens, 16 of 128; 32 new tokens each) served
   through ``ServeEngine`` in waves of 16 with ``max_len`` 1,024 — every
   request complete, every token in range, exactly one K1 launch per
   ``prefill`` and per ``decode_step`` call and no other kernel, the
   token lookup one device operation per call; on the first wave, K1's
   embedding and the prefill logits against the plain route
   (``embed.apply`` → ``forward_hidden`` → the LM head) bit for bit, and
   each decode step's logits against teacher forcing within a tolerance
   the f32 check gives (its gap x 2^16 x sqrt(22 / 2) of the largest
   logit; greedy tokens equal wherever the top-2 gap exceeds it); an
   8,192-token prompt's prefill
   (finite logits, peak memory below one 32 x 8,192 x 8,192 f32 score
   matrix); the same widths at 2 layers in f32 (TF32 off) against the CPU
   (a prefill and 4 decode steps within 1e-3, a ``loss_fn``
   value-and-grad within 1e-5 and 1e-4 of each leaf's largest |g|); 10
   Adam (3e-4) steps through ``Trainer`` at B=4, S=256 (the loss falls),
   one wave served from the trained parameters through K1, and the same
   call refused with parameters that require grad; the serving and
   training launchers as subprocesses.  Prefill ms per wave, decode ms
   per step, tokens/s, device ms and operations per decode step and the
   busy share;
21. ``[moe]``: the full-width DeepSeek-V2 (``configs/deepseek_v2_236b``:
   MLA with 128 heads, q_lora 1,536, kv_lora 512, d_nope 128, d_rope 64,
   d_v 128; a MoE of 160 experts top-6 (d_ff 1,536) with 2 shared
   experts; vocab 102,400 as a bf16 QR pair of 25,600 + 4 rows x 5,120)
   cut to 4 of its 60 layers, the one cut (16,543,851,520 parameters,
   33,094,256,640 bytes, the reference's ``jax.eval_shape``), drawn on the
   card: first the same widths at 1 layer in f32 (TF32 off) against the
   machine's CPU on 2 x 32 tokens (routes equal except at a near-tie of
   the k-th and (k+1)-th router probabilities within 1e-4, the logits of
   agreeing tokens within 1e-3 of the largest, the aux loss within 1e-5)
   and, on the card, 16 absorbed-MLA decode steps against the
   teacher-forced forward; then [lm]'s 48 greedy requests in waves of 16
   (one K1 per call and nothing else, the lookup one device operation,
   K1 and the prefill logits bit-equal to the plain route, the routes the
   capacity dropped counted: prefill drops by design, decode none; decode
   against teacher forcing on 4 of the first wave's rows replayed at a
   capacity that drops nothing, compared at the positions where every
   layer chose the same top-6 set, within the f32 gap x 2^16 x sqrt(4 /
   1), the dropped, flipped and compared counts printed), a decode step's
   device time, operations and busy share, an 8,192-token prefill
   (finite, peak memory above the parameters), 10 Adafactor (1e-4) steps
   at 2 layers, B=4, S=256 by ``make_train_step`` (the loss finite and
   falling, the aux loss positive), and
   ``arctic-480b`` at full width and 1 of 35 layers (13,897,942,016
   parameters): one wave of 16 x 128 tokens, one K1 per call, K1 and the
   prefill logits bit-equal to the plain route;
22. ``[ssm]``: mamba2-370m and zamba2-1.2b whole at full width, and one
   wave of the full-width qwen3-14b (``ssm_full_width``'s docstring);
23. ``[encdec]``: the full-width seamless-m4t-large-v2
   (``configs/seamless_m4t_large_v2``: 24 encoder and 24 decoder layers,
   d 1,024, 16 heads, gelu d_ff 8,192; vocab 256,206 as a bf16 QR pair of
   64,052 + 4 rows x 1,024; 1,436,418,048 parameters) whole: first 2 + 2
   layers in f32 (TF32 off) against the machine's CPU ([lm]'s bounds, and
   the decode within 1e-4 of the largest logit of the teacher-forced
   training forward); then [lm]'s 48 greedy requests in waves of 16, each
   wave's stub frames ``frames_at(0, wave, 16, plen // 4, 1,024)`` (one
   K1 per call and nothing else, the lookup one device operation; on the
   first wave K1 and the prefill logits bit-equal to the plain route, the
   decode against teacher forcing within the f32 gap x 2^16 x
   sqrt(48 / 4)), a decode step's device time, operations and busy
   share, and 10 Adam (3e-4) steps through ``Trainer`` at B=4, S=256
   with 64 frames (the loss falls; the peak taken apart);
24. ``[vlm]``: llava-next-34b (``configs/llava_next_34b``: the yi-34b
   backbone, d 7,168, 56 heads, 8 KV heads, d_ff 20,480; vocab 64,000 as
   a bf16 QR pair of 16,000 + 4 rows x 7,168; a 2-layer gelu projector)
   at full width and 28 of its 60 layers (16,296,225,792 parameters):
   first 1 layer and 64 patches in f32 against the machine's CPU, as
   [encdec]; then the same queue, each request after 1,152 stub patches
   ``patches_at(0, wave, 16, 1,152, 7,168)``, decoding at ``pos + 1,152``
   into a cache of ``max_len + 1,152`` rows (ROADMAP §3 finding 13), with
   [encdec]'s gates (K1 embeds the text only); 10 Adafactor (1e-4) steps
   at 2 layers, B=2, 1,152 patches + 256 tokens (the loss falls);
25. ``[granite]``: granite-8b (``configs/granite_8b``: the llama arch at
   36 x 4,096, 32 heads, 8 KV heads of 128, d_ff 14,336; vocab 49,152 as
   a bf16 QR pair of 12,288 + 4 rows x 4,096; 8,103,710,720 parameters)
   whole: first 2 layers in f32 against the machine's CPU ([lm]'s bounds),
   then [lm]'s 48 greedy requests with [lm]'s gates (one K1 per call and
   nothing else, K1 and the prefill logits bit-equal to the plain route,
   decode within the f32 gap x 2^16 x sqrt(36 / 2) of teacher forcing), a
   decode step's device time, operations and busy share; 10 Adam (3e-4)
   steps through ``Trainer`` at 8 of the 36 layers, B=4, S=256 (the loss
   falls; the peak taken apart);
26. ``[mesh]``: the full-width int8 DLRM-Criteo (135,528,097 parameters)
   served by ``RecsysEngine(mesh=)`` on a ``(data=1, model=1)`` NCCL
   ``DeviceMesh`` of this card (the parameters DTensors by the inference
   placement, the dense stage on DTensors, the kernels on local tensors)
   and by the unmeshed engine, on the 2,048 requests in waves of 256:
   scores bit-equal, one grouped K4 and one K2 per wave and nothing else,
   no bytes gathered; then both engines through a 1 << 20-row
   ``DeviceHotRowCache`` and through a 4,096-row host ``HotRowCache``:
   scores bit-equal, the cache's statistics, its branches and the
   launches equal, no bytes gathered; p50 / p99 / QPS of every lane;
27. ``[dryrun]``: the dry run (``repro_torch.launch.dryrun``) of one cell
   per family of the ten assigned archs at full width on pod_32x8 —
   tinyllama-1.1b at train_4k, prefill_32k and decode_32k,
   deepseek-v2-236b, zamba2-1.2b, seamless-m4t-large-v2 and
   llava-next-34b at decode_32k, mamba2-370m at long_500k — each in its
   own process on a fake process group of 256 (``meta`` tensors: nothing
   launched), all started together; per cell the per-GPU flops, bytes,
   wire bytes by mesh axis, argument and peak bytes, the dominant term and
   MODEL/counted flops (at most 1), the arguments over 256 GPUs at least
   the unsharded ones; then the roofline table at the H100 constants
   (derived, not measured);
28. run the paper's §5 experiment (``repro_torch.benchmarks.paper_tables``)
   on the card for ``PAPER_ROWS``: fig4's six rows (DLRM and DCN x full,
   hash, QR mult) and QR add, concat, feature mode, threshold 2,000 and
   the path-based table at hidden 16, each trained 400 steps at B=256 on
   parameters and batches drawn on the CPU and copied; per row (a) the
   losses are finite and the mean of the last 10 is below step 0's, (b)
   the held-out scoring with the kernels equals the plain path within
   1e-4 with 12 K2 and the row's K1 launches (``run_row`` raises
   otherwise; DCN rows run no kernel), (c) the first 5 steps equal the
   same steps on the machine's CPU: from each of the CPU's first 5 states,
   on the same batch, the card's loss within rtol 1e-5 and its gradients
   within 1e-4 of each leaf's largest |g| (the free-running trajectories,
   card vs CPU and card vs a second card run, are printed), and (d) the
   held-out BCE lies within the row's tolerance of
   ``src/repro_torch/benchmarks/reference_rows.json`` (the reference's
   rows from ``tools/paper_tables_reference.py``); then train
   ``fig4/dlrm/qr_mult`` 400 steps on the machine's CPU and print its
   held-out |Δ| from the card, and profile one DLRM and one DCN row's
   step (device ms, device operations, busy share);
29. time each kernel, its plain version and a PyTorch yardstick with CUDA
   events, compute each kernel's bound from this run's inputs, and print
   the ``kernels`` JSON line.  The grouped kernels are timed at a full
   26-table wave (K4) and batch (K1 in f32, K5) at 1 to 16 threads per
   (bag, table), beside the route each replaces (26 x (id split [+ mask
   copy] + per-table launch), stacked) and both routes' host enqueue time
   per call; K2 at 1, 2, 4 and 8 examples per block, beside the route it
   replaces (cat + K2 + cat); K3 at its three shapes beside its bound,
   plain version and the two-``F.embedding_bag`` yardstick, with its
   sweep of threads per bag for wide rows (8, 16, 32); and K1's per-table
   entry at the kernel bench's D=128 on int32 ids, int64 ids read in place
   and int64 ids cast first; grouped K4 at the planned wave of 13; and
   K1 at TinyLlama's, DeepSeek-V2's, Mamba2's, Qwen3's, seamless-m4t's,
   llava-next's and granite's prefill (8,192 ids) and decode (16 ids)
   shapes.

The phases print in the order above, but what waits on nothing before
it starts early and runs beside them, so the smoke stays well inside its
time limit: [sweep] (15) and [paper] (28) run in a process of their own
(``rows_worker``), started with [dist] and printed where [paper] stands;
the launchers of [dist], [serve_dist] and [lm], [analysis]'s injected run
and the dry run's processes (27: the CPU alone, the lowest priority)
start with [dist] too; and in [dist] and [fsdp], world (a) runs beside
world (b).  The phases before [dist] and from [lm] on run alone.  Each is read, and its exit code
checked, at its phase; a time taken beside other work says so.

Each of the paths in 8 to 28 runs with every launch count set to 0
just before it and read just after (in 18, in each rank's process: the
``kernels`` line sums the ranks; in 28, in the worker's process); launches made to compare a kernel
with its plain version count nowhere.  Peak device memory is printed as
the process's peak and as the peak above what the phase found allocated
(earlier phases keep their check inputs for the timing phase).

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# cuBLAS reads this when it makes its first handle: [train]'s restart check
# runs with torch.use_deterministic_algorithms(True), which needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the gloo worlds (and the launchers' and the analyzer's, which inherit this)
# bind the loopback device by name, so no world waits on a lookup of the
# host's own name
os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and f32 outside
# the tensor cores — every kernel here does f32 arithmetic on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Tolerances, kernel vs plain version on the same card inputs:
#   f32 / int8 outputs: 1e-5 — both sum in f32, in another order (the
#   plain version's reductions, the kernel's sequential l loop and FMAs);
#   bf16 outputs: 3e-2 — the single final rounding to bf16 can land one
#   bf16 step apart when the f32 sums differ in their last bit.
TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}
# engine scores and held-out logits / loss, kernels vs plain path: f32
# summation order through the pooling, the interaction and two MLPs
SCORE_TOL = 1e-4
# the f32-accumulation audit (reference tests/test_kernels.py:84-107): a bf16
# bag at L=16, D=128 within rtol 5e-3 of an f32 oracle
AUDIT_RTOL = 5e-3

B, L, D, F = 256, 4, 16, 27
BIG_TABLE = 10131227            # the largest Kaggle table
BAG_BANDWIDTH = (16384, 32)     # K3's bandwidth shape: bags x slots
# the (shape, table dtype, op) cases K3 is timed at
BAG_CASES = (("bench", "f32", "mult"), ("bench", "f32", "add"), ("serving", "f32", "add"),
             ("serving", "f32", "mult"), ("serving", "bf16", "add"),
             ("bandwidth", "f32", "add"), ("bandwidth", "f32", "mult"))
EVAL_STEPS = range(10_000, 10_012)
TRAIN_STEPS = 200               # Adagrad steps through Trainer at full width
K6_BATCH = 65_536               # [K6]: the training cell's batch
TRAIN_TIMED = (5, 30)           # [train]'s timing: warm-up steps, then timed steps
# one full-width step's loss and gradients, card vs CPU on the same
# parameters and batch: f32 sums in another order through two MLPs (cuBLAS
# vs the CPU's GEMMs), the interaction and the index backward (atomics on
# the card); each leaf's max |diff| within GRAD_TOL of its largest |g|
GRAD_TOL = 1e-4
# [paper]: rows of paper_tables trained on the card at 400 steps (fig4's six
# and one of each other kind); each row's first PAPER_CPU_STEPS steps on the
# machine's CPU, with the card's step from each of those states on the same
# batch: loss within rtol PAPER_CPU_RTOL, gradients within GRAD_TOL of each
# leaf's largest |g| (free-running trajectories split within these steps:
# the first Adagrad / Adam step is -lr·g/(|g|+eps), so an element whose g is
# roundoff-sized moves by up to 2·lr either way, and a loss of ~20 after it
# turns that into 7e-5 relative by step 2 in feature mode); the row also
# trained 400 steps on the machine's CPU; the rows profiled
PAPER_ROWS = ("fig4/dlrm/full", "fig4/dlrm/hash", "fig4/dlrm/qr_mult", "fig4/dcn/full",
              "fig4/dcn/hash", "fig4/dcn/qr_mult", "fig5/dlrm/add/c4", "fig5/dlrm/concat/c4",
              "fig5/dlrm/feature/c4", "fig6/dlrm/qr_mult/thr2000", "table1/dlrm/path/h16")
PAPER_CPU_STEPS = 5
PAPER_CPU_RTOL = 1e-5
PAPER_FULL_CPU = "fig4/dlrm/qr_mult"
PAPER_PROFILED = ("fig4/dlrm/qr_mult", "fig4/dcn/qr_mult")


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# Work that need not wait for the phase that reads it: subprocesses started
# early, which run beside the phases in between, each in a session of its
# own (so its own children end with it), its output in files under
# build/background/; the phase reads the output and checks the exit code.
BACKGROUND_DIR = os.path.join(ROOT, "build", "background")


class _Background:
    def __init__(self):
        self.jobs = {}

    def start(self, name, cmd, env=None, nice=0):
        """Start ``cmd`` as job ``name``; ``nice`` lowers its priority, so it
        takes only the cores the phases leave idle."""
        import threading

        os.makedirs(BACKGROUND_DIR, exist_ok=True)
        out = open(os.path.join(BACKGROUND_DIR, f"{name}.out"), "w+")
        err = open(os.path.join(BACKGROUND_DIR, f"{name}.err"), "w+")
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=out,
                                stderr=err, start_new_session=True)
        if nice:
            os.setpriority(os.PRIO_PROCESS, proc.pid, nice)
        job = {"proc": proc, "out": out, "err": err, "t0": time.perf_counter(), "end": None}

        def watch():
            proc.wait()
            job["end"] = time.perf_counter()

        threading.Thread(target=watch, daemon=True).start()
        self.jobs[name] = job

    def wait(self, name, timeout):
        """Wait for job ``name``, at most ``timeout`` seconds after its start;
        returns (the completed process, its seconds from start to exit)."""
        job = self.jobs.pop(name)
        proc = job["proc"]
        try:
            proc.wait(timeout=max(timeout - (time.perf_counter() - job["t0"]), 1.0))
        except subprocess.TimeoutExpired:
            self._kill(proc)
            _fail(f"{name} ran past {timeout} s")
        end = job["end"] or time.perf_counter()
        texts = []
        for f in (job["out"], job["err"]):
            f.seek(0)
            texts.append(f.read())
            f.close()
        return subprocess.CompletedProcess(proc.args, proc.returncode, *texts), end - job["t0"]

    def settle(self, timeout):
        """Wait until every job has exited, at most ``timeout`` seconds after
        each one's start; the output of those that exited 0 stays to be
        read, one that did not fails the smoke now."""
        for name, job in list(self.jobs.items()):
            try:
                job["proc"].wait(timeout=max(timeout - (time.perf_counter() - job["t0"]), 1.0))
            except subprocess.TimeoutExpired:
                self._kill(job["proc"])
                _fail(f"{name} ran past {timeout} s")
            if job["proc"].returncode != 0:
                proc, _ = self.wait(name, timeout)
                sys.stdout.write(proc.stdout)
                _fail(f"{name} exited {proc.returncode}: {proc.stderr[-2000:]}")

    @staticmethod
    def _kill(proc):
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, 9)
            except ProcessLookupError:
                pass
        proc.wait()

    def stop(self):
        """End every job still running (the smoke stops, or failed)."""
        for job in self.jobs.values():
            self._kill(job["proc"])
        self.jobs.clear()


BACKGROUND = _Background()


def _smoke_cmd(fn: str, *args) -> list:
    """The command that runs ``chip_smoke.<fn>(*args)`` in a process of its
    own; its return value is the exit code."""
    return [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.{fn}(*{args!r}))"]


def _beside(fn, *args):
    """Run ``fn(*args)`` in a thread beside the caller (a spawned world
    waits there, its processes run on their own); returns a future whose
    ``result()`` is ``fn``'s seconds, or raises what ``fn`` raised."""
    from concurrent.futures import ThreadPoolExecutor

    def timed():
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(timed)
    pool.shutdown(wait=False)
    return fut


def _time_ms(torch, fn, iters: int) -> float:
    """Device time of one ``fn()`` call (``repro_torch.benchmarks.timing``)."""
    from repro_torch.benchmarks.timing import device_ms

    return device_ms(fn, iters)


def _print_registers(source: str, log: str) -> None:
    """The compiler's ``-Xptxas -v`` report of one build: each kernel's
    registers (and spills, if any) on one line, by demangled name."""
    entries, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)):
            spill = f", {m.group(1)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries.append((name, m.group(1), spill))
            name = None
        if "error" in line.lower():
            print(f"  {source}: {line.strip()}")
    if not entries:
        return
    try:
        names = subprocess.run(["c++filt"], input="\n".join(e[0] for e in entries),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:           # no demangler on the machine: the mangled names
        names = [e[0] for e in entries]
    shown = sorted((re.sub(r"^void |\(anonymous namespace\)::|\(.*\)$", "", n), regs, spill)
                   for n, (_, regs, spill) in zip(names, entries))
    print(f"  {source}, registers per kernel: "
          + "; ".join(f"{n} {regs}{spill}" for n, regs, spill in shown))


def _short_name(kernel: str) -> str:
    """A readable name for a device event: the PyTorch functor or kernel
    template it runs, else its first identifier followed by ``<`` or ``(``,
    else its first 60 characters."""
    name = kernel.replace("(anonymous namespace)", "")
    for pat in (r"\w+_kernel_cuda", r"\w*Functor_?\w*", r"Memcpy \w+",
                r"\w+_kernel<[^>(]*>", r"\w+(?=<|\()"):
        m = re.search(pat, name)
        if m:
            return m.group(0)[:60]
    return name[:60]


def _max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def _zipf_ids(torch, gen, shape, size):
    u = torch.rand(shape, generator=gen, device="cuda")
    return torch.clamp(torch.floor(u ** 1.5 * size), max=size - 1).to(torch.int32)


def _kernels():
    """Every kernel wrapper of the port by its kernel's name; each carries
    its launch count."""
    from repro_torch.kernels import launch_counters

    return launch_counters()


def _zero_counts():
    for fn in _kernels().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _kernels().items()}


def _check_counts(path, counts, expected):
    """Fail unless the path launched exactly ``expected`` of each kernel
    (kernels it does not name: none)."""
    want = {name: expected.get(name, 0) for name in counts}
    shown = ", ".join(f"{k} {v}" for k, v in counts.items() if v or want[k])
    print(f"  launches ({path}): {shown}")
    if counts != want:
        _fail(f"{path}: launch counts {counts}, expected {want}")


def _qr_pair(torch, gen, size, d, rows_scale=0.05):
    """A random f32 QR pair (c=4) for a table of ``size`` categories."""
    m = -(-size // 4)
    w_rem = torch.randn((m, d), generator=gen, device="cuda") * rows_scale
    w_quo = torch.randn((-(-size // m), d), generator=gen, device="cuda") * rows_scale
    return m, w_rem, w_quo


def check_serve_pool(torch, gen):
    """K4 against its plain version; returns (max abs error, timing inputs)."""
    from repro_torch.kernels import ref, serve_path
    from repro_torch.serve.quantize import quantize_table

    size = 10131227                 # the largest Kaggle table, QR c=4
    m = -(-size // 4)
    q_rows = -(-size // m)
    w_rem = torch.randn((m, D), generator=gen, device="cuda") * 0.05
    w_quo = torch.randn((q_rows, D), generator=gen, device="cuda") * 0.05
    qa, qb = quantize_table(w_rem), quantize_table(w_quo)
    ids = _zipf_ids(torch, gen, (B, L), size)
    mask = (torch.rand((B, L), generator=gen, device="cuda") > 0.2).float()
    mask[B - 8:] = 0.0                                   # empty bags
    rem, quo = ids % m, ids // m
    proj = torch.randn((D, D), generator=gen, device="cuda") * 0.25
    narrow = torch.randn((D // 2, D), generator=gen, device="cuda") * 0.25
    cases = {
        "int8 pair": ("int8", (rem, mask, qa["q"], quo, qb["q"], qa["scale"], qa["zp"],
                               qb["scale"], qb["zp"]), {}),
        "int8 pair add": ("int8", (rem, mask, qa["q"], quo, qb["q"], qa["scale"],
                                   qa["zp"], qb["scale"], qb["zp"]), {"op": "add"}),
        "int8 pair + proj": ("int8", (rem, mask, qa["q"], quo, qb["q"], qa["scale"],
                                      qa["zp"], qb["scale"], qb["zp"], proj), {}),
        "f32 pair": ("f32", (rem, mask, w_rem, quo, w_quo), {}),
        "bf16 pair": ("bf16", (rem, mask, w_rem.bfloat16(), quo, w_quo.bfloat16()), {}),
        "bf16 pair + proj": ("bf16", (rem, mask, w_rem.bfloat16(), quo, w_quo.bfloat16(),
                                     None, None, None, None, proj), {}),
        "f32 single": ("f32", (rem, mask, w_rem), {}),
        "f32 single d=8 + proj": ("f32", (rem, mask, w_rem[:, :D // 2].contiguous(), None,
                                          None, None, None, None, None, narrow), {}),
        "int8 pair L=0": ("int8", (rem[:, :0], mask[:, :0], qa["q"], quo[:, :0], qb["q"],
                                   qa["scale"], qa["zp"], qb["scale"], qb["zp"]), {}),
    }
    worst = 0.0
    for name, (kind, args, kw) in cases.items():
        got = serve_path.fused_serve_pool(*args, **kw)
        want = ref.fused_serve_pool(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            _fail(f"K4 {name}: {tuple(got.shape)} {got.dtype} vs plain "
                  f"{tuple(want.shape)} {want.dtype}")
        err = _max_err(torch, got, want)
        tol = TOL[kind] * (1.0 + float(want.float().abs().max()))
        empty_ok = bool((got[B - 8:] == 0).all())
        print(f"  K4 {name:24s} max|err| {err:.3e} (tol {tol:.1e}) empty bags zero: {empty_ok}")
        if not err <= tol or not empty_ok or not torch.isfinite(got.float()).all():
            _fail(f"K4 {name} disagrees with its plain version")
        worst = max(worst, err)
    return worst, (rem, quo, mask, qa, qb, w_rem)


def check_interaction(torch, gen):
    """K2 against its plain versions (see phase 4); returns the worst error
    and the main shape's f32 inputs ``(x, z, feats)``."""
    from repro_torch.kernels import dot_interaction, ref

    worst, main = 0.0, None
    for b, f, d in ((B, F, D), (1, 2, 24), (B + 1, 2, 128), (B + 1, 33, 24), (1, 33, 128)):
        x32 = torch.randn((b, f, d), generator=gen, device="cuda")
        for kind, x in (("f32", x32), ("bf16", x32.bfloat16())):
            xt = x.transpose(1, 2).contiguous().transpose(1, 2)   # last dim strided
            layouts = (("contiguous", x[:, 0].contiguous(), x[:, 1:].contiguous()),
                       ("views", x[:, 0], x[:, 1:]), ("transposed", xt[:, 0], xt[:, 1:]))
            for layout, z, feats in layouts:
                got = dot_interaction.dot_interaction_concat(z, feats)
                worst = max(worst, _hold(torch, f"K2 {kind} B={b} F={f} D={d} {layout}", kind,
                                         got, ref.dot_interaction_concat(z, feats)))
                if not torch.equal(got[:, :d], z):
                    _fail(f"K2 {kind} B={b} F={f} D={d} {layout}: z columns not copied exactly")
            worst = max(worst, _hold(torch, f"K2 {kind} B={b} F={f} D={d} stacked x", kind,
                                     dot_interaction.dot_interaction(x), ref.dot_interaction(x)))
        if (b, f, d) == (B, F, D):
            main = (x32, x32[:, 0].contiguous(), x32[:, 1:].contiguous())
    return worst, main


def _hold(torch, name, kind, got, want):
    """Fail unless ``got`` matches ``want`` in shape, dtype and value."""
    if got.shape != want.shape or got.dtype != want.dtype:
        _fail(f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    err = _max_err(torch, got, want)
    tol = TOL[kind] * (1.0 + float(want.float().abs().max()))
    print(f"  {name:40s} max|err| {err:.3e} (tol {tol:.1e})")
    if not err <= tol or not torch.isfinite(got.float()).all():
        _fail(f"{name} disagrees with its plain version")
    return err


def check_qr_gather(torch, gen):
    """K1 and K5 against their plain versions on the largest Kaggle table;
    returns the worst errors and the timing inputs."""
    from repro_torch.kernels import ops, qr_gather, ref
    from repro_torch.serve.quantize import quantize_table

    m, w_rem, w_quo = _qr_pair(torch, gen, BIG_TABLE, D)
    ids = _zipf_ids(torch, gen, (B,), BIG_TABLE)
    rem, quo = ids % m, ids // m
    k1 = 0.0
    for kind, (wr, wq) in (("f32", (w_rem, w_quo)), ("bf16", (w_rem.bfloat16(), w_quo.bfloat16()))):
        for op in ("mult", "add"):
            got = qr_gather.qr_gather(rem, quo, wr, wq, op=op)
            want = ref.qr_gather(rem, quo, wr, wq, op=op)
            torch.cuda.synchronize()
            k1 = max(k1, _hold(torch, f"K1 {kind} {op} N={B}", kind, got, want))
    ids3 = _zipf_ids(torch, gen, (4, 8, 8), BIG_TABLE)
    _zero_counts()
    got = ops.qr_lookup(ids3, w_rem, w_quo)
    _check_counts("ops.qr_lookup, 3-D idx", _read_counts(), {"qr_gather": 1})
    k1 = max(k1, _hold(torch, "K1 3-D idx via ops.qr_lookup", "f32", got,
                       ops.qr_lookup(ids3, w_rem, w_quo, use_kernel=False)))

    qa, qb = quantize_table(w_rem), quantize_table(w_quo)
    quant_args = (rem, quo, qa["q"], qb["q"], qa["scale"], qa["zp"], qb["scale"], qb["zp"])
    k5 = 0.0
    for op in ("mult", "add"):
        got = qr_gather.qr_gather_quant(*quant_args, op=op)
        want = ref.qr_gather_quant(*quant_args, op=op)
        torch.cuda.synchronize()
        k5 = max(k5, _hold(torch, f"K5 int8 {op} N={B}", "int8", got, want))
    return k1, k5, (m, rem, quo, w_rem, w_quo, quant_args)


def _kaggle_ids(torch, gen, sizes, length):
    """``(B, T, L)`` raw Zipf ids, table t's drawn in ``[0, size_t)``, with
    ``0``, ``m_t - 1``, ``m_t`` and ``size_t - 1`` (``m_t = ceil(size_t / 4)``)
    in the first slot of the first four bags."""
    ids = torch.stack([_zipf_ids(torch, gen, (B, length), s) for s in sizes], dim=1)
    for t, size in enumerate(sizes):
        m = -(-size // 4)
        for k, v in enumerate((0, m - 1, min(m, size - 1), size - 1)):
            ids[k, t, 0] = v
    return ids


def check_grouped(torch, gen):
    """Grouped K4, K5 and K1 at full width (the 26 Kaggle tables as QR
    pairs, c=4, D=16) against their plain versions and against 26 per-table
    launches; returns the errors and the timing inputs."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.kernels import qr_gather, ref, serve_path
    from repro_torch.serve.quantize import quantize_table

    sizes = dlrm_criteo.config(reduced=False).table_sizes
    pairs = [_qr_pair(torch, gen, size, D) for size in sizes]
    quant = [(quantize_table(w_rem), quantize_table(w_quo)) for _, w_rem, w_quo in pairs]

    def group(kind, op="mult"):
        if kind == "int8":
            return [ref.GroupTable(qa["q"], qb["q"], qa["scale"], qa["zp"], qb["scale"],
                                   qb["zp"], m, op) for (m, _, _), (qa, qb) in zip(pairs, quant)]
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return [ref.GroupTable(a.to(dt), b.to(dt), m=m, op=op) for m, a, b in pairs]

    idx = _kaggle_ids(torch, gen, sizes, L)
    mask = (torch.rand(idx.shape, generator=gen, device="cuda") > 0.2).float()
    mask[:4, :, 0] = 1.0                                  # the edge ids are live
    mask[B - 8:] = 0.0                                    # requests with every bag empty
    mask[torch.rand((B, len(sizes)), generator=gen, device="cuda") < 0.1] = 0.0  # empty bags

    def per_table_k4(tables, ids, weights):
        return torch.stack([serve_path.fused_serve_pool(
            ids[:, t] % tab.m, weights[:, t], tab.w_a, ids[:, t] // tab.m, tab.w_b, tab.scale_a,
            tab.zp_a, tab.scale_b, tab.zp_b, op=tab.op) for t, tab in enumerate(tables)], dim=1)

    k4_err = k4_diff = 0.0
    cases = [("int8 mult", "int8", group("int8"), idx, mask),
             ("int8 add", "int8", group("int8", "add"), idx, mask),
             ("f32 mult", "f32", group("f32"), idx, mask),
             ("bf16 mult", "bf16", group("bf16"), idx, mask),
             ("int8 mult L=0", "int8", group("int8"), idx[:, :, :0], mask[:, :, :0])]
    for name, kind, tables, ids, weights in cases:
        got = serve_path.fused_serve_pool_grouped(ids, weights, tables)
        want = ref.fused_serve_pool_grouped(ids, weights, tables)
        k4_err = max(k4_err, _hold(torch, f"grouped K4 {name} B={B} T={len(sizes)}", kind,
                                   got, want))
        diff = _max_err(torch, got, per_table_k4(tables, ids, weights))
        empty_ok = bool((got[B - 8:] == 0).all()) and bool((got[weights.sum(-1) == 0] == 0).all())
        print(f"    vs {len(sizes)} per-table launches: max |diff| {diff:.3e}; "
              f"empty bags zero: {empty_ok}")
        if diff != 0 or not empty_ok:
            _fail(f"grouped K4 {name} differs from per-table launches or an empty bag")
        k4_diff = max(k4_diff, diff)

    sparse = _kaggle_ids(torch, gen, sizes, 1)[:, :, 0]
    k5_err = k5_diff = 0.0
    for op in ("mult", "add"):
        tables = group("int8", op)
        got = qr_gather.qr_gather_quant_grouped(sparse, tables)
        want = ref.qr_gather_quant_grouped(sparse, tables)
        k5_err = max(k5_err, _hold(torch, f"grouped K5 int8 {op} B={B} T={len(sizes)}", "int8",
                                   got, want))
        per_table = torch.stack([qr_gather.qr_gather_quant(
            sparse[:, t] % tab.m, sparse[:, t] // tab.m, tab.w_a, tab.w_b, tab.scale_a, tab.zp_a,
            tab.scale_b, tab.zp_b, op=op) for t, tab in enumerate(tables)], dim=1)
        diff = _max_err(torch, got, per_table)
        print(f"    vs {len(sizes)} per-table launches: max |diff| {diff:.3e}")
        if diff != 0:
            _fail(f"grouped K5 {op} differs from per-table launches")
        k5_diff = max(k5_diff, diff)

    k1_err = k1_diff = 0.0
    for kind in ("f32", "bf16"):
        for op in ("mult", "add"):
            tables = group(kind, op)
            got = qr_gather.qr_gather_grouped(sparse, tables)
            k1_err = max(k1_err, _hold(torch, f"grouped K1 {kind} {op} B={B} T={len(sizes)}",
                                       kind, got, ref.qr_gather_grouped(sparse, tables)))
            per_table = torch.stack([qr_gather.qr_gather(
                sparse[:, t] % tab.m, sparse[:, t] // tab.m, tab.w_a, tab.w_b, op=op)
                for t, tab in enumerate(tables)], dim=1)
            diff = _max_err(torch, got, per_table)
            print(f"    vs {len(sizes)} per-table launches: max |diff| {diff:.3e}")
            if diff != 0:
                _fail(f"grouped K1 {kind} {op} differs from per-table launches")
            k1_diff = max(k1_diff, diff)
    errs = {"k4": k4_err, "k4_vs_per_table": k4_diff, "k5": k5_err, "k5_vs_per_table": k5_diff,
            "k1": k1_err, "k1_vs_per_table": k1_diff}
    return errs, (idx, mask, group("int8"), sparse, group("f32"))


def bag_shapes(torch, gen):
    """K3's three shapes as ``ops.qr_bag_lookup`` takes them (raw ids and a
    mask, a dense f32 QR pair): the reference kernel bench's
    (``benchmarks/kernels_bench.py:47-55``: B=32, L=8, m=2048, q=16, D=128,
    every slot on, int32 ids as ``jax.random.randint`` draws them);
    serving-like on the largest Kaggle table (QR c=4, B=256, L=4, D=16, Zipf
    ids with 0, m-1, m and size-1, fractional weights, empty bags); and the
    bandwidth shape (the same table's QR pair at D=128, 16,384 bags of
    L=32, uniform ids over every category, every slot on: its 1.3 GB
    remainder table is far above L2, so the rows come cold)."""
    bm, bq, bd = 2048, 16, 128
    bench = {"idx": torch.randint(0, bm * bq, (32, 8), generator=gen, device="cuda",
                                  dtype=torch.int32),
             "mask": torch.ones((32, 8), device="cuda"),
             "w_rem": torch.randn((bm, bd), generator=gen, device="cuda"),
             "w_quo": torch.randn((bq, bd), generator=gen, device="cuda")}
    m, w_rem, w_quo = _qr_pair(torch, gen, BIG_TABLE, D)
    idx = _zipf_ids(torch, gen, (B, L), BIG_TABLE)
    idx[:4, 0] = torch.tensor([0, m - 1, m, BIG_TABLE - 1], device="cuda")
    pick = torch.randint(0, 4, (B, L), generator=gen, device="cuda")
    mask = torch.tensor([0.0, 0.3, 1.0, 1.7], device="cuda")[pick]   # fractional weights
    mask[:4, 0] = 1.0                                                # the edge ids are live
    mask[B - 8:] = 0.0                                               # empty bags
    serving = {"idx": idx, "mask": mask, "w_rem": w_rem, "w_quo": w_quo}
    _, w_rem, w_quo = _qr_pair(torch, gen, BIG_TABLE, bd)
    wide = {"idx": torch.randint(0, BIG_TABLE, BAG_BANDWIDTH, generator=gen, device="cuda",
                                 dtype=torch.int32),
            "mask": torch.ones(BAG_BANDWIDTH, device="cuda"), "w_rem": w_rem, "w_quo": w_quo}
    return {"bench": bench, "serving": serving, "bandwidth": wide}


def _bag_case(shapes, shape, kind):
    """(raw ids, mask, w_rem, w_quo, m) of one K3 shape in f32 or bf16."""
    s = shapes[shape]
    wr, wq = s["w_rem"], s["w_quo"]
    if kind == "bf16":
        wr, wq = wr.bfloat16(), wq.bfloat16()
    return s["idx"], s["mask"], wr, wq, wr.shape[0]


def check_embedding_bag(torch, shapes):
    """K3 against its plain version at its three shapes (phase 7), the
    raw-id route against the pre-split entry, ids and mask as strided
    views, empty bags and L=0, the bf16 weight rounding, and the
    f32-accumulation audit; returns the worst error."""
    from repro_torch.kernels import embedding_bag, ops, ref

    worst = 0.0
    cases = [("serving", kind, op) for kind in ("f32", "bf16") for op in ("mult", "add")]
    cases += [(shape, "f32", op) for shape in ("bench", "bandwidth") for op in ("mult", "add")]
    for shape, kind, op in cases:
        idx, mask, wr, wq, m = _bag_case(shapes, shape, kind)
        b, length = idx.shape
        rem, quo = idx % m, idx // m
        got = ops.qr_bag_lookup(idx, mask, wr, wq, op=op)
        name = f"K3 {shape} {kind} {op} B={b} L={length} D={wr.shape[1]}"
        worst = max(worst, _hold(torch, name, kind, got,
                                 ref.qr_embedding_bag(rem, quo, mask, wr, wq, op=op)))
        if not torch.equal(got, embedding_bag.qr_embedding_bag(rem, quo, mask, wr, wq, op=op)):
            _fail(f"{name}: the raw-id route differs from the pre-split entry")
        empty = mask.sum(-1) == 0
        if not (got[empty] == 0).all():
            _fail(f"{name}: an empty bag is not exactly zero")
        if shape != "serving":
            continue
        # ids and mask as strided views of wider buffers, read in place
        wide_idx = torch.stack([idx, torch.zeros_like(idx)], dim=-1).reshape(b, 2 * length)
        wide_mask = torch.stack([mask, torch.ones_like(mask)], dim=-1).reshape(b, 2 * length)
        if not torch.equal(ops.qr_bag_lookup(wide_idx[:, ::2], wide_mask[:, ::2], wr, wq,
                                             op=op), got):
            _fail(f"{name}: strided ids and mask give other bits")
        none = ops.qr_bag_lookup(idx[:, :0], mask[:, :0], wr, wq, op=op)
        if none.shape != got.shape or not (none == 0).all():
            _fail(f"{name}: L=0 does not pool to zeros")
    torch.cuda.synchronize()
    print("  raw-id route bit-equal to the pre-split entry; strided views read in place; "
          "empty bags and L=0 exactly zero")

    # a bf16 table's weights round to bf16 (0.3 -> 0.30078125) before they
    # multiply: three slots of 0.3 on rows of 1.0 pool to 0.90234375, where
    # the f32 weight would give 0.8984375
    ones = torch.ones((4, 8), dtype=torch.bfloat16, device="cuda")
    zeros = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    third = torch.full((1, 3), 0.3, device="cuda")
    for got in (embedding_bag.qr_embedding_bag(zeros, zeros, third, ones, ones),
                ops.qr_bag_lookup(zeros, third, ones, ones)):
        if not (got.float() == 0.90234375).all():
            _fail(f"K3 bf16: weights not rounded to bf16 first ({got.float()[0, 0]:.8f})")
    print("  bf16 weights round before they multiply: 3 x 0.3 on rows of 1.0 -> 0.90234375")

    # the audit: positive rows, so a bf16 running sum's error compounds
    gen = torch.Generator(device="cuda").manual_seed(1)
    am, aq = 64, 8
    ar = (torch.randn((am, 128), generator=gen, device="cuda").abs() + 0.5).bfloat16()
    aw = (torch.randn((aq, 128), generator=gen, device="cuda").abs() + 0.5).bfloat16()
    aidx = torch.randint(0, am * aq, (8, 16), generator=gen, device="cuda", dtype=torch.int32)
    ones = torch.ones((8, 16), device="cuda")
    for op in ("mult", "add"):
        got = ops.qr_bag_lookup(aidx, ones, ar, aw, op=op)
        a, b = ar.float()[aidx % am], aw.float()[aidx // am]
        rows = a * b if op == "mult" else a + b
        oracle = rows.sum(dim=1)
        running = torch.zeros((8, 128), dtype=torch.bfloat16, device="cuda")
        for lane in range(16):
            running = running + rows[:, lane].bfloat16()
        rel = float(((got.float() - oracle).abs() / oracle.abs()).max())
        control = float(((running.float() - oracle).abs() / oracle.abs()).max())
        print(f"  K3 audit bf16 {op} B=8 L=16 D=128 max rel err {rel:.3e} (rtol {AUDIT_RTOL:.0e}; "
              f"a bf16 running sum: {control:.3e})")
        if not rel <= AUDIT_RTOL:
            _fail(f"K3 fails the f32-accumulation audit ({op})")
        if control <= AUDIT_RTOL:
            _fail(f"the audit does not reject a bf16 running sum ({op})")
    return worst


def _serve_requests(cfg):
    """The serving phases' stream: 256 warm-up and 2,048 launcher-style
    requests (Zipf ids, bags of 1..4, ~10% empty bags, now and then a
    request with no ids at all), drawn on the host from one seed."""
    import numpy as np

    from repro_torch.launch.serve import request_stream

    rng = np.random.default_rng(0)
    reqs = list(request_stream(rng, cfg.table_sizes, cfg.dense_dim, 2304, 4))
    for k, (_, bags) in enumerate(reqs):               # some empty bags
        for i in np.flatnonzero(rng.random(len(bags)) < 0.1):
            bags[i] = []
        if k % 500 == 7:
            reqs[k] = (reqs[k][0], [[] for _ in bags])  # a request with no ids at all
    return reqs[:256], reqs[256:]


def serve_full_width(torch):
    """Serve the full-width int8 DLRM-Criteo; returns the main path's launch
    counts, the engine and its requests."""
    import numpy as np

    from repro_torch.configs import dlrm_criteo
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import memory_report, quantize_params
    from repro_torch.serve.recsys import RecsysEngine

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    params = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    qparams = quantize_params(params, mode="int8")
    rep = memory_report(params, qparams)
    del params
    torch.cuda.synchronize()
    print(f"  init + quantize on the card: {time.perf_counter() - t:.2f} s; tables "
          f"{rep['f32_table_bytes']} B f32 -> {rep['quant_table_bytes']} B int8 "
          f"({rep['ratio']:.4f}x)")

    warm, main = _serve_requests(cfg)

    engine = RecsysEngine(cfg, qparams, max_batch=256, batching="continuous")
    for dense, bags in warm:
        engine.submit(dense, bags)
    engine.run_until_drained()
    engine.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    uids = [engine.submit(dense, bags) for dense, bags in main]
    done = engine.run_until_drained()
    counts = _read_counts()
    m = engine.metrics()
    peak = torch.cuda.max_memory_allocated()

    scores = np.array([done[u].score for u in uids], dtype=np.float64)
    if len(scores) != len(main) or not np.isfinite(scores).all():
        _fail("not every request was scored with a finite value")
    waves = m["waves"]
    print(f"  served {m['requests']} requests in {waves} waves | p50 {m['p50_ms']:.3f} ms "
          f"p99 {m['p99_ms']:.3f} ms qps {m['qps']:.1f} | peak memory {peak} B "
          f"({peak - base} B above the phase's start) | buckets {m['buckets']}")
    # the serving path: one grouped K4 over all tables and one K2 per wave
    _check_counts("serve", counts, {"fused_serve_pool": waves, "dot_interaction": waves})

    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    plain = RecsysEngine(plain_cfg, qparams, max_batch=256, batching="continuous")
    sample = list(range(0, len(main), 7))
    for k in sample:
        plain.submit(*main[k])
    pdone = plain.run_until_drained()
    diff = max(abs(pdone[j].score - scores[k]) for j, k in enumerate(sample))
    print(f"  kernels vs plain engine on {len(sample)} requests: max |score diff| "
          f"{diff:.3e} (tol {SCORE_TOL:.0e})")
    if not diff <= SCORE_TOL:
        _fail("kernel engine scores disagree with the plain engine")
    return counts, engine, main


def _profile_device(run):
    """``run()`` under ``torch.profiler``: its result, the device's
    microseconds by short kernel name (every kernel and copy), and the
    count of device operations by short name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # marker kernels first and last: the trace can miss the window's
        # first launch, and after large windows its last one
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        out = run()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()   # the last launch ends inside the window
    # device-side events only (kernels, copies): a CPU op's device time
    # would count its kernels twice
    on_device = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
                 and "spin_kernel" not in ev.key]
    dev, counts = {}, {}
    for ev in on_device:
        name = _short_name(ev.key)
        dev[name] = dev.get(name, 0.0) + ev.self_device_time_total
        counts[name] = counts.get(name, 0) + ev.count
    return out, dev, counts


def _cat_ops(counts, per):
    """Concatenation kernels (``torch.cat`` / ``torch.stack``) per unit of
    work."""
    return sum(n for name, n in counts.items() if name.startswith("CatArray")) / per


# device kernels of the per-table route that the grouped kernels remove: the
# id split (``%``, ``//``) and the mask-slice copies
_SPLIT_OR_COPY = re.compile(r"remainder|floor|div|copy", re.IGNORECASE)


def _split_or_copy(dev_us, per):
    """Device ms per unit of work of every split or copy kernel left
    (host-device transfers, ``Memcpy``, and ``torch.cat`` are not)."""
    return {name: us / per / 1e3 for name, us in dev_us.items()
            if _SPLIT_OR_COPY.search(name) and not name.startswith(("Memcpy", "CatArray"))}


def _top_ms(dev_us, per, k=8):
    """The ``k`` largest device times, in ms per unit of work."""
    return {name: us / per / 1e3 for name, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:k]}


def profile_waves(torch, engine, reqs):
    """Where a full wave's time goes: wall time per wave (no profiler),
    device time per wave (``torch.profiler``, every kernel and copy), and
    the host's time to pad one wave."""
    import numpy as np

    from repro_torch.serve.recsys import RecRequest

    def drain():
        engine.reset_metrics()
        for dense, bags in reqs:
            engine.submit(dense, bags)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        return time.perf_counter() - t, engine.metrics()["waves"]

    wall, waves = drain()
    (_, pwaves), dev, ops_by_name = _profile_device(drain)
    n_ops = sum(ops_by_name.values())
    wave = [RecRequest(k, np.asarray(d, np.float32), [list(b) for b in bags])
            for k, (d, bags) in enumerate(reqs[:engine.max_batch])]
    t = time.perf_counter()
    for _ in range(5):
        engine._pad_wave(wave)
    pad_ms = (time.perf_counter() - t) / 5 * 1e3
    out = {"requests": len(reqs), "waves": waves, "wall_ms_per_wave": wall / waves * 1e3,
           "device_ms_per_wave": sum(dev.values()) / pwaves / 1e3,
           "host_pad_ms_per_full_wave": pad_ms,
           "device_ops_per_wave": n_ops / pwaves, "cat_ops_per_wave": _cat_ops(ops_by_name, pwaves),
           "split_or_copy_ms_per_wave": _split_or_copy(dev, pwaves),
           "top_device_ms_per_wave": _top_ms(dev, pwaves)}
    out["device_busy_share"] = out["device_ms_per_wave"] / out["wall_ms_per_wave"]
    print(f"  per wave: wall {out['wall_ms_per_wave']:.3f} ms, device "
          f"{out['device_ms_per_wave']:.3f} ms (busy {out['device_busy_share']:.3f}), "
          f"host pad {pad_ms:.3f} ms, {out['device_ops_per_wave']:.1f} device operations "
          f"({out['cat_ops_per_wave']:.1f} concatenations), "
          f"split/copy kernels left: {out['split_or_copy_ms_per_wave'] or 'none'}")
    print(json.dumps({"wave_profile": out}))


# [cache]: the launcher's default rows (a full wave's unique keys exceed them,
# so admission is refused and the wave is served in-graph) and rows that
# hold the working set (a 64 MiB f32 slab at D=16)
CACHE_CAPACITIES = (4096, 1 << 20)
CACHE_STAGES = ("submit", "pad", "probe", "unique_lookup", "miss_rows", "put_many_flush",
                "slab", "embed", "dense", "gc")


def _serve_all(engine, reqs):
    """Every request through ``engine``; their scores in request order."""
    import numpy as np

    uids = [engine.submit(dense, bags) for dense, bags in reqs]
    done = engine.run_until_drained()
    return np.array([done[u].score for u in uids], dtype=np.float64)


def _time_stages(engine, acc):
    """Accumulate the host seconds of the engine's stages into ``acc`` while
    it serves, and of Python's garbage collector (``gc``, inside whichever
    stage it interrupts); returns the function that takes the timers off."""
    import gc

    started = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            acc["gc"] = acc.get("gc", 0.0) + time.perf_counter() - started.pop()
    gc.callbacks.append(on_gc)
    targets = [(engine, "submit", "submit"), (engine, "_pad_wave", "pad"),
               (engine, "_embed_device_fast", "probe"),
               (engine, "_embed_device", "exact"),
               (engine, "_compute_miss_rows", "miss_rows"), (engine, "_slab_fwd", "slab"),
               (engine, "_embed_fwd", "embed"), (engine, "_dense_fwd", "dense")]
    if engine.cache is not None:
        targets.append((engine.cache, "put_many", "put_many_flush"))
    for obj, name, key in targets:
        def timed(*args, _fn=getattr(obj, name), _key=key, **kwargs):
            t = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                acc[_key] = acc.get(_key, 0.0) + time.perf_counter() - t
        setattr(obj, name, timed)

    def untime():
        gc.callbacks.remove(on_gc)
        for obj, name, _ in targets:
            delattr(obj, name)
    return untime


def _host_ms_per_wave(acc, waves):
    """Host ms per wave by stage; ``submit`` is the requests' intake (the
    id checks), ``probe`` the speculative slot-map
    probe (its slab pool included), ``unique_lookup`` the exact path less
    what it calls (its ``np.unique`` and ``lookup_many``, the slot arrays),
    and ``embed`` the in-graph embed of a refused admission (the cache-off
    engine's whole embed stage)."""
    inner = sum(acc.get(k, 0.0) for k in ("miss_rows", "put_many_flush", "slab"))
    exact = acc.get("exact", 0.0)
    stages = dict(acc, unique_lookup=max(0.0, exact - inner - (acc.get("embed", 0.0)
                                                                if exact else 0.0)))
    return {k: stages.get(k, 0.0) / waves * 1e3 for k in CACHE_STAGES}


def _cache_counts(m):
    """Launches a cache run must show: one K2 per dense stage (a wave, plus
    a wave whose fast probe missed and was recomputed) and one grouped K4
    per wave the tables served (cache off, or admission refused)."""
    paths = m.get("cache_paths")
    if paths is None:
        return {"fused_serve_pool": m["waves"], "dot_interaction": m["waves"]}
    return {"fused_serve_pool": paths["ingraph"],
            "dot_interaction": m["waves"] + paths["probe_missed"]}


def _add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def _cache_lane(torch, cfg, params, reqs, cap, total, label, profile=True):
    """One engine (``cap`` rows of device cache, or none) over ``reqs``: a
    warm pass, then a timed pass with host stage timers, each with the
    launch counts zeroed just before and checked just after, then a
    profiled pass of the first 1,024 requests.  Returns the timed pass's
    scores, metrics and the lane's numbers."""
    from repro_torch.serve.cache import DeviceHotRowCache
    from repro_torch.serve.recsys import RecsysEngine

    cache = DeviceHotRowCache(capacity_rows=cap) if cap else None
    engine = RecsysEngine(cfg, params, max_batch=256, batching="continuous", cache=cache)
    _zero_counts()
    _serve_all(engine, reqs)
    counts = _read_counts()
    _check_counts(f"cache {label} warm", counts, _cache_counts(engine.metrics()))
    _add_counts(total, counts)
    engine.reset_metrics()
    acc = {}
    untime = _time_stages(engine, acc)
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    scores = _serve_all(engine, reqs)
    wall = time.perf_counter() - t
    counts = _read_counts()
    untime()
    m = engine.metrics()
    _check_counts(f"cache {label} timed", counts, _cache_counts(m))
    _add_counts(total, counts)
    out = {"capacity_rows": cap, "requests": len(reqs), "waves": m["waves"],
           "wall_ms_per_wave": wall / m["waves"] * 1e3, "p50_ms": m["p50_ms"],
           "p99_ms": m["p99_ms"], "qps": m["qps"], "buckets": m["buckets"],
           "host_ms_per_wave": _host_ms_per_wave(acc, m["waves"]),
           "paths": m.get("cache_paths"), "stats": m.get("cache"),
           "slab_bytes": sum(s.numel() * s.element_size() for s in cache._slabs.values())
           if cache is not None else 0}
    if profile:
        engine.reset_metrics()
        _zero_counts()
        (_, pm), dev, ops_by_name = _profile_device(
            lambda: (_serve_all(engine, reqs[:1024]), engine.metrics()))
        counts = _read_counts()
        _check_counts(f"cache {label} profiled", counts, _cache_counts(pm))
        _add_counts(total, counts)
        out["device_ms_per_wave"] = sum(dev.values()) / pm["waves"] / 1e3
        out["device_ops_per_wave"] = sum(ops_by_name.values()) / pm["waves"]
        out["top_device_ms_per_wave"] = _top_ms(dev, pm["waves"], k=5)
    return scores, m, out


def _lane_line(name, out):
    host = ", ".join(f"{k} {v:.3f}" for k, v in out["host_ms_per_wave"].items() if v)
    s = out["stats"]
    cache = "" if s is None else (
        f" | paths {out['paths']} | hits {s['hits']} misses {s['misses']} evictions "
        f"{s['evictions']} rejections {s['rejections']} (hit rate {s['hit_rate']:.3f}), slab "
        f"{out['slab_bytes']} B")
    dev = "" if "device_ms_per_wave" not in out else (
        f", device {out['device_ms_per_wave']:.3f} ms in {out['device_ops_per_wave']:.1f} "
        f"operations per wave")
    print(f"  {name}: {out['waves']} waves, wall {out['wall_ms_per_wave']:.3f} ms per wave"
          f"{dev} | p50 {out['p50_ms']:.3f} p99 {out['p99_ms']:.3f} ms qps {out['qps']:.1f}"
          f"{cache}\n    host ms per wave: {host}")


def _reduced_int8(torch, seed, **kw):
    """The reduced DLRM-Criteo (kernels on) with random int8 tables."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import quantize_params

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True, **kw), use_kernel=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, quantize_params(dlrm_init(cfg, gen, "cuda"), mode="int8")


def _hold_scores(name, got, want, tol=SCORE_TOL):
    import numpy as np

    diff = float(abs(got - want).max())
    print(f"  {name}: max |score diff| {diff:.3e} (tol {tol:.0e})")
    if not (np.isfinite(got).all() and diff <= tol):
        _fail(f"{name}: scores disagree")
    return diff


def cache_paths(torch, engine, reqs, card):
    """Serve from the hot-row cache on the card (phase 9 of the module
    docstring); returns the phase's launch counts."""
    import numpy as np

    from repro_torch.configs import dcn_criteo
    from repro_torch.launch.serve import request_stream
    from repro_torch.serve.cache import DeviceHotRowCache
    from repro_torch.serve.quantize import quantize_params
    from repro_torch.serve.recsys import RecsysEngine

    total = {name: 0 for name in _kernels()}
    cfg, params = engine.cfg, engine.params
    t0 = time.perf_counter()
    lanes = {}
    off, _, lanes["off"] = _cache_lane(torch, cfg, params, reqs, 0, total, "off")
    _lane_line("full width, cache off", lanes["off"])
    plain = RecsysEngine(dataclasses.replace(cfg, use_kernel=False), params, max_batch=256)
    sample = list(range(0, len(reqs), 7))
    plain_scores = _serve_all(plain, [reqs[k] for k in sample])
    del plain
    out = {"card": card, "full_width": lanes}
    for cap in CACHE_CAPACITIES:
        on, m, lanes[cap] = _cache_lane(torch, cfg, params, reqs, cap, total, f"{cap} rows")
        _lane_line(f"full width, {cap} rows", lanes[cap])
        lanes[cap]["max_abs_vs_off"] = _hold_scores(
            f"{cap} rows vs the cache-off kernel engine", on, off)
        lanes[cap]["max_abs_vs_plain"] = _hold_scores(
            f"{cap} rows vs the plain cache-off engine ({len(sample)} requests)",
            on[sample], plain_scores)
        if cap == CACHE_CAPACITIES[0] and not m["cache_paths"]["ingraph"]:
            _fail(f"{cap} rows: no wave was served in-graph")
        if cap == CACHE_CAPACITIES[-1] and not (
                m["cache"]["hit_rate"] > 0 and m["cache_paths"]["exact"] + m["cache_paths"]["fast"]):
            _fail(f"{cap} rows: no wave was served from the slab")
    slower = {cap: lanes[cap]["qps"] / lanes["off"]["qps"] for cap in CACHE_CAPACITIES}
    print(f"  QPS cache on / off at full width: {slower}")
    print(f"  ({time.perf_counter() - t0:.1f} s at full width)")

    # the reduced config's 77,339 canonical rows fit the slot map: the fast path
    rcfg, rparams = _reduced_int8(torch, 1)
    rreqs = list(request_stream(np.random.default_rng(1), rcfg.table_sizes, rcfg.dense_dim,
                                1024, 4))
    roff, _, out["reduced_off"] = _cache_lane(torch, rcfg, rparams, rreqs, 0, total,
                                              "reduced off", profile=False)
    ron, rm, out["reduced"] = _cache_lane(torch, rcfg, rparams, rreqs, 1 << 20, total,
                                          "reduced", profile=False)
    _lane_line("reduced, cache off", out["reduced_off"])
    _lane_line("reduced, 1 << 20 rows", out["reduced"])
    _hold_scores("reduced, fast path vs cache off", ron, roff)
    if not rm["cache_paths"]["fast"]:
        _fail("reduced config: no wave took the fast path")

    # a 2-row cache: every admission refused, every wave in-graph, the same bits
    tiny_reqs = rreqs[:512]
    toff = _serve_all(RecsysEngine(rcfg, rparams, max_batch=256), tiny_reqs)
    tiny = DeviceHotRowCache(capacity_rows=2)
    tengine = RecsysEngine(rcfg, rparams, max_batch=256, cache=tiny)
    _zero_counts()
    tscores = _serve_all(tengine, tiny_reqs)
    counts = _read_counts()
    tm = tengine.metrics()
    _check_counts("cache 2 rows", counts, _cache_counts(tm))
    _add_counts(total, counts)
    print(f"  2 rows: paths {tm['cache_paths']}, rejections {tm['cache']['rejections']}")
    _hold_scores("2 rows vs cache off", tscores, toff, tol=0.0)
    if not tm["cache"]["rejections"] or tm["cache_paths"]["ingraph"] != tm["waves"]:
        _fail("a 2-row cache did not refuse admission")

    # swap_plan c=4 -> c=2 on the same tables
    cfg2, params2 = _reduced_int8(torch, 2, num_collisions=2)
    scache = DeviceHotRowCache(capacity_rows=1 << 20)
    sengine = RecsysEngine(rcfg, rparams, max_batch=256, cache=scache)
    _serve_all(sengine, rreqs[:512])
    resident, version = len(scache), scache.residency_version
    swap = sengine.swap_plan(cfg2, params2)
    print(f"  swap_plan c=4 -> c=2: {swap} ({resident} rows resident before)")
    if swap["invalidated_rows"] != resident or swap["residency_version"] == version:
        _fail("swap_plan did not drop the old residency")
    sengine.reset_metrics()
    _zero_counts()
    after = _serve_all(sengine, rreqs[512:])
    counts = _read_counts()
    _check_counts("cache after swap_plan", counts, _cache_counts(sengine.metrics()))
    _add_counts(total, counts)
    fresh = RecsysEngine(cfg2, params2, max_batch=256, cache=DeviceHotRowCache(1 << 20))
    _hold_scores("after swap_plan vs a fresh engine on c=2", after,
                 _serve_all(fresh, rreqs[512:]))

    # the DCN from the cache (the DCN has no kernel route)
    dcfg = dcn_criteo.config(reduced=True)
    dparams = quantize_params(dcn_criteo.api(dcfg).init(
        torch.Generator(device="cuda").manual_seed(3)), mode="int8")
    _zero_counts()
    doff = _serve_all(RecsysEngine(dcfg, dparams, max_batch=256), rreqs[:512])
    dengine = RecsysEngine(dcfg, dparams, max_batch=256, cache=DeviceHotRowCache(1 << 20))
    _serve_all(dengine, rreqs[:512])
    don = _serve_all(dengine, rreqs[:512])
    _check_counts("cache DCN", _read_counts(), {})
    print(f"  DCN: paths {dengine.metrics()['cache_paths']}, hit rate "
          f"{dengine.metrics()['cache']['hit_rate']:.3f}")
    _hold_scores("DCN from the cache vs cache off", don, doff)
    out["tiny"], out["swap"] = {"paths": tm["cache_paths"], "stats": tm["cache"]}, swap
    out["qps_on_over_off"] = slower
    print(f"  card: {card}; [cache] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"cache_profile": out}, default=str))
    return total


def _score(api, params, batches):
    """The reference's held-out evaluation: ``loss_fn`` per batch, each
    loss and accuracy read back to the host."""
    losses, accs = [], []
    for batch in batches:
        loss, metrics = api.loss_fn(params, batch)
        losses.append(float(loss))
        accs.append(float(metrics["acc"]))
    return losses, accs


def _eval_run(torch, api, plain, params, batches, mode, lookup, per_batch, table_bytes, base):
    """One held-out scoring run of the full-width model, expecting
    ``per_batch`` launches of the ``lookup`` kernel per batch; returns its
    launch counts.  ``base``: device bytes allocated before the phase."""
    n = len(batches)
    _score(api, params, batches[:1])        # first call outside the window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t = time.perf_counter()
    losses, accs = _score(api, params, batches)
    wall = time.perf_counter() - t
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_counts(f"eval {mode}", counts, {lookup: per_batch * n, "dot_interaction": n})

    logit_diff = loss_diff = 0.0
    for batch, loss in zip(batches, losses):
        logits = api.predict(params, batch)
        if logits.shape != (B,) or not torch.isfinite(logits).all():
            _fail(f"eval {mode}: logits not finite of shape ({B},)")
        logit_diff = max(logit_diff, float((logits - plain.predict(params, batch)).abs().max()))
        loss_diff = max(loss_diff, abs(loss - float(plain.loss_fn(params, batch)[0])))
    print(f"  {mode}: kernels vs use_kernel=False on {n} batches: max |logit diff| "
          f"{logit_diff:.3e}, max |loss diff| {loss_diff:.3e} (tol {SCORE_TOL:.0e})")
    if not (logit_diff <= SCORE_TOL and loss_diff <= SCORE_TOL):
        _fail(f"eval {mode}: kernel logits or loss disagree with the plain route")

    _, dev, ops_by_name = _profile_device(lambda: _score(api, params, batches))
    n_ops = sum(ops_by_name.values())
    prof = {"mode": mode, "batches": n, "batch_size": B, "heldout_bce": sum(losses) / n,
            "heldout_acc": sum(accs) / n, "wall_ms_per_batch": wall / n * 1e3,
            "device_ms_per_batch": sum(dev.values()) / n / 1e3,
            "device_ops_per_batch": n_ops / n, "cat_ops_per_batch": _cat_ops(ops_by_name, n),
            "split_or_copy_ms_per_batch": _split_or_copy(dev, n),
            "table_bytes": table_bytes,
            "peak_memory_bytes": peak, "peak_above_phase_start_bytes": peak - base,
            "top_device_ms_per_batch": _top_ms(dev, n)}
    prof["device_busy_share"] = prof["device_ms_per_batch"] / prof["wall_ms_per_batch"]
    print(f"  {mode}: held-out BCE {prof['heldout_bce']:.5f} acc {prof['heldout_acc']:.5f} | "
          f"per batch: wall {prof['wall_ms_per_batch']:.3f} ms, device "
          f"{prof['device_ms_per_batch']:.3f} ms (busy {prof['device_busy_share']:.3f}), "
          f"{prof['device_ops_per_batch']:.1f} device operations "
          f"({prof['cat_ops_per_batch']:.1f} concatenations), split/copy kernels left: "
          f"{prof['split_or_copy_ms_per_batch'] or 'none'} | "
          f"tables {table_bytes} B | peak memory {peak} B ({peak - base} B above the "
          f"phase's start)")
    print(json.dumps({"eval_profile": prof}))
    return counts


def eval_full_width(torch):
    """Score the 12 held-out batches with the full-width one-hot
    DLRM-Criteo, f32 tables then int8; returns each run's launch counts."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.serve.quantize import quantize_params, table_bytes

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    api = dlrm_criteo.api(cfg)
    plain = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=False))
    shape = Shape("bench", 1, B, "train")        # the reference's paper_tables shape
    base = torch.cuda.memory_allocated()
    batches = [api.batch_fn(step, shape) for step in EVAL_STEPS]
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    # one-hot scoring: one grouped K1 (f32) or K5 (int8) and one K2 per batch
    counts = {"eval_f32": _eval_run(torch, api, plain, params, batches, "f32", "qr_gather",
                                    1, table_bytes(params), base)}
    qparams = quantize_params(params, mode="int8")
    del params                                   # the int8 run holds only int8 tables
    counts["eval_int8"] = _eval_run(torch, api, plain, qparams, batches, "int8",
                                    "qr_gather_quant", 1, table_bytes(qparams), base)
    return counts


def _grads_vs_cpu(torch, api_cpu, api_card, shape):
    """One full-width step's loss and gradients on the card against the CPU:
    parameters and a batch drawn on the CPU, copies moved to the card.
    Returns the loss difference and the worst leaf's max |diff| over its
    largest |g|."""
    from repro_torch import tree
    from repro_torch.train.loop import value_and_grad

    params = api_cpu.init(torch.Generator().manual_seed(7))
    batch = api_cpu.batch_fn(0, shape)
    (loss, _), grads = value_and_grad(api_cpu.loss_fn)(params, batch)
    on_card = tree.tree_map(lambda x: x.to("cuda"), params)
    del params
    (card_loss, _), card_grads = value_and_grad(api_card.loss_fn)(
        on_card, {k: v.to("cuda") for k, v in batch.items()})
    worst, where = 0.0, ""
    for (path, g), cg in zip(tree.flatten_with_path(grads), tree.leaves(card_grads)):
        scale = float(g.abs().max())
        rel = float((cg.cpu() - g).abs().max()) / scale if scale else float(cg.abs().max())
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    loss_diff = abs(float(card_loss) - float(loss))
    print(f"  one full-width step, card vs CPU: loss {float(card_loss):.7f} vs {float(loss):.7f} "
          f"(|diff| {loss_diff:.3e}); worst gradient leaf {where}: max |diff| {worst:.3e} of its "
          f"largest |g| (tol {GRAD_TOL:.0e})")
    if not (loss_diff <= GRAD_TOL * max(1.0, abs(float(loss))) and worst <= GRAD_TOL):
        _fail("a full-width step's loss or gradients on the card disagree with the CPU's")
    return loss_diff, worst


def _refusals_under_grad(torch):
    """Every CUDA wrapper, and a backward through ``use_kernel=True``,
    raises under grad mode with an operand that requires grad."""
    from repro_torch.kernels import dot_interaction, embedding_bag, qr_gather, ref, serve_path
    from repro_torch.serve.quantize import quantize_table

    w = torch.randn((12, D), device="cuda", requires_grad=True)
    wq = torch.randn((4, D), device="cuda")
    qa, qb = quantize_table(w.detach()), quantize_table(wq)
    scale = qa["scale"].clone().requires_grad_(True)
    quant = (qa["q"], qb["q"], scale, qa["zp"], qb["scale"], qb["zp"])
    rem = torch.zeros((5,), dtype=torch.int32, device="cuda")
    ids, mask = torch.zeros((5, 3), dtype=torch.int32, device="cuda"), torch.ones((5, 3),
                                                                                device="cuda")
    z, feats = torch.randn((5, D), device="cuda", requires_grad=True), torch.randn((5, 3, D),
                                                                                 device="cuda")
    calls = {
        "fused_serve_pool": lambda: serve_path.fused_serve_pool(ids, mask, w, ids, wq),
        "fused_serve_pool_grouped": lambda: serve_path.fused_serve_pool_grouped(
            ids[:, None], mask[:, None], [ref.GroupTable(w, wq, m=12)]),
        "qr_gather": lambda: qr_gather.qr_gather(rem, rem, w, wq),
        "qr_gather_grouped": lambda: qr_gather.qr_gather_grouped(
            ids[:, :1], [ref.GroupTable(w, wq, m=12)]),
        "qr_gather_quant": lambda: qr_gather.qr_gather_quant(rem, rem, *quant),
        "qr_gather_quant_grouped": lambda: qr_gather.qr_gather_quant_grouped(
            ids[:, :1], [ref.GroupTable(*quant, m=12)]),
        "qr_embedding_bag": lambda: embedding_bag.qr_embedding_bag(ids, ids, mask, w, wq),
        "qr_embedding_bag_raw": lambda: embedding_bag.qr_embedding_bag_raw(ids, mask, w, wq),
        "dot_interaction": lambda: dot_interaction.dot_interaction(
            torch.cat([z[:, None], feats], dim=1)),
        "dot_interaction_concat": lambda: dot_interaction.dot_interaction_concat(z, feats),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "requires grad" not in str(e):
                raise
        else:
            _fail(f"{name} returned an output with no graph for an operand that requires grad")
    print(f"  under grad mode, each of the {len(calls)} CUDA wrappers raises for an operand "
          "that requires grad")


def _restart_bitwise(torch):
    """[train]'s kill-and-restart at the reduced config with deterministic
    algorithms: a Trainer killed at step 15 and resumed from its step-10
    checkpoint (under ``build/``) ends with the same bits, and logs the same
    losses, as an uninterrupted run.  Returns the steps compared."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.train.loop import (SimulatedFailure, TrainConfig, Trainer, init_state,
                                        make_train_step)

    api = dlrm_criteo.api(dlrm_criteo.config(reduced=True))
    shape = Shape("train", 1, B, "train")
    kept = torch.are_deterministic_algorithms_enabled()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="smoke_restart_", dir=os.path.join(ROOT, "build"))
    torch.use_deterministic_algorithms(True)
    try:
        state0 = init_state(api.init(torch.Generator(device="cuda").manual_seed(1)),
                            api.optimizer)
        step = make_train_step(api.loss_fn, api.optimizer)
        tc = TrainConfig(num_steps=20, ckpt_every=10, ckpt_dir=ckdir, log_every=1)

        def batch_at(s):
            return api.batch_fn(s, shape)

        tr = Trainer(step, tc, batch_at=batch_at)
        try:
            tr.run(state0, fail_at_step=15)
            _fail("the injected failure did not stop the run")
        except SimulatedFailure:
            tr.checkpointer.wait()
        tr2 = Trainer(step, tc, batch_at=batch_at)
        resumed = tr2.resume_or(state0)
        if int(resumed["step"]) != 10:
            _fail(f"resumed at step {int(resumed['step'])}, expected 10")
        final_resumed, hist_resumed = tr2.run(resumed)
        final_direct, hist_direct = Trainer(step, TrainConfig(num_steps=20, log_every=1),
                                            batch_at=batch_at).run(state0)
    finally:
        torch.use_deterministic_algorithms(kept)
        shutil.rmtree(ckdir, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(final_resumed),
                                                 tree.leaves(final_direct)))
    same_losses = hist_resumed == [h for h in hist_direct if h[0] >= 10]
    print(f"  reduced config, killed at 15, resumed from 10: final state bit-equal {same}, "
          f"losses of steps 10-19 bit-equal {same_losses}")
    if not (same and same_losses):
        _fail("the restarted run does not replay the uninterrupted one bit for bit")
    return 20


def _ckpt_seconds(torch, state):
    """Seconds to save the full-width train state and to restore it onto
    the card, under ``build/``; the restored state must equal the saved one."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = ckpt.save(ckdir, int(state["step"]), state)
        save_s = time.perf_counter() - t
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t = time.perf_counter()
        restored, _ = ckpt.restore(ckdir, int(state["step"]), state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if not all(a.device == b.device and torch.equal(a, b)
               for a, b in zip(tree.leaves(restored), tree.leaves(state))):
        _fail("the restored checkpoint differs from the saved state")
    print(f"  checkpoint of the full train state ({nbytes} B): save {save_s:.3f} s, restore "
          f"onto the card {restore_s:.3f} s (sha256 verified), equal")
    return save_s, restore_s, nbytes


def check_qr_pairs_backward(torch, gen):
    """The [K6] phase: the QR pairs' backward at the training cell's shape
    (the 26 Kaggle tables as f32 QR pairs, c = 4, D = 16, B = 65,536, ids
    ``floor(S * u ** 1.5)``) against its plain version, bit-equal over two
    calls, one launch a call and no other kernel (the gradients within
    1e-5 of each table's largest of the plain version run in f64, beside
    the plain version's own f32 gap); then its time (the
    wrapper's whole call: the zero fill, the keys, the stable sort and the
    two passes) beside its bound, the plain version's, and, as the library
    yardstick, that of the same gradients through ``F.embedding``'s dense
    backward (two ``F.embedding`` + the multiply per pair, backward only).
    Returns the kernel's ``kernels`` fields, with ``counts`` (the checked
    calls' launch counts) and ``max_abs_err``."""
    import torch.nn.functional as tf

    from repro_torch.data.criteo import KAGGLE_TABLE_SIZES
    from repro_torch.kernels import qr_pairs_backward as k6
    from repro_torch.kernels import ref

    grads, rem, quo, tables = [], [], [], []
    for size in KAGGLE_TABLE_SIZES:
        m = -(-size // 4)
        tables += [torch.randn((m, D), generator=gen, device="cuda"),
                   torch.randn((-(-size // m), D), generator=gen, device="cuda")]
        ids = _zipf_ids(torch, gen, (K6_BATCH,), size).long()
        rem.append(ids % m)
        quo.append(ids // m)
        grads.append(torch.randn((K6_BATCH, D), generator=gen, device="cuda"))
    args = (grads, rem, quo, tables, ["mult"] * len(KAGGLE_TABLE_SIZES))
    _zero_counts()
    got = k6.qr_pairs_backward(*args)
    again = k6.qr_pairs_backward(*args)
    torch.cuda.synchronize()
    counts = _read_counts()
    _check_counts("K6", counts, {"qr_pairs_backward": 2})
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    exact = ref.qr_pairs_backward([g.double() for g in grads], rem, quo,
                                  [t.double() for t in tables], args[4])
    plain = ref.qr_pairs_backward(*args)

    def worst(xs):
        return max(float((x.double() - w).abs().max()) / float(w.abs().max())
                   for x, w in zip(xs, exact))

    err, plain_err = worst(got), worst(plain)
    print(f"  26 Kaggle QR pairs, B={K6_BATCH}, D={D} f32, against the plain version in f64: "
          f"K6's worst table {err:.3e} of its largest gradient (tol 1e-5), the plain version's "
          f"in f32 {plain_err:.3e}; two calls bit-equal {same}")
    if not (same and err <= 1e-5):
        _fail("K6 disagrees with its plain version, or with itself over two calls")
    del got, again, exact, plain
    leaves = [t.detach().requires_grad_(True) for t in tables]
    outs = [tf.embedding(rem[p], leaves[2 * p]) * tf.embedding(quo[p], leaves[2 * p + 1])
            for p in range(len(grads))]
    nbytes = k6._bound_bytes(*args)
    bound_ms, bound_by = _bound(nbytes, 4 * sum(g.numel() for g in grads))
    out = {"shape": f"26 Kaggle f32 QR pairs (c=4), B={K6_BATCH}, D={D}, ids floor(S*u^1.5)",
           "ms": _time_ms(torch, lambda: k6.qr_pairs_backward(*args), 20),
           "plain_ms": _time_ms(torch, lambda: ref.qr_pairs_backward(*args), 3),
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
           "yardstick": "F.embedding's dense backward: two F.embedding + the multiply per "
                        "pair, autograd.grad of the 26 outputs",
           "yardstick_ms": _time_ms(torch, lambda: torch.autograd.grad(
               outs, leaves, grads, retain_graph=True), 3),
           "counts": counts, "max_abs_err": err, "plain_f32_err": plain_err}
    print(f"  K6 {out['ms']:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}, {nbytes} B) | plain "
          f"{out['plain_ms']:.4f} ms | F.embedding's dense backward {out['yardstick_ms']:.4f} ms")
    return out


def train_full_width(torch, card):
    """The [train] phase: train the full-width DLRM-Criteo with the paper's
    Adagrad through ``Trainer``, hold one step's gradients against the CPU,
    time the step and the optimizer pass, checkpoint, score the trained
    tables through the kernels, check the refusals under grad and the
    bit-exact restart.  Returns the scoring runs' launch counts."""
    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.serve.quantize import quantize_params, table_bytes
    from repro_torch.train.loop import (TrainConfig, Trainer, init_state, make_train_step,
                                        value_and_grad)

    cfg = dlrm_criteo.config(reduced=False)          # use_kernel=False: training is plain
    api = dlrm_criteo.api(cfg)
    shape = Shape("train", 1, B, "train")
    grad_check = _grads_vs_cpu(torch, dlrm_criteo.api(cfg, device="cpu"), api, shape)

    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = init_state(api.init(torch.Generator(device="cuda").manual_seed(0)), api.optimizer)
    step_fn = make_train_step(api.loss_fn, api.optimizer)
    trainer = Trainer(step_fn, TrainConfig(num_steps=TRAIN_STEPS, log_every=1),
                      batch_at=lambda s: api.batch_fn(s, shape))
    state, history = trainer.run(state)
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in history]
    n_elems = sum(p.numel() for p in tree.leaves(state["params"]))
    tail = sum(losses[-10:]) / 10
    print(f"  {TRAIN_STEPS} Adagrad(1e-2) steps at B={B}, {n_elems} parameters "
          f"({table_bytes(state['params'])} B of f32 tables), in {run_s:.2f} s with init: loss "
          f"{losses[0]:.5f} at step 0, {tail:.5f} over the last 10 | peak memory {peak} B "
          f"({peak - base} B above the phase's start) | straggler events "
          f"{len(trainer.straggler_events)}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        _fail("training losses are not all finite")
    if not tail < losses[0]:
        _fail(f"the loss did not fall: last 10 steps {tail:.5f} vs step 0 {losses[0]:.5f}")

    # the step's wall time (host clock around step + synchronize, as Trainer
    # times it) and its device time, operations and top operations
    warm, timed = TRAIN_TIMED
    batches = [api.batch_fn(s, shape) for s in range(TRAIN_STEPS, TRAIN_STEPS + warm + timed)]
    walls = []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall_ms = sorted(walls[warm:])[timed // 2] * 1e3
    held = {"state": state}

    def steps():
        for batch in batches[:warm]:
            held["state"], _ = step_fn(held["state"], batch)

    _, dev, ops_by_name = _profile_device(steps)
    state = held["state"]
    device_ms = sum(dev.values()) / warm / 1e3

    # the optimizer pass alone on this step's gradients: Adagrad reads g,
    # acc and p and writes acc and p for every element of every leaf; and
    # the peak memory of the gradients and of the optimizer pass apart
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, grads = value_and_grad(api.loss_fn)(state["params"], batches[0])
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() - held_bytes
    torch.cuda.reset_peak_memory_stats()
    api.optimizer.update(grads, state["opt"], state["params"], state["step"])
    torch.cuda.synchronize()
    opt_peak = torch.cuda.max_memory_allocated() - held_bytes
    opt_ms = _time_ms(torch, lambda: api.optimizer.update(grads, state["opt"], state["params"],
                                                          state["step"]), 10)
    opt_bound_ms, opt_bound_by = _bound(5 * 4 * n_elems, 7 * n_elems)
    del grads
    prof = {"card": card, "steps": TRAIN_STEPS, "batch_size": B, "parameters": n_elems,
            "loss_step_0": losses[0], "loss_last_10": tail, "loss_every_10": losses[::10],
            "wall_ms_per_step_median": wall_ms, "device_ms_per_step": device_ms,
            "device_ops_per_step": sum(ops_by_name.values()) / warm,
            "device_busy_share": device_ms / wall_ms,
            "top_device_ms_per_step": _top_ms(dev, warm, k=10),
            "optimizer_ms": opt_ms, "optimizer_bound_ms": opt_bound_ms,
            "optimizer_bound_by": opt_bound_by, "optimizer_share_of_bound": opt_bound_ms / opt_ms,
            "peak_memory_bytes": peak, "peak_above_phase_start_bytes": peak - base,
            "state_bytes": held_bytes - base, "grads_peak_above_state_bytes": grad_peak,
            "optimizer_peak_above_state_bytes": opt_peak,
            "grad_check_loss_diff": grad_check[0], "grad_check_worst_rel": grad_check[1]}
    print(f"  card: {card}")
    print(f"  per step: wall {wall_ms:.3f} ms (median of {timed} after {warm} warm-up), device "
          f"{device_ms:.3f} ms (busy {prof['device_busy_share']:.3f}), "
          f"{prof['device_ops_per_step']:.1f} device operations; optimizer pass {opt_ms:.3f} ms, "
          f"bound {opt_bound_ms:.4f} ms ({opt_bound_by}, {5 * 4 * n_elems} B; "
          f"{prof['optimizer_share_of_bound']:.3f} of it)")
    print(f"  top device ms per step: {prof['top_device_ms_per_step']}")
    print(f"  memory: train state {held_bytes - base} B; peak above it: gradients {grad_peak} B, "
          f"the optimizer pass on them {opt_peak} B")
    prof["ckpt_save_s"], prof["ckpt_restore_s"], prof["ckpt_bytes"] = _ckpt_seconds(torch, state)

    # held-out scoring of the trained tables through the kernels, f32 (K1 +
    # K2 per batch) then int8 (K5 + K2)
    kcfg = dataclasses.replace(cfg, use_kernel=True)
    kapi, plain = dlrm_criteo.api(kcfg), dlrm_criteo.api(cfg)
    params = state["params"]
    del state, held, batches
    eval_batches = [kapi.batch_fn(step, shape) for step in EVAL_STEPS]
    counts = {"train_eval_f32": _eval_run(torch, kapi, plain, params, eval_batches,
                                          "trained f32", "qr_gather", 1, table_bytes(params),
                                          torch.cuda.memory_allocated())}
    qparams = quantize_params(params, mode="int8")
    del params
    counts["train_eval_int8"] = _eval_run(torch, kapi, plain, qparams, eval_batches,
                                          "trained int8", "qr_gather_quant", 1,
                                          table_bytes(qparams), torch.cuda.memory_allocated())
    del qparams
    _refusals_under_grad(torch)
    prof["restart_steps_bit_equal"] = _restart_bitwise(torch)
    print(json.dumps({"train_profile": prof}))
    return counts


# [plan]: full-width DLRM-Criteo solved under a byte budget over the width
# ladder {4, 8, 16}, as tools/plan_reference.py solved it with the JAX
# package (src/repro_torch/benchmarks/reference_plans.json)
PLAN_REFERENCE = os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_plans.json")
PLAN_CACHE_ROWS = 1 << 20
PLAN_TRAIN_STEPS = 100


def _tree_bytes(tree) -> int:
    from repro_torch import tree as ptree

    return sum(x.numel() * x.element_size() for x in ptree.leaves(tree))


def _solve_plan(torch):
    """Solve the full-width plan with the port (stats drawn on the CPU) and
    hold it to the JAX package's on the same stats: every field equal,
    qualities within 1e-12."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.plan import (MemoryPlan, dim_ladder, full_table_bytes, plan_for_config,
                                  plan_differences)

    with open(PLAN_REFERENCE) as f:
        ref = json.load(f)["full_width"]
    cfg = dlrm_criteo.config(reduced=False)
    budget = int(full_table_bytes(cfg.table_sizes, cfg.emb_dim) * ref["budget_frac"])
    t = time.perf_counter()
    plan = plan_for_config(cfg, budget, num_batches=ref["num_batches"],
                           batch_size=ref["batch_size"], dims=dim_ladder(cfg.emb_dim))
    solve_s = time.perf_counter() - t
    s = plan.summary()
    print(f"  solved in {solve_s:.2f} s (stats from {ref['num_batches']} CPU-drawn batches of "
          f"{ref['batch_size']}): kinds {s['kinds']}, widths {s['dims']}, {plan.total_bytes} B "
          f"f32 of a {budget} B budget ({s['budget_frac_of_full']:.4f}x full), quality "
          f"{plan.quality:.10f} vs uniform hashing {plan.baseline_quality:.10f}, parked "
          f"{s['parked']}")
    diffs = plan_differences(plan, MemoryPlan.from_json(json.dumps(ref["plan"])), 1e-12)
    if budget != ref["budget_bytes"] or diffs:
        _fail(f"the plan differs from the JAX package's on the same stats: {diffs[:5]}")
    print(f"  every field equals the JAX package's plan ({PLAN_REFERENCE[len(ROOT) + 1:]}), "
          "qualities within 1e-12")
    return plan, solve_s


def _plan_bytes(torch, plan, params, qparams):
    """Each table's built bytes against the plan, f32 and int8, and the
    uniform c=4 model's beside them."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.models.dlrm import tables_for
    from repro_torch.plan.candidates import module_tables
    from repro_torch.serve.quantize import row_bytes

    for i, t in enumerate(plan.tables):
        f32, int8 = _tree_bytes(params["tables"][i]), _tree_bytes(qparams["tables"][i])
        if (f32, int8) != (t.train_bytes, t.serve_bytes_int8):
            _fail(f"table {i} ({t.kind}, d={t.dim}): built {f32} B f32 / {int8} B int8, "
                  f"planned {t.train_bytes} / {t.serve_bytes_int8}")
    narrow = {str(i) for i, t in enumerate(plan.tables) if t.dim != plan.emb_dim}
    proj = params.get("proj", {})
    if set(proj) != narrow or any(tuple(proj[k].shape) != (plan.tables[int(k)].dim, plan.emb_dim)
                                  for k in proj):
        _fail("the planned model's projections do not match its narrow tables")
    uniform = tables_for(dlrm_criteo.config(reduced=False))
    u_f32 = sum(m.num_params * 4 for m in uniform)
    u_int8 = sum(r * row_bytes(w, "int8") for m in uniform for r, w in module_tables(m))
    out = {"planned_f32": sum(t.train_bytes for t in plan.tables),
           "planned_int8": sum(t.serve_bytes_int8 for t in plan.tables),
           "uniform_c4_f32": u_f32, "uniform_c4_int8": u_int8,
           "projections": len(proj), "projection_bytes": _tree_bytes(proj)}
    print(f"  built bytes equal the plan per table: {out['planned_f32']} B f32, "
          f"{out['planned_int8']} B int8 (uniform c=4: {u_f32} B f32, {u_int8} B int8); "
          f"{len(proj)} projections, {out['projection_bytes']} B f32")
    return out


def _plan_serve(torch, cfg, qparams, reqs, total):
    """Serve ``reqs`` through the planned model, kernels on: one grouped K4
    (18 projections, int8 rows of 4, 8 and 16 bytes) and one K2 per wave,
    scores within SCORE_TOL of the plain engine; then from a device cache
    of PLAN_CACHE_ROWS rows (a slab per width, the per-feature slab
    branch), scores within SCORE_TOL of cache off.  Returns the numbers."""
    from repro_torch.serve.cache import DeviceHotRowCache
    from repro_torch.serve.recsys import RecsysEngine

    engine = RecsysEngine(cfg, qparams, max_batch=256, batching="continuous")
    _serve_all(engine, reqs)                              # warm pass, outside the counts
    engine.reset_metrics()
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    off = _serve_all(engine, reqs)
    wall = time.perf_counter() - t
    counts = _read_counts()
    m = engine.metrics()
    _check_counts("plan serve", counts, {"fused_serve_pool": m["waves"],
                                         "dot_interaction": m["waves"]})
    _add_counts(total, counts)
    (_, pm), dev, ops_by_name = _profile_device(
        lambda: (engine.reset_metrics(), _serve_all(engine, reqs[:1024]), engine.metrics())[1:])
    out = {"requests": len(reqs), "waves": m["waves"], "wall_ms_per_wave": wall / m["waves"] * 1e3,
           "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"], "qps": m["qps"],
           "device_ms_per_wave": sum(dev.values()) / pm["waves"] / 1e3,
           "device_ops_per_wave": sum(ops_by_name.values()) / pm["waves"],
           "top_device_ms_per_wave": _top_ms(dev, pm["waves"], k=5)}
    out["device_busy_share"] = out["device_ms_per_wave"] / out["wall_ms_per_wave"]
    print(f"  cache off: {m['waves']} waves, wall {out['wall_ms_per_wave']:.3f} ms per wave, "
          f"device {out['device_ms_per_wave']:.3f} ms in {out['device_ops_per_wave']:.1f} "
          f"operations (busy {out['device_busy_share']:.3f}) | p50 {m['p50_ms']:.3f} p99 "
          f"{m['p99_ms']:.3f} ms qps {m['qps']:.1f}")
    plain = RecsysEngine(dataclasses.replace(cfg, use_kernel=False), qparams, max_batch=256)
    out["max_abs_vs_plain"] = _hold_scores("planned, kernels vs the plain engine",
                                           off, _serve_all(plain, reqs))
    del plain

    cache = DeviceHotRowCache(capacity_rows=PLAN_CACHE_ROWS)
    cengine = RecsysEngine(cfg, qparams, max_batch=256, batching="continuous", cache=cache)
    if cengine._uniform:
        _fail("the planned engine takes the one-gather slab branch, not the per-feature one")
    _serve_all(cengine, reqs)                             # warm pass: fills the cache
    cengine.reset_metrics()
    _zero_counts()
    t = time.perf_counter()
    on = _serve_all(cengine, reqs)
    cwall = time.perf_counter() - t
    counts = _read_counts()
    cm = cengine.metrics()
    _check_counts("plan cache", counts, _cache_counts(cm))
    _add_counts(total, counts)
    widths = sorted(cache._slabs)
    slab_bytes = {d: s.numel() * s.element_size() for d, s in cache._slabs.items()}
    out["cache"] = {"capacity_rows": PLAN_CACHE_ROWS, "waves": cm["waves"],
                    "wall_ms_per_wave": cwall / cm["waves"] * 1e3, "p50_ms": cm["p50_ms"],
                    "p99_ms": cm["p99_ms"], "qps": cm["qps"], "paths": cm["cache_paths"],
                    "stats": cm["cache"], "slab_widths": widths, "slab_bytes": slab_bytes}
    print(f"  {PLAN_CACHE_ROWS} rows: {cm['waves']} waves, wall "
          f"{out['cache']['wall_ms_per_wave']:.3f} ms per wave | p50 {cm['p50_ms']:.3f} p99 "
          f"{cm['p99_ms']:.3f} ms qps {cm['qps']:.1f} | paths {cm['cache_paths']} | hit rate "
          f"{cm['cache']['hit_rate']:.3f} | slabs by width {slab_bytes}")
    if widths != sorted(set(cfg.embedding.table_dims)):
        _fail(f"the cache holds slabs of widths {widths}, the plan's are "
              f"{sorted(set(cfg.embedding.table_dims))}")
    if not cm["cache_paths"]["exact"] + cm["cache_paths"]["fast"]:
        _fail("no planned wave was served from the slabs")
    out["cache"]["max_abs_vs_off"] = _hold_scores("planned, cache on vs cache off", on, off)
    return out


def _plan_wave(torch, cfg, qparams, reqs):
    """Grouped K4 at the planned model's wave: the 26 tables as the embed
    stage hands them to the kernel (int8 rows of 4, 8 and 16 bytes, 18
    projections to D=16) and a padded wave of 256 requests, held against
    its plain version and against 26 per-table launches of the same kernel
    (bit-equal).  Returns (max |err|, the wave's inputs for [time])."""
    import numpy as np

    from repro_torch.core import CompositionalEmbedding, HashEmbedding
    from repro_torch.kernels import ops, ref, serve_path
    from repro_torch.models.dlrm import tables_for
    from repro_torch.serve.recsys import RecRequest, RecsysEngine

    proj = qparams.get("proj", {})
    group = []
    for i, (mod, tp) in enumerate(zip(tables_for(cfg), qparams["tables"])):
        if isinstance(mod, CompositionalEmbedding):
            if len(mod.partitions) != 2:
                _fail(f"planned table {i} has {len(mod.partitions)} partitions: the grouped "
                      "K4 takes full and hash tables and QR pairs")
            group.append(ops._group_table(tp["table_0"], tp["table_1"], 0, mod.op,
                                          proj.get(str(i))))
        else:
            m = mod.m if isinstance(mod, HashEmbedding) else 0
            group.append(ops._group_table(tp["table"], None, m, "mult", proj.get(str(i))))
    wave = [RecRequest(k, np.asarray(d, np.float32), [list(b) for b in bags])
            for k, (d, bags) in enumerate(reqs[:B])]
    _, idx, mask = RecsysEngine(cfg, qparams, max_batch=B)._pad_wave(wave)
    idx, mask = torch.from_numpy(idx).to("cuda"), torch.from_numpy(mask).to("cuda")
    got = serve_path.fused_serve_pool_grouped(idx, mask, group)
    err = _max_err(torch, got, ref.fused_serve_pool_grouped(idx, mask, group))
    for t, tab in enumerate(group):
        ia, ib = ref._split_ids(idx[:, t], tab)
        one = serve_path.fused_serve_pool(ia, mask[:, t], tab.w_a, ib, tab.w_b, tab.scale_a,
                                          tab.zp_a, tab.scale_b, tab.zp_b, tab.proj, op=tab.op)
        if not torch.equal(one, got[:, t]):
            _fail(f"planned wave: grouped K4 differs from the per-table launch on table {t}")
    widths = sorted({tab.w_a.shape[1] for tab in group})
    print(f"  grouped K4 at the planned wave (B={B}, L={idx.shape[2]}, int8 rows of widths "
          f"{widths}, {sum(tab.proj is not None for tab in group)} projections): max |err| vs "
          f"plain {err:.3e} (tol {TOL['f32']:.0e}), bit-equal to {len(group)} per-table launches")
    if not err <= TOL["f32"]:
        _fail("grouped K4 at the planned wave disagrees with its plain version")
    return err, (idx, mask, group)


def plan_full_width(torch, engine, reqs, card):
    """The [plan] phase: solve, build, serve (kernels, then the cache),
    score one-hot, train and swap a live uniform engine onto the planned
    model; returns the phase's launch counts, and grouped K4's error and
    inputs at the planned wave."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import quantize_params, table_bytes
    from repro_torch.serve.recsys import RecsysEngine
    from repro_torch.train.loop import TrainConfig, Trainer, init_state, make_train_step

    t0 = time.perf_counter()
    total = {name: 0 for name in _kernels()}
    plan, solve_s = _solve_plan(torch)
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False, plan=plan), use_kernel=True)
    params = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    qparams = quantize_params(params, mode="int8")
    out = {"card": card, "solve_s": solve_s, "kinds": plan.summary()["kinds"],
           "widths": plan.summary()["dims"], "bytes": _plan_bytes(torch, plan, params, qparams)}
    out["k4_err"], wave = _plan_wave(torch, cfg, qparams, reqs)

    out["serve"] = _plan_serve(torch, cfg, qparams, reqs, total)

    # one-hot scoring: the QR pairs through K1 (f32) or K5 (int8), one
    # launch each, the full tables through plain gathers and projections
    api = dlrm_criteo.api(cfg)
    plain = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=False))
    shape = Shape("bench", 1, B, "train")
    batches = [api.batch_fn(step, shape) for step in EVAL_STEPS]
    n_qr = sum(t.kind == "qr" for t in plan.tables)
    base = torch.cuda.memory_allocated()
    for mode, tables, lookup in (("f32", params, "qr_gather"),
                                 ("int8", qparams, "qr_gather_quant")):
        _add_counts(total, _eval_run(torch, api, plain, tables, batches, f"plan {mode}", lookup,
                                     n_qr, table_bytes(tables), base))
    del params

    # training, plain as the reference trains: the loss falls, and one
    # step's gradients (projections included) on the card equal the CPU's
    tcfg = dataclasses.replace(cfg, use_kernel=False)
    tapi = dlrm_criteo.api(tcfg)
    tshape = Shape("train", 1, B, "train")
    out["grad_check"] = _grads_vs_cpu(torch, dlrm_criteo.api(tcfg, device="cpu"), tapi, tshape)
    state = init_state(tapi.init(torch.Generator(device="cuda").manual_seed(0)), tapi.optimizer)
    t = time.perf_counter()
    state, history = Trainer(make_train_step(tapi.loss_fn, tapi.optimizer),
                             TrainConfig(num_steps=PLAN_TRAIN_STEPS, log_every=1),
                             batch_at=lambda s: tapi.batch_fn(s, tshape)).run(state)
    train_s = time.perf_counter() - t
    losses = [loss for _, loss in history]
    tail = sum(losses[-10:]) / 10
    out["train"] = {"steps": PLAN_TRAIN_STEPS, "loss_step_0": losses[0], "loss_last_10": tail,
                    "ms_per_step": train_s / PLAN_TRAIN_STEPS * 1e3}
    print(f"  trained {PLAN_TRAIN_STEPS} Adagrad(1e-2) steps at B={B} in {train_s:.2f} s: loss "
          f"{losses[0]:.5f} at step 0, {tail:.5f} over the last 10")
    if len(losses) != PLAN_TRAIN_STEPS or not all(math.isfinite(x) for x in losses) \
            or not tail < losses[0]:
        _fail("the planned model's training loss did not fall")
    del state

    # swap the live uniform c=4 engine onto the planned model
    swap = engine.swap_plan(cfg, qparams)
    engine.reset_metrics()
    _zero_counts()
    after = _serve_all(engine, reqs[:512])
    counts = _read_counts()
    _check_counts("plan after swap_plan", counts, _cache_counts(engine.metrics()))
    _add_counts(total, counts)
    fresh = _serve_all(RecsysEngine(cfg, qparams, max_batch=256), reqs[:512])
    out["swap"] = {"buckets_warmed": len(swap["buckets_warmed"]),
                   "max_abs_vs_fresh": _hold_scores(
                       "uniform c=4 engine swapped onto the plan vs a fresh engine", after,
                       fresh, tol=0.0)}
    print(f"  card: {card}; [plan] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"plan_profile": out}, default=str))
    return total, out["k4_err"], wave, (plan, cfg, qparams)


# [online]: the [plan] model served with observability on, then through
# stationary and drifted windows of the port's stream under the online
# controller (the reference drift bench's thresholds and drift, at Kaggle
# sizes), its migration, re-quantization and hot-swap
ONLINE_WINDOW = 2048            # requests per telemetry window: 8 waves of 256
ONLINE_CAL_WINDOWS = 4          # stationary windows that fit collision_scale
ONLINE_STAT_WINDOWS = 3         # stationary windows through the controller
ONLINE_DRIFT_WINDOWS = 6        # drifted windows through the controller, at most
ONLINE_POST_WINDOWS = 2         # drifted windows after the swap
ONLINE_DRIFT_STEP = 100_000     # the stream step where the drift starts
ONLINE_POPULATION = 1 << 18     # draws of each stream behind its population masses
ONLINE_OBS_PAIRS = 7            # alternated obs-off / obs-on timed passes (the
                                # reference obs lane's 7 paired passes)
ONLINE_TRAIN_STEPS = 20
# the reference drift bench's detector knobs (benchmarks/drift_bench.py:62-65)
# and its p99-through-swap bound (:67-68).  Its abs_gap, 1e-4, absorbs a
# window's sampling noise at its table sizes (500-4,000 rows), where a QR
# pair's mass under spread traffic is about 1/S >= 2.5e-4; at Kaggle sizes
# it is 1e-7 to 1e-6, so no mass of a QR feature can clear 1e-4.  The
# phase takes abs_gap from its own stationary calibration windows instead:
# the largest mass any feature showed there (_online_calibrate).
ONLINE_THRESHOLDS = {"rel_gap": 0.6, "hysteresis": 2, "cooldown": 2}
REFERENCE_ABS_GAP = 1e-4
# the drift: the reference bench's rotation of the popularity head by half of
# each table, with the exponent moved to the reference's plan-time
# concentration (drift_bench.py:58, ZIPF_BEFORE 8).  The reference moves
# 8 -> 0.7 because its plan priced concentrated traffic; [plan]'s plan priced
# the api's spread stream (1.5), and a flatter one only lowers its QR pairs'
# masses, while a concentrated head packs ids into shared quotient and
# remainder rows.  Both drifts' population masses are printed.
ONLINE_ZIPF_AFTER = 8.0
REFERENCE_ZIPF_AFTER = 0.7
P99_FACTOR, P99_SLACK_MS = 3.0, 5.0
# migration, card vs CPU: f32 gathers and width changes summed in another
# order, within this share of each leaf's largest |value|
MIGRATE_TOL = 1e-5


def _online_stream(zipf_after=ONLINE_ZIPF_AFTER):
    """The port's stream at Kaggle sizes (the api's: zipf 1.5, the stats
    [plan] solved from) and its drift from ONLINE_DRIFT_STEP on: the head
    rotated by half of each table, the exponent moved to ``zipf_after``."""
    from repro_torch.data.criteo import KAGGLE_TABLE_SIZES, CriteoSpec, DriftSpec

    return (CriteoSpec(table_sizes=KAGGLE_TABLE_SIZES, zipf=1.5, noise=0.5),
            DriftSpec(shift_step=ONLINE_DRIFT_STEP, rotate_frac=0.5, zipf_after=zipf_after))


def _online_window(step, drifted):
    """One window: ONLINE_WINDOW rows of the stream drawn on the CPU, as
    requests with one id per feature (the telemetry sees the stream's ids)
    and as the batch itself."""
    from repro_torch.data.criteo import drifted_batch_at

    spec, drift = _online_stream()
    batch = drifted_batch_at(0, (ONLINE_DRIFT_STEP if drifted else 0) + step, ONLINE_WINDOW,
                             spec, drift, device="cpu")
    dense, sparse = batch["dense"].numpy(), batch["sparse"].numpy().tolist()
    return [(dense[r], [[i] for i in row]) for r, row in enumerate(sparse)], batch


def _serve_waves(engine, reqs, latencies):
    """``reqs`` one wave of ``engine.max_batch`` at a time, each wave's
    submit-to-drained ms appended to ``latencies``; the scores in order."""
    import numpy as np

    out = []
    for lo in range(0, len(reqs), engine.max_batch):
        uids = [engine.submit(d, b) for d, b in reqs[lo:lo + engine.max_batch]]
        t = time.perf_counter()
        done = engine.run_until_drained()
        latencies.append((time.perf_counter() - t) * 1e3)
        out += [done[u].score for u in uids]
    return np.array(out, dtype=np.float64)


def _counted(torch, total, path, engine, run):
    """``run()`` with the launch counts zeroed just before and read just
    after, held to the engine's waves (``_cache_counts``) and added to
    ``total``; returns what ``run`` returned."""
    engine.reset_metrics()
    torch.cuda.synchronize()
    _zero_counts()
    out = run()
    counts = _read_counts()
    _check_counts(path, counts, _cache_counts(engine.metrics()))
    _add_counts(total, counts)
    return out


def _online_calibrate(modules, plan_stats):
    """The reference bench's lane 1 at Kaggle sizes: the planner's predicted
    collision masses under the plan's stats against the masses measured on
    ONLINE_CAL_WINDOWS stationary windows; returns (predicted, scale,
    abs_gap), abs_gap the largest mass measured on any feature in those
    windows (ONLINE_THRESHOLDS)."""
    from repro_torch.obs.collision import predicted_collision_mass
    from repro_torch.plan.freq import stats_from_batches
    from repro_torch.plan.quality import fit_collision_scale

    predicted = [predicted_collision_mass(m, s) for m, s in zip(modules, plan_stats)]
    pairs, abs_gap = [], 0.0
    for w in range(ONLINE_CAL_WINDOWS):
        _, batch = _online_window(1000 + w, drifted=False)
        window = stats_from_batches([batch], [s.size for s in plan_stats])
        measured = [predicted_collision_mass(m, s) for m, s in zip(modules, window)]
        abs_gap = max(abs_gap, *measured)
        pairs += [(p, x) for p, x in zip(predicted, measured) if p > 0]
    scale = fit_collision_scale(pairs)
    shown = {i: f"{p:.3e}" for i, p in enumerate(predicted) if p > 0}
    print(f"  calibration: predicted collision masses (features with any) {shown}; "
          f"{len(pairs)} (predicted, measured) pairs over {ONLINE_CAL_WINDOWS} stationary "
          f"windows of {ONLINE_WINDOW}: collision_scale {scale:.4f}; the largest measured "
          f"mass, the detector's abs_gap: {abs_gap:.4e} (the reference's {REFERENCE_ABS_GAP})")
    if not abs_gap > 0.0:
        _fail("the calibration windows measured no collision mass: no abs_gap to set")
    return predicted, scale, abs_gap


def _online_readonly(torch, cfg, qparams, reqs, total):
    """Obs is read-only: the same requests through twin engines, obs off and
    on, bitwise equal scores and one grouped K4 and one K2 per wave each;
    the stage partition tiles the wave latency; a profiled pass shows one
    ``wave`` range per wave; obs-off vs obs-on host ms per wave, alternated."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Obs
    from repro_torch.serve.recsys import STAGES, RecsysEngine

    obs = Obs(trace=True, collisions=True)
    off = RecsysEngine(cfg, qparams, max_batch=B, batching="continuous")
    on = RecsysEngine(cfg, qparams, max_batch=B, batching="continuous", obs=obs)
    scores = {}
    for name, eng in (("off", off), ("on", on)):
        _serve_all(eng, reqs[:256])                    # warm pass, outside the counts
        scores[name] = _counted(torch, total, f"online obs {name}", eng,
                                lambda e=eng: _serve_all(e, reqs))
    waves = on.metrics()["waves"]
    if off.metrics()["waves"] != waves or (scores["on"] != scores["off"]).any():
        _fail("obs-on scores or waves differ from obs-off: observability is not read-only")
    ss = on.stage_summary()
    ratio = ss["partition"]["ratio"]
    counts_ok = all(ss[st]["count"] == waves for st in STAGES)
    print(f"  {len(reqs)} requests, {waves} waves: obs-on scores bit-equal to obs-off, one "
          f"grouped K4 and one K2 per wave on both; stage partition ratio {ratio:.12f}, every "
          f"stage counted {waves} times {counts_ok}; {len(obs.tracer)} trace events, "
          f"{obs.collisions.waves} telemetry waves")
    if abs(ratio - 1.0) > 1e-9 or not counts_ok:
        _fail("the stage partition does not tile the wave latency")

    annotated = RecsysEngine(cfg, qparams, max_batch=B, batching="continuous",
                             obs=Obs(trace=True, profiler_annotations=True))
    _serve_all(annotated, reqs[:256])
    for attempt in range(5):
        annotated.reset_metrics()
        torch.cuda.synchronize()
        _zero_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _serve_all(annotated, reqs[:1024])
            torch.cuda.synchronize()
        counts = _read_counts()
        pw = annotated.metrics()["waves"]
        _check_counts("online obs profiled", counts, _cache_counts(annotated.metrics()))
        _add_counts(total, counts)
        # each range is a host event, mirrored on the device's timeline
        # as a user annotation: count the host's
        waves_ev = [ev for ev in prof.events() if ev.name == "wave"]
        ranges = sum(ev.device_type == DeviceType.CPU for ev in waves_ev)
        if ranges == pw:
            break
        print(f"  profiled pass {attempt}: {ranges} host wave ranges for {pw} waves and "
              f"{counts['fused_serve_pool']} K4 launches: the profiler dropped events, again")
    print(f"  profiled pass with profiler annotations: {ranges} `wave` ranges on the host "
          f"({len(waves_ev) - ranges} mirrored on the device) for {pw} waves "
          f"({counts['fused_serve_pool']} K4 and {counts['dot_interaction']} K2 launches)")
    if ranges != pw:
        _fail("the profiled pass does not show one wave range per wave")

    host = {"off": [], "on": []}
    spent, on_waves = {}, 0
    for name in ("record", "_compact"):
        _time_calls(obs.collisions, name, spent)
    _time_calls(on, "_record_wave", spent)
    for _ in range(ONLINE_OBS_PAIRS):
        for name, eng in (("off", off), ("on", on)):
            eng.reset_metrics()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _serve_all(eng, reqs)
            host[name].append((time.perf_counter() - t) / eng.metrics()["waves"] * 1e3)
            on_waves += eng.metrics()["waves"] if name == "on" else 0
    ratios = [b / a for a, b in zip(host["off"], host["on"])]
    med = {k: float(np.median(v)) for k, v in host.items()}
    print(f"  host ms per wave, alternated within this call: obs off "
          f"{[round(x, 3) for x in host['off']]}, obs on {[round(x, 3) for x in host['on']]}; "
          f"medians {med['off']:.3f} / {med['on']:.3f}; on / off per pair "
          f"{[round(x, 4) for x in ratios]}, best {min(ratios):.4f}")
    # the obs work itself, timed where it runs: the telemetry's record (with
    # the compaction it triggers) and the stage and trace recording
    work = {k: v / on_waves * 1e3 for k, v in spent.items()}
    obs_ms = work["record"] + work["_record_wave"]
    print(f"  obs work per wave, timed in place over {on_waves} obs-on waves: telemetry record "
          f"{work['record']:.4f} ms (compaction inside it {work['_compact']:.4f}), stage and "
          f"trace recording {work['_record_wave']:.4f} ms; {obs_ms:.4f} ms in all = "
          f"{obs_ms / med['off'] * 100:.3f}% of the obs-off median host ms per wave "
          f"(the reference obs lane's budget: 2%)")
    return {"waves": waves, "partition_ratio": ratio, "profiled_wave_ranges": ranges,
            "host_ms_per_wave": host, "median_ms_per_wave": med, "on_over_off": ratios,
            "obs_ms_per_wave": work, "obs_share_of_off": obs_ms / med["off"]}


def _time_calls(obj, name, spent):
    """Replace ``obj.name`` by a wrapper that adds each call's host seconds
    to ``spent[name]``: obs work timed in place, on the path that runs it."""
    fn = getattr(obj, name)
    spent[name] = 0.0

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[name] += time.perf_counter() - t

    setattr(obj, name, timed)


def _online_population(modules, qr):
    """The QR features' collision masses over ONLINE_POPULATION draws of the
    stationary stream, of the drift served and of the reference bench's
    (zipf_after 0.7): what the windows sample, and the direction in which
    each drift moves it."""
    from repro_torch.data.criteo import drifted_batch_at
    from repro_torch.obs.collision import predicted_collision_mass
    from repro_torch.plan.freq import stats_from_batches

    out = {}
    for name, base, after in (("stationary", 0, ONLINE_ZIPF_AFTER),
                              ("drifted", ONLINE_DRIFT_STEP, ONLINE_ZIPF_AFTER),
                              ("reference_drift", ONLINE_DRIFT_STEP, REFERENCE_ZIPF_AFTER)):
        spec, drift = _online_stream(after)
        batch = drifted_batch_at(0, base + 9000, ONLINE_POPULATION, spec, drift, device="cpu")
        stats = stats_from_batches([batch], spec.table_sizes)
        out[name] = {i: predicted_collision_mass(modules[i], stats[i]) for i in qr}
    ratio = {k: {i: out[k][i] / out["stationary"][i] for i in qr}
             for k in ("drifted", "reference_drift")}
    fmt = {k: {i: f"{v:.3e}" for i, v in out[k].items()} for k in out}
    print(f"  population masses of the QR features over {ONLINE_POPULATION} draws: stationary "
          f"{fmt['stationary']}; drifted (zipf_after {ONLINE_ZIPF_AFTER}) {fmt['drifted']}, "
          f"/ stationary { {i: round(r, 4) for i, r in ratio['drifted'].items()} }; the "
          f"reference bench's drift (zipf_after {REFERENCE_ZIPF_AFTER}) "
          f"{fmt['reference_drift']}, / stationary "
          f"{ {i: round(r, 4) for i, r in ratio['reference_drift'].items()} }")
    return {**out, "ratio": ratio}


def _online_loop(torch, cfg, qparams, plan, plan_stats, predicted, calib, total):
    """The closed loop: the controller on one engine (int8, waves, a
    1 << 20-row device cache) and a twin with no controller, over
    stationary windows, then drifted ones until the detector fires; after
    the fire, drifted windows through the swapped model.  No fire fails the
    phase; the phase never re-plans by hand.  ``calib`` is
    ``_online_calibrate``'s (scale, abs_gap).  Returns the controller, the
    engine, the last window served after the swap and the numbers."""
    import numpy as np

    from repro_torch.obs import Obs
    from repro_torch.online import DriftThresholds, ReplanController
    from repro_torch.plan import dim_ladder
    from repro_torch.serve.cache import DeviceHotRowCache
    from repro_torch.serve.recsys import RecsysEngine

    def make(obs):
        return RecsysEngine(cfg, qparams, max_batch=B, batching="waves", obs=obs,
                            cache=DeviceHotRowCache(capacity_rows=PLAN_CACHE_ROWS))

    engine = make(Obs(trace=True, collisions=True))
    twin = make(Obs(collisions=True))               # the same work per wave
    scale, abs_gap = calib
    thresholds = DriftThresholds(min_lookups=4 * B, collision_scale=scale, abs_gap=abs_gap,
                                 **ONLINE_THRESHOLDS)
    ctrl = ReplanController(engine, budget_bytes=plan.budget_bytes, thresholds=thresholds,
                            decay=0.8, dims=dim_ladder(cfg.emb_dim), quantize="int8",
                            plan_stats=plan_stats)
    spent, waves = {}, [0]
    for name in ("record", "_compact"):
        _time_calls(engine._obs.collisions, name, spent)
    for name in ("check", "replan"):
        _time_calls(ctrl, name, spent)
    lat = {"engine": [], "twin": []}
    decisions = []
    qr = [i for i, p in enumerate(predicted) if p > 0]

    def window(phase, step, drifted, timed):
        reqs, _ = _online_window(step, drifted)
        sink = {"engine": lat["engine"] if timed else [], "twin": lat["twin"] if timed else []}
        got = _counted(torch, total, f"online {phase} {step}", engine,
                       lambda: _serve_waves(engine, reqs, sink["engine"]))
        waves[0] += engine.metrics()["waves"]
        want = _counted(torch, total, f"online twin {phase} {step}", twin,
                        lambda: _serve_waves(twin, reqs, sink["twin"]))
        twin._obs.collisions.reset()
        return reqs, got, want

    for k in range(ONLINE_STAT_WINDOWS):
        _, got, want = window("stationary", 2000 + k, drifted=False, timed=k > 0)
        d = ctrl.check()
        if not np.array_equal(got, want):
            _fail("the controlled engine's scores differ from its twin's before any swap")
        decisions.append(("stationary", d))
    for k in range(ONLINE_DRIFT_WINDOWS):
        window("drift", 3000 + k, drifted=True, timed=True)
        decisions.append(("drift", ctrl.check()))
        if ctrl.replans:
            break
    if any(d is None for _, d in decisions):
        _fail("a window returned no decision: the controller was not armed from the plan's stats")
    for phase, d in decisions:
        gaps = {i: f"{d.gaps[i][0]:.3e}/{d.gaps[i][1]:.3e}" for i in qr if i in d.gaps}
        zero = sum(d.gaps[i] == (0.0, 0.0) for i in d.gaps if i not in qr)
        print(f"  {phase}: fired {d.fired}, over {list(d.over)}, streak {d.streak}, "
              f"cooldown {d.cooldown}; predicted x scale / measured mass, QR features: {gaps}; "
              f"0 / 0 on {zero} of the {len(d.gaps) - len(gaps)} other features judged")
    fires_stat = sum(d.fired for phase, d in decisions if phase == "stationary")
    fires_drift = sum(d.fired for phase, d in decisions if phase == "drift")
    n_drift = len(decisions) - ONLINE_STAT_WINDOWS
    print(f"  fires: {fires_stat} over {ONLINE_STAT_WINDOWS} stationary windows, {fires_drift} "
          f"over {n_drift} drifted windows (abs_gap {thresholds.abs_gap:.4e}, rel_gap "
          f"{thresholds.rel_gap}, hysteresis {thresholds.hysteresis}, min_lookups "
          f"{thresholds.min_lookups}, collision_scale {scale:.4f})")
    population = _online_population(engine.modules, qr)
    check_ms = (spent["check"] - spent["replan"]) / len(decisions) * 1e3
    print(f"  controlled engine, host ms per wave over {waves[0]} waves: telemetry record "
          f"{spent['record'] / waves[0] * 1e3:.4f} (compaction inside it and on read "
          f"{spent['_compact'] / waves[0] * 1e3:.4f}); controller check {check_ms:.3f} ms per "
          f"window of {ONLINE_WINDOW // B} waves")
    out = {"collision_scale": scale, "abs_gap": abs_gap, "fires_stationary": fires_stat, "fires_drift": fires_drift,
           "drift_windows": n_drift, "population": population,
           "host_ms": {"record_per_wave": spent["record"] / waves[0] * 1e3,
                       "compact_per_wave": spent["_compact"] / waves[0] * 1e3,
                       "check_per_window": check_ms},
           "decisions": [{"phase": ph, "fired": d.fired, "over": list(d.over),
                          "gaps": {str(i): d.gaps[i] for i in qr if i in d.gaps}}
                         for ph, d in decisions]}
    if fires_stat:
        _fail("the detector fired on stationary traffic")
    if not fires_drift:
        _fail(f"[online]: the detector did not fire within {n_drift} drifted windows at full "
              f"width (the masses per window and the population masses above)")
    rep = ctrl.replans[0]
    if rep["plan"]["total_bytes"] > rep["plan"]["budget_bytes"] or not rep["swap"]:
        _fail(f"the re-plan is over budget or did not swap: {rep['plan']}")
    print(f"  re-plan on the fire: kinds "
          f"{ {k: rep['plan']['kinds'].count(k) for k in sorted(set(rep['plan']['kinds']))} }, "
          f"{rep['plan']['total_bytes']} B of a {rep['plan']['budget_bytes']} B budget, "
          f"migration {rep['migration']}, swap invalidated {rep['swap']['invalidated_rows']} "
          f"rows, warmed {len(rep['swap']['buckets_warmed'])} buckets, "
          f"{spent['replan']:.2f} s")
    last = None
    for k in range(ONLINE_POST_WINDOWS):
        last = window("after swap", 4000 + k, drifted=True, timed=True)
    p = {who: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
         for who, v in lat.items()}
    bound = P99_FACTOR * p["twin"][1] + P99_SLACK_MS
    print(f"  wave ms through the swap ({len(lat['engine'])} waves): controlled p50 "
          f"{p['engine'][0]:.3f} p99 {p['engine'][1]:.3f}, twin p50 {p['twin'][0]:.3f} p99 "
          f"{p['twin'][1]:.3f}; the reference's bound {P99_FACTOR} x p99 + {P99_SLACK_MS} = "
          f"{bound:.3f} ms (gated by drift_bench, printed here): "
          f"{'within' if p['engine'][1] <= bound else 'over'}")
    out.update({"plan": rep["plan"], "migration": rep["migration"], "p50_p99_ms": p,
                "p99_bound_ms": bound, "replan_s": spent["replan"]})
    return ctrl, engine, last, out


def _online_fresh(torch, cfg, qparams, reqs, swapped, total):
    """A fresh cache-off engine on the migrated int8 params serves one
    grouped K4 and one K2 per wave, its scores within SCORE_TOL of the
    swapped engine's on the same window."""
    from repro_torch.serve.recsys import RecsysEngine

    fresh = RecsysEngine(cfg, qparams, max_batch=B, batching="waves")
    torch.cuda.synchronize()
    _zero_counts()
    got = _serve_all(fresh, reqs)
    counts = _read_counts()
    waves = fresh.metrics()["waves"]
    _check_counts("online fresh engine on the migrated params", counts,
                  {"fused_serve_pool": waves, "dot_interaction": waves})
    _add_counts(total, counts)
    return _hold_scores("swapped engine vs a fresh engine on its migrated int8 params",
                        swapped, got)


def _online_migration(torch, ctrl, old_cfg, old_q, new_cfg, served):
    """``migrate_params`` of the served int8 params on the card against the
    same call on CPU copies (every leaf), and the served params equal to
    the card's migration re-quantized.  Returns the card's f32
    migration, its int8 re-quantization and the numbers."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.online import migrate_params
    from repro_torch.serve.quantize import quantize_params
    from repro_torch.serve.recsys import _to_device

    fresh = get_arch(new_cfg.name).api(new_cfg, "cpu").init(
        torch.Generator().manual_seed(ctrl.seed))
    t = time.perf_counter()
    card, card_rep = migrate_params(old_cfg, old_q, new_cfg, _to_device(fresh, "cuda"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu, cpu_rep = migrate_params(old_cfg, _to_device(old_q, "cpu"), new_cfg, fresh)
    cpu_s = time.perf_counter() - t
    worst = 0.0
    for a, b in zip(tree.leaves(card), tree.leaves(cpu)):
        if a.shape != b.shape or a.dtype != b.dtype or a.device.type != "cuda":
            _fail("the card's migration differs in structure from the CPU's")
        scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
        worst = max(worst, float((a.cpu() - b).abs().max()) / scale if b.numel() else 0.0)
    qcard = quantize_params(card, mode="int8")
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(qcard), tree.leaves(served)))
    n = sum(x.numel() for x in tree.leaves(card))
    print(f"  migration of the served int8 params, card vs CPU copies, every leaf ({n} "
          f"values): max |diff| {worst:.3e} of each leaf's largest |value| (tol "
          f"{MIGRATE_TOL:.0e}); reports equal {card_rep == cpu_rep} ({card_rep['counts']}); "
          f"card {card_s:.2f} s, CPU {cpu_s:.2f} s; the served params are the card's "
          f"migration re-quantized: {same}")
    if worst > MIGRATE_TOL or card_rep != cpu_rep or not same:
        _fail("migration on the card differs from migration on the CPU")
    return card, qcard, {"max_rel_diff": worst, "card_s": card_s, "cpu_s": cpu_s,
                         "counts": card_rep["counts"]}


def _online_train(torch, cfg, params):
    """ONLINE_TRAIN_STEPS Adagrad steps of the migrated model (the plain
    path, as the reference trains) through ``Trainer(obs=Obs(trace=True))``
    and without obs, from the same state with deterministic algorithms:
    the step histogram and trace count the steps, the losses are bit-equal."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.obs import Obs
    from repro_torch.train.loop import TrainConfig, Trainer, init_state, make_train_step

    tapi = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=False))
    shape = Shape("train", 1, B, "train")
    kept = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for name, obs in (("obs", Obs(trace=True)), ("plain", None)):
            tr = Trainer(make_train_step(tapi.loss_fn, tapi.optimizer),
                         TrainConfig(num_steps=ONLINE_TRAIN_STEPS, log_every=1),
                         batch_at=lambda s: tapi.batch_fn(s, shape), obs=obs)
            t = time.perf_counter()
            _, history = tr.run(init_state(params, tapi.optimizer))
            runs[name] = (history, obs, time.perf_counter() - t)
    finally:
        torch.use_deterministic_algorithms(kept)
    history, obs, secs = runs["obs"]
    h = obs.registry.histogram("train_step_seconds").labels()
    events = sum(e["name"] == "train_step" for e in obs.tracer.events)
    same = history == runs["plain"][0]
    print(f"  {ONLINE_TRAIN_STEPS} Adagrad steps of the migrated model through Trainer(obs=): "
          f"step histogram count {h.count}, {events} train_step events, loss "
          f"{history[0][1]:.5f} -> {history[-1][1]:.5f}, {secs / ONLINE_TRAIN_STEPS * 1e3:.2f} "
          f"ms per step; losses bit-equal to the obs-off run {same}")
    if h.count != ONLINE_TRAIN_STEPS or events != ONLINE_TRAIN_STEPS or not same:
        _fail("Trainer(obs=) miscounts the steps or changes the loss")
    return {"losses": [x for _, x in history], "ms_per_step": secs / ONLINE_TRAIN_STEPS * 1e3}


def online_full_width(torch, planned, reqs, card):
    """The [online] phase (module docstring, phase 14); returns its launch
    counts."""
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.models.dlrm import _qr2, tables_for
    from repro_torch.plan.freq import stats_from_criteo
    from repro_torch.serve.quantize import table_bytes

    t0 = time.perf_counter()
    total = {name: 0 for name in _kernels()}
    plan, cfg, qparams = planned
    spec, _ = _online_stream()
    with open(PLAN_REFERENCE) as f:
        ref = json.load(f)["full_width"]
    plan_stats = stats_from_criteo(spec, num_batches=ref["num_batches"],
                                   batch_size=ref["batch_size"])
    predicted, *calib = _online_calibrate(tables_for(cfg), plan_stats)
    out = {"card": card, "readonly": _online_readonly(torch, cfg, qparams, reqs[:2048], total)}
    ctrl, engine, last, out["loop"] = _online_loop(torch, cfg, qparams, plan, plan_stats,
                                                   predicted, calib, total)
    new_cfg = engine.cfg
    migrated, qmigrated, out["migration"] = _online_migration(
        torch, ctrl, cfg, qparams, new_cfg, engine.params)
    out["fresh_vs_swapped"] = _online_fresh(torch, new_cfg, qmigrated, last[0], last[1], total)
    del ctrl, engine

    api, plain = dlrm_criteo.api(new_cfg), dlrm_criteo.api(
        dataclasses.replace(new_cfg, use_kernel=False))
    batches = [api.batch_fn(step, Shape("bench", 1, B, "train")) for step in EVAL_STEPS]
    mods = tables_for(new_cfg)
    n_qr = sum(_qr2(m) for m in mods)
    if all(_qr2(m) for m in mods) and not migrated.get("proj"):
        n_qr = 1                          # QR pairs alone: one grouped launch
    base = torch.cuda.memory_allocated()
    for mode, tables, lookup in (("f32", migrated, "qr_gather"),
                                 ("int8", qmigrated, "qr_gather_quant")):
        _add_counts(total, _eval_run(torch, api, plain, tables, batches, f"migrated {mode}",
                                     lookup, n_qr, table_bytes(tables), base))
    print(f"  migrated model one-hot: {n_qr} K1 / K5 (per QR pair) and 1 K2 per batch")
    del qmigrated
    out["train"] = _online_train(torch, new_cfg, migrated)
    del migrated
    out["seconds"] = time.perf_counter() - t0
    print(f"  card: {card}; [online] {out['seconds']:.1f} s")
    print(json.dumps({"online_profile": out}, default=str))
    return total


# [sweep]: the planner-driven compression sweep (examples/compression_sweep.py)
# on the card at its defaults, held to the JAX package's run on the port's
# stream (tools/sweep_reference.py)
SWEEP_REFERENCE = os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_sweep.json")


def sweep_rows(torch, card):
    """The [sweep] phase: 9 models (the full tables, then the plan and the
    uniform-hash control at each of 4 budgets) trained 250 Adagrad steps at
    B=256 on the card; plans equal to the JAX planner's field for field,
    held-out losses within each row's tolerance of the reference's."""
    from repro_torch.examples import compression_sweep as sw
    from repro_torch.plan import MemoryPlan, plan_differences

    with open(SWEEP_REFERENCE) as f:
        ref = json.load(f)
    want = {r["name"]: r for r in ref["rows"]}
    t0 = time.perf_counter()
    rows = sw.sweep(device="cuda")
    secs = time.perf_counter() - t0
    if [r["name"] for r in rows] != [r["name"] for r in ref["rows"]]:
        _fail(f"[sweep] rows {[r['name'] for r in rows]} are not the reference's")
    worst = 0.0
    out = []
    for r in rows:
        w = want[r["name"]]
        if "plan" in r:
            diffs = plan_differences(r["plan"], MemoryPlan.from_json(json.dumps(w["plan"])),
                                     1e-12)
            if diffs:
                _fail(f"[sweep] {r['name']}: the plan differs from the JAX package's on the "
                      f"same stats: {diffs[:5]}")
        gap = abs(r["loss"] - w["loss"])
        worst = max(worst, gap)
        finite = all(math.isfinite(x) for x in r["train_losses"])
        print(f"  {r['name']:22s} params {r['params']:>9,} proxy {r['proxy']:.6f} held-out "
              f"{r['loss']:.6f} vs reference {w['loss']:.6f} (|diff| {gap:.6f}, tol "
              f"{w['tol']:.4f}) | {r['us_per_step'] / 1e3:.3f} ms per step")
        if not (finite and math.isfinite(r["loss"]) and gap <= w["tol"]):
            _fail(f"[sweep] {r['name']}: held-out loss {r['loss']:.6f} vs the reference's "
                  f"{w['loss']:.6f}, tolerance {w['tol']:.4f}")
        out.append({k: r[k] for k in ("name", "params", "proxy", "loss", "us_per_step")}
                   | {"reference_loss": w["loss"], "tol": w["tol"], "abs_dloss": gap})
    agree = sw.agreement(rows)
    print(f"  every plan equals the JAX package's ({SWEEP_REFERENCE[len(ROOT) + 1:]}); largest "
          f"held-out |diff| {worst:.6f}; proxy vs trained order per budget: "
          + ", ".join(f"{f:g}x {'agree' if a else 'disagree'}" for f, a in agree.items()))
    print(f"  card: {card}; [sweep] {secs:.1f} s for 9 x {sw.STEPS} steps")
    print(json.dumps({"sweep_profile": {"card": card, "seconds": secs, "rows": out,
                                        "largest_abs_dloss": worst,
                                        "agreement": {f"{f:g}": a for f, a in agree.items()}}}))


# [dist]: the data-parallel step with compressed gradient exchange at full
# width.  Worlds are spawned processes (repro_torch.dist.world); their
# workers are the module-level functions below and report through JSON
# files under build/dist/.
DIST_POLICIES = ("none", "bf16", "int8", "auto")
DIST_STEPS = 3
DIST_WORLD = 4
DIST_DIR = os.path.join(ROOT, "build", "dist")
# (a) the DP step at n = 1 with "none" against make_train_step: the same
# gradients (an all-reduce of one is the identity), so only the index
# backward's atomics separate two runs; each leaf within 1e-6 of its
# largest |value|
DIST_ONE_TOL = 1e-6
# (b) "none" at n = 4 against one device on the whole batch: the mean of 4
# shard means in another f32 order, each leaf within GRAD_TOL of its
# largest |g|; the reductions card vs CPU on the same per-rank gradients:
# int8 bit-equal, bf16 bit-equal or within one bf16 ulp (2^-8) of each
# leaf's largest |value|, none within 1e-6 of it
DIST_NONE_RTOL = 1e-6
DIST_WIRE_TOL = 0.10
DIST_INT8_BAR = 0.30


def _dist_setup(torch, device):
    """Full-width DLRM-Criteo: its api on ``device``, parameters drawn on
    the CPU (seed 0) and moved, and a CPU-drawn batch function."""
    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape

    cfg = dlrm_criteo.config(reduced=False)
    host = dlrm_criteo.api(cfg, device="cpu")
    api = dlrm_criteo.api(cfg, device=device)
    shape = Shape("train", 1, B, "train")
    params = tree.tree_map(lambda t: t.to(device), host.init(torch.Generator().manual_seed(0)))

    def batch_at(step):
        return tree.tree_map(lambda t: t.to(device), host.batch_fn(step, shape))

    return api, params, batch_at


def _worst_rel(tree_mod, got, want):
    """The worst leaf's max |diff| over its largest |value|, and its path."""
    worst, where = 0.0, ""
    for (path, w), g in zip(tree_mod.flatten_with_path(want), tree_mod.leaves(got)):
        scale = float(w.abs().max())
        d = float((g.float() - w.float()).abs().max())
        rel = d / scale if scale else d
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    return worst, where


def _timed_steps(torch, step, state, batch_at, steps, after=None):
    """``steps`` steps, each timed on the host clock between two
    synchronizes; ``after(state)`` runs outside the timing."""
    walls, losses = [], []
    for s in range(steps):
        batch = batch_at(s)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        if after is not None:
            after(state)
    return state, walls, losses


def _dist_one(rank, world_size, out):
    """(a): NCCL, a world of one, full width: each policy's DP step for
    DIST_STEPS steps; "none"'s first step against make_train_step."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist import AUTO, compress, wire
    from repro_torch.train.loop import (init_dp_state, init_state, make_dp_train_step,
                                        make_train_step, value_and_grad)

    api, params, batch_at = _dist_setup(torch, torch.device("cuda"))
    res = {"backend": dist.get_backend(), "world": world_size, "policies": {}}
    batch = batch_at(0)
    (_, _), grads = value_and_grad(api.loss_fn)(params, batch)
    reduced, _ = compress.ef_psum_grads(grads, compress.init_error_state(params, "none"),
                                        group=dist.group.WORLD, mode="none")
    res["none_grads_vs_plain"] = _worst_rel(tree, reduced, grads)
    del reduced
    plain, _ = make_train_step(api.loss_fn, api.optimizer)(init_state(params, api.optimizer),
                                                          batch)
    dp, _ = make_dp_train_step(api.loss_fn, api.optimizer, compress="none")(
        init_dp_state(params, api.optimizer, compress="none"), batch)
    res["none_params_vs_plain"] = _worst_rel(tree, dp["params"], plain["params"])
    res["none_acc_vs_plain"] = _worst_rel(tree, [o["acc"] for o in dp["opt"]],
                                          [o["acc"] for o in plain["opt"]])
    del plain, dp, grads
    for name in DIST_POLICIES:
        pol = AUTO if name == "auto" else name
        state = init_dp_state(params, api.optimizer, compress=pol)
        step = make_dp_train_step(api.loss_fn, api.optimizer, compress=pol)
        wire.reset()
        state, walls, losses = _timed_steps(torch, step, state, batch_at, DIST_STEPS)
        # at n = 1 only an int8 leaf's scale max, a "none" leaf's mean and
        # the metric means are collectives: one call each per step
        modes = compress.resolve_modes(params, pol)
        res["policies"][name] = {"wall_ms": walls, "losses": losses, "wire": wire.snapshot(),
                                 "expected_all_reduces": DIST_STEPS * (
                                     1 + sum(m in ("int8", "none") for m in modes))}
        del state
    with open(out, "w") as f:
        json.dump(res, f)


def _checksums(torch, params):
    """Per leaf: the int64 sums of the f32 bit patterns, plain and weighted
    by position, as one int64 tensor on the leaves' device."""
    from repro_torch import tree
    sums = []
    for p in tree.leaves(params):
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        sums += [bits.sum(), (bits * w).sum()]
    return torch.stack(sums)


def _replicas_agree(torch, dist, params, label):
    """Every rank's parameters bitwise equal rank 0's, by gathered
    checksums (outside ``dist.wire``: checks are not the step's bytes)."""
    mine = _checksums(torch, params)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    if not all(torch.equal(every[0], e) for e in every[1:]):
        raise SystemExit(f"chip_smoke: FAIL: [dist] {label}: the replicas' parameters differ")


def _reduction_card_vs_cpu(torch, dist):
    """``ef_psum_grads`` on per-rank gradients drawn on the CPU from one seed
    (the reduced DLRM-Criteo's gradient tree, f32 ~ N(0, 1e-2)), once on
    the card and once on the CPU, in the same gloo world: per mode the
    largest difference and the count of differing elements, outputs and
    residuals."""
    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.dist import compress

    like = dlrm_criteo.api(dlrm_criteo.config(reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1000 + dist.get_rank())
    grads = tree.tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-2, like)
    out = {}
    for mode in ("none", "bf16", "int8"):
        err = compress.init_error_state(grads, mode)
        res = {}
        for where in ("cuda", "cpu"):
            g = tree.tree_map(lambda t, where=where: t.to(where), grads)
            e = tree.tree_map(lambda t, where=where: t.to(where), err)
            o, ne = compress.ef_psum_grads(g, e, group=dist.group.WORLD, mode=mode)
            res[where] = [t.cpu() for t in tree.leaves(o) + tree.leaves(ne)]
        diff = rel = 0.0
        ndiff = 0
        for a, b in zip(res["cuda"], res["cpu"]):
            d = (a - b).abs()
            diff = max(diff, float(d.max()))
            scale = float(b.abs().max())
            rel = max(rel, float(d.max()) / scale if scale else float(d.max()))
            ndiff += int((a != b).sum())
        out[mode] = {"max_abs": diff, "max_rel": rel, "elements_differing": ndiff,
                     "elements": sum(t.numel() for t in res["cpu"])}
    return out


def _dist_four(rank, world_size, out, params_out):
    """(b) and (c): gloo, a world of 4, every rank on cuda:0 — the model,
    gradients, compression and optimizer on the card, the exchange through
    gloo.  Per policy DIST_STEPS steps with the replicas checked after each;
    "auto" through ``Trainer(obs=, step_wire=)``."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist import AUTO, accounting, compress, wire
    from repro_torch.obs import Obs
    from repro_torch.train.loop import (TrainConfig, Trainer, init_dp_state, make_dp_train_step,
                                        value_and_grad)

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    res = {"backend": dist.get_backend(), "world": world_size, "policies": {},
           "reduction_card_vs_cpu": _reduction_card_vs_cpu(torch, dist)}
    api, params, batch_at = _dist_setup(torch, device)

    # "none" at n = 4 against one device on the whole batch
    batch = batch_at(0)
    b = B // world_size
    local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    (_, _), grads = value_and_grad(api.loss_fn)(params, local)
    reduced, _ = compress.ef_psum_grads(grads, compress.init_error_state(params, "none"),
                                        group=dist.group.WORLD, mode="none")
    del grads
    if rank == 0:
        (_, _), whole = value_and_grad(api.loss_fn)(params, batch)
        res["none_vs_one_device"] = _worst_rel(tree, reduced, whole)
        del whole
    del reduced
    torch.cuda.empty_cache()

    for name in DIST_POLICIES:
        pol = AUTO if name == "auto" else name
        state = init_dp_state(params, api.optimizer, compress=pol)
        step = make_dp_train_step(api.loss_fn, api.optimizer, compress=pol)
        acct = accounting.dp_step_wire_bytes(params, pol, world_size, scalar_allreduces=3)
        wire.reset()
        checked = []

        def check(state, name=name):
            _replicas_agree(torch, dist, state["params"], f"{name} step {len(checked)}")
            checked.append(True)

        row = {"accounted_bytes_per_step": acct["total_bytes"]}
        if name == "auto":
            obs = Obs()
            step_wire = accounting.grad_wire_bytes(params, AUTO, world_size)
            walls = []

            def timed(state, batch, step=step, walls=walls):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
                check(state)
                return state, m

            trainer = Trainer(timed, TrainConfig(num_steps=DIST_STEPS, log_every=1), obs=obs,
                              step_wire=step_wire, batch_at=batch_at)
            state, history = trainer.run(state)
            losses = [loss for _, loss in history]
            counters = {s["labels"]["leaf"]: s["value"] for s in
                        obs.registry.snapshot()["train_wire_bytes_total"]["series"]}
            recorded = wire.snapshot()["per_leaf"]
            row["trainer_counters"] = {
                e["path"]: {"counter": counters[e["path"]],
                            "accounted_per_step": e["wire_bytes"],
                            "recorded": recorded.get(e["path"], 0.0)}
                for e in step_wire["per_leaf"]}
            if rank == 0:
                torch.save(tree.tree_map(lambda t: t.cpu(), state["params"]), params_out)
        else:
            state, walls, losses = _timed_steps(torch, step, state, batch_at, DIST_STEPS, check)
        row.update({"wall_ms": walls, "losses": losses, "wire": wire.snapshot(),
                    "replica_checks": len(checked)})
        res["policies"][name] = row
        del state
        torch.cuda.empty_cache()
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


DIST_METRICS = os.path.join(DIST_DIR, "m.jsonl")


def _dist_launcher_start():
    """Start (c)'s launcher: the training launcher at full width as a world
    of one."""
    os.makedirs(DIST_DIR, exist_ok=True)
    if os.path.exists(DIST_METRICS):
        os.remove(DIST_METRICS)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm-criteo",
           "--no-reduced", "--compress-policy", "auto", "--steps", "20",
           "--metrics-out", os.path.relpath(DIST_METRICS, ROOT)]
    BACKGROUND.start("dist_launcher", cmd, env=dict(os.environ,
                                                    PYTHONPATH=os.path.join(ROOT, "src")))


def _dist_launcher(card):
    """(c): the training launcher's run, started beside the worlds."""
    metrics = DIST_METRICS
    proc, secs = BACKGROUND.wait("dist_launcher", 600)
    cmd = proc.args
    print("  $ python -m repro_torch.launch.train " + " ".join(cmd[3:]))
    for line in proc.stdout.strip().splitlines():
        print(f"    {line}")
    if proc.returncode != 0 or "loss" not in proc.stdout or not os.path.exists(metrics):
        _fail(f"[dist] the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(metrics) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    wire_lines = [x for x in lines if x["name"] == "train_wire_bytes_total"]
    steps = [x for x in lines if x["name"] == "train_steps_total"]
    print(f"  launcher: exit 0 in {secs:.1f} s beside the worlds, registry {len(lines)} series "
          f"({len(wire_lines)} per-leaf wire counters, sum {sum(x['value'] for x in wire_lines)}"
          f" B: every ring formula gives 0 bytes at n = 1, as the reference's counters read on "
          f"one device; not asserted), train_steps_total "
          f"{steps[0]['value'] if steps else 'missing'} | card: {card}")
    if not wire_lines or not steps or steps[0]["value"] != 20:
        _fail("[dist] the launcher's registry lacks its step or wire counters")
    return {"seconds": secs, "series": len(lines), "wire_counters": len(wire_lines)}


def dist_full_width(torch, card):
    """The [dist] phase: (a) NCCL world of one, (b) gloo world of 4 on one
    card, (c) Trainer(step_wire=) and the launcher; then the tables trained
    under "auto" in (b) scored through K1 + K2.  Returns the scoring's
    launch counts."""
    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.dist import world
    from repro_torch.serve.quantize import table_bytes

    os.makedirs(DIST_DIR, exist_ok=True)
    t0 = time.perf_counter()
    one = os.path.join(DIST_DIR, "one.json")
    four = os.path.join(DIST_DIR, "four.json")
    auto_params = os.path.join(DIST_DIR, "auto_params.pt")
    job_a = _beside(world.spawn, _dist_one, 1, "nccl", one)    # (a) beside (b)
    t = time.perf_counter()
    world.spawn(_dist_four, DIST_WORLD, "gloo", four, auto_params)
    four_s = time.perf_counter() - t
    one_s = job_a.result()
    with open(one) as f:
        a = json.load(f)
    print(f"  (a) {a['backend']}, world of {a['world']} ({one_s:.1f} s with the spawn, beside "
          f"(b)): 'none' "
          f"first step vs make_train_step — reduced gradients worst leaf "
          f"{a['none_grads_vs_plain'][1]} {a['none_grads_vs_plain'][0]:.3e}, parameters "
          f"{a['none_params_vs_plain'][0]:.3e}, Adagrad state {a['none_acc_vs_plain'][0]:.3e} "
          f"of each leaf's largest |value| (tol {DIST_ONE_TOL:.0e})")
    if max(a["none_grads_vs_plain"][0], a["none_params_vs_plain"][0],
           a["none_acc_vs_plain"][0]) > DIST_ONE_TOL:
        _fail("[dist] (a) the DP step at n = 1 disagrees with make_train_step")
    for name, p in a["policies"].items():
        kinds = p["wire"]["per_kind"]
        print(f"  (a) {name:5s}: wall ms per step {sorted(p['wall_ms'])[DIST_STEPS // 2]:.3f} "
              f"(median of {DIST_STEPS}; first {p['wall_ms'][0]:.3f}), losses "
              f"{[round(x, 5) for x in p['losses']]}, NCCL calls "
              + ", ".join(f"{k} {v['calls']}" for k, v in kinds.items())
              + f", recorded bytes {p['wire']['total_bytes']:.0f} (0 at n = 1) | {card}")
        if not all(math.isfinite(x) for x in p["losses"]) or (
                kinds["all_reduce"]["calls"] != p["expected_all_reduces"]
                or p["wire"]["calls"] != p["expected_all_reduces"]):
            _fail(f"[dist] (a) {name}: losses not finite, or {p['wire']['calls']} collectives "
                  f"issued where {p['expected_all_reduces']} all-reduces were expected")

    with open(four) as f:
        bres = json.load(f)
    print(f"  (b) gloo, world of {bres['world']}, every rank on cuda:0 ({four_s:.1f} s with the "
          f"spawn); peak memory of rank 0 {bres['peak_memory_bytes']} B")
    for mode, r in bres["reduction_card_vs_cpu"].items():
        print(f"  (b) ef_psum_grads {mode:4s} card vs CPU, same per-rank gradients: max |diff| "
              f"{r['max_abs']:.3e} ({r['max_rel']:.3e} of the largest |value|), "
              f"{r['elements_differing']} of {r['elements']} elements differ")
        ok = {"int8": r["elements_differing"] == 0,
              "bf16": r["max_rel"] <= 2.0 ** -8,
              "none": r["max_rel"] <= DIST_NONE_RTOL}[mode]
        if not ok:
            _fail(f"[dist] (b) the {mode} reduction on the card disagrees with the CPU's")
    worst, where = bres["none_vs_one_device"]
    print(f"  (b) 'none' first-step reduced gradients vs one device on the whole batch: worst "
          f"leaf {where} {worst:.3e} of its largest |g| (tol {GRAD_TOL:.0e})")
    if worst > GRAD_TOL:
        _fail("[dist] (b) the 'none' reduction at n = 4 disagrees with one device")
    rec = {}
    for name, p in bres["policies"].items():
        per_step = p["wire"]["total_bytes"] / DIST_STEPS
        rec[name] = per_step
        ratio = per_step / p["accounted_bytes_per_step"]
        kinds = p["wire"]["per_kind"]
        print(f"  (b) {name:5s}: wall ms per step {sorted(p['wall_ms'])[DIST_STEPS // 2]:.3f} "
              f"(median of {DIST_STEPS}; first {p['wall_ms'][0]:.3f}), losses "
              f"{[round(x, 5) for x in p['losses']]}, replicas bitwise equal after each of "
              f"{p['replica_checks']} steps; recorded {per_step:.0f} B per step vs accounted "
              f"{p['accounted_bytes_per_step']:.0f} (ratio {ratio:.9f}); calls per step "
              + ", ".join(f"{k} {v['calls'] / DIST_STEPS:g}" for k, v in kinds.items())
              + f" | {card}")
        if p["replica_checks"] != DIST_STEPS or not all(math.isfinite(x) for x in p["losses"]):
            _fail(f"[dist] (b) {name}: replicas unchecked or losses not finite")
        if abs(ratio - 1) > DIST_WIRE_TOL:
            _fail(f"[dist] (b) {name}: recorded bytes {per_step:.0f} vs accounted "
                  f"{p['accounted_bytes_per_step']:.0f}")
    int8_ratio = rec["int8"] / rec["none"]
    print(f"  (b) recorded bytes int8 / none {int8_ratio:.6f} (bar {DIST_INT8_BAR})")
    if int8_ratio >= DIST_INT8_BAR:
        _fail(f"[dist] (b) int8 / none recorded bytes {int8_ratio:.3f} >= {DIST_INT8_BAR}")
    counters = bres["policies"]["auto"]["trainer_counters"]
    worst_c = worst_r = 0.0
    for path, c in counters.items():
        want = DIST_STEPS * c["accounted_per_step"]
        if c["counter"] != want:
            _fail(f"[dist] (c) Trainer counter {path}: {c['counter']} != {want}")
        if c["recorded"] or want:
            worst_r = max(worst_r, abs(c["recorded"] - want) / max(want, 1e-30))
        worst_c = max(worst_c, abs(c["counter"] - want))
    print(f"  (c) Trainer(obs=, step_wire=) under 'auto': {len(counters)} per-leaf counters = "
          f"{DIST_STEPS} x each leaf's accounted bytes; largest relative gap to the bytes "
          f"dist.wire recorded for the leaf {worst_r:.3e} (tol {DIST_WIRE_TOL})")
    if worst_r > DIST_WIRE_TOL:
        _fail("[dist] (c) a Trainer wire counter is off the recorded bytes")
    launcher = _dist_launcher(card)

    # the tables trained under "auto" in (b), scored through K1 + K2
    cfg = dlrm_criteo.config(reduced=False)
    kapi = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=True))
    plain = dlrm_criteo.api(cfg)
    params = tree.tree_map(lambda x: x.to("cuda"), torch.load(auto_params))
    os.remove(auto_params)
    shape = Shape("bench", 1, B, "train")
    batches = [kapi.batch_fn(step, shape) for step in EVAL_STEPS]
    counts = _eval_run(torch, kapi, plain, params, batches, "dist auto f32", "qr_gather", 1,
                       table_bytes(params), torch.cuda.memory_allocated())
    del params
    secs = time.perf_counter() - t0
    print(f"  card: {card}; [dist] {secs:.1f} s")
    def brief(policies):
        return {name: {"wall_ms": p["wall_ms"], "losses": p["losses"],
                       "recorded_bytes_per_step": p["wire"]["total_bytes"] / DIST_STEPS,
                       "accounted_bytes_per_step": p.get("accounted_bytes_per_step"),
                       "calls": {k: v["calls"] for k, v in p["wire"]["per_kind"].items()}}
                for name, p in policies.items()}

    print(json.dumps({"dist_profile": {
        "card": card, "seconds": secs, "launcher": launcher, "int8_vs_none_recorded": int8_ratio,
        "one": dict({k: v for k, v in a.items() if k != "policies"},
                    policies=brief(a["policies"])),
        "four": dict({k: v for k, v in bres.items() if k != "policies"},
                     policies=brief(bres["policies"]))}}))
    return counts


# [fsdp]: the full-width FSDP step (ROADMAP 16b) in (a) a NCCL world of one
# and (b) a gloo world of 4 on cuda:0, as [dist] runs the DP step; workers
# report through JSON files under build/fsdp/
FSDP_LANES = (("none", "float32"), ("bf16", "float32"), ("int8", "float32"),
              ("auto", "float32"), ("auto", "bfloat16"))
FSDP_STEPS = 3
FSDP_CKPT_STEP = 2              # the "none" lane checkpoints after this many steps
FSDP_LINEAR_STEPS = 2
FSDP_DIR = os.path.join(ROOT, "build", "fsdp")
# "none" FSDP vs "none" DP: the first step's reduced gradients (read as
# Adagrad's accumulator), each leaf within this of its largest |g|; the two
# sum the ranks' gradients in another order (rank order vs gloo's), so
# parameters after steps are held on a loss whose sums are exact instead
FSDP_DP_GRAD_TOL = 1e-6
# DP's per-rank peak on the same model and world ([dist] (b), PR 21 runs 3-4)
DP_PEAK_BYTES = 5.94e9


def _fsdp_one(rank, world_size, out):
    """(a): NCCL, a world of one, full width, deterministic algorithms: 3
    "none" FSDP steps against 3 steps of ``make_train_step``."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.train.loop import (init_fsdp_state, init_state, make_fsdp_train_step,
                                        make_train_step)

    torch.use_deterministic_algorithms(True)
    api, params, batch_at = _dist_setup(torch, torch.device("cuda"))
    plain, fsdp = init_state(params, api.optimizer), init_fsdp_state(params, api.optimizer,
                                                                      policy="none")
    pstep = make_train_step(api.loss_fn, api.optimizer)
    fstep = make_fsdp_train_step(api.loss_fn, api.optimizer, None, params, policy="none")
    walls = []
    for s in range(3):
        batch = batch_at(s)
        plain, _ = pstep(plain, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fsdp, _ = fstep(fsdp, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    pairs = list(zip(tree.leaves(plain["params"]) + tree.leaves(plain["opt"]),
                     tree.leaves(fsdp["params"]) + tree.leaves(fsdp["opt"])))
    res = {"backend": dist.get_backend(), "world": world_size, "wall_ms": walls,
           "leaves": len(pairs), "differing": sum(not torch.equal(a, b) for a, b in pairs)}
    with open(out, "w") as f:
        json.dump(res, f)


def _params_agree(torch, dist, params, label, bf16_scattered=None):
    """Every rank's parameters bitwise equal rank 0's (gathered checksums,
    outside ``dist.wire``); with a bf16 parameter gather each rank keeps its
    own shard exact, so the scattered leaves are compared rounded to bf16."""
    from repro_torch import tree
    if bf16_scattered is not None:
        params = [p.to(torch.bfloat16).to(torch.float32) if b else p
                  for p, b in zip(tree.leaves(params), bf16_scattered)]
    _replicas_agree(torch, dist, params, label)


def _linear_fsdp_vs_dp(torch, dist, params, opt, rank):
    """"none" FSDP and DP for FSDP_LINEAR_STEPS steps on a loss whose
    gradient is each rank's own coefficients, integers over 64 (|k| <
    1024): every sum of four is exact in f32 in any order, so the two
    steps see the same reduced gradients and must end bit-equal."""
    from repro_torch import tree
    from repro_torch.train.loop import (init_dp_state, init_fsdp_state, make_dp_train_step,
                                        make_fsdp_train_step)

    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    coefs = [torch.randint(-1024, 1024, tuple(p.shape), generator=gen, device="cuda")
             .to(torch.float32) / 64 for p in tree.leaves(params)]

    def loss_fn(p, batch):
        return sum(torch.sum(x * c) for x, c in zip(tree.leaves(p), coefs)), {}

    batch = {"k": torch.zeros(DIST_WORLD, device="cuda")}
    fstate = init_fsdp_state(params, opt, policy="none")
    fstep = make_fsdp_train_step(loss_fn, opt, None, params, policy="none")
    dstate = init_dp_state(params, opt, compress="none")
    dstep = make_dp_train_step(loss_fn, opt, compress="none")
    for _ in range(FSDP_LINEAR_STEPS):
        fstate, _ = fstep(fstate, batch)
        dstate, _ = dstep(dstate, batch)
    worst = _worst_rel(tree, fstate["params"], dstate["params"])
    differing = sum(not torch.equal(a, b) for a, b in zip(tree.leaves(fstate["params"]),
                                                          tree.leaves(dstate["params"])))
    return {"worst": worst, "leaves_differing": differing}


def _fsdp_four(rank, world_size, out_dir):
    """(b): gloo, a world of 4, every rank on cuda:0: each lane's FSDP steps
    with the replicas checked after each, the recorded bytes, the sharded
    optimizer state, a checkpoint restart, the elastic restore, and "none"
    FSDP against "none" DP."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import AUTO, accounting, wire
    from repro_torch.train.loop import (fsdp_plan, fsdp_state_shardings, gather_fsdp_state,
                                        init_dp_state, init_fsdp_state, make_dp_train_step,
                                        make_fsdp_train_step)

    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    api, params, batch_at = _dist_setup(torch, torch.device("cuda", 0))
    opt = api.optimizer
    res = {"rank": rank, "backend": dist.get_backend(), "world": world_size, "lanes": {}}
    # "none" DP's first step, for its reduced gradients
    dstate, _ = make_dp_train_step(api.loss_fn, opt, compress="none")(
        init_dp_state(params, opt, compress="none"), batch_at(0))
    dp_acc = [o["acc"] for o in dstate["opt"]]
    del dstate
    ckdir = os.path.join(out_dir, "ckpt")
    for pol, gd in FSDP_LANES:
        lane = f"{pol}/{gd}"
        step = make_fsdp_train_step(api.loss_fn, opt, None, params, policy=pol,
                                    param_gather_dtype=gd)
        plan = step.plan
        scattered = [dim is not None for (_, _, _, dim) in plan]
        state = init_fsdp_state(params, opt, policy=pol)
        acct = accounting.fsdp_step_wire_bytes(params, opt, world_size,
                                               AUTO if pol == "auto" else pol,
                                               scalar_allreduces=3, param_gather_dtype=gd)
        local = sum(x.numel() * x.element_size() for o, sc in zip(state["opt"], scattered)
                    if sc for x in tree.leaves(o))
        full = sum(math.prod(shape) * 4 for (_, shape, _, dim) in plan if dim is not None)
        row = {"accounted_bytes_per_step": acct["total_bytes"],
               "n_scattered": acct["n_scattered"], "n_leaves": acct["n_leaves"],
               "opt_bytes_scattered_local": local, "opt_bytes_scattered_full": full}
        wire.reset()
        walls, losses = [], []
        for s in range(FSDP_STEPS):
            batch = batch_at(s)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            _params_agree(torch, dist, state["params"], f"[fsdp] {lane} step {s}",
                          scattered if gd == "bfloat16" else None)
            if pol == "none" and s == 0:
                acc = [o["acc"] for o in gather_fsdp_state(state, plan)["opt"]]
                row["first_step_grads_vs_dp"] = _worst_rel(
                    tree, [a.sqrt() for a in acc], [a.sqrt() for a in dp_acc])
                del acc
            if pol == "none" and s == FSDP_CKPT_STEP - 1:
                t = time.perf_counter()
                whole = gather_fsdp_state(state, plan)
                if rank == 0:
                    ckpt.save(ckdir, FSDP_CKPT_STEP, whole)
                del whole
                dist.barrier()
                row["checkpoint_s"] = time.perf_counter() - t
        recorded = wire.snapshot()["per_leaf"]
        row.update({"wall_ms": walls, "losses": losses,
                    "recorded_bytes_per_step": sum(
                        b for leaf, b in recorded.items() if leaf != "_checkpoint") / FSDP_STEPS})
        if pol == "none":
            # restart from the checkpoint at world 4 and run to the end
            t = time.perf_counter()
            resumed, _ = ckpt.restore(ckdir, FSDP_CKPT_STEP, state, shardings=fsdp_state_shardings(
                state, plan, rank, world_size))
            row["restore_s"] = time.perf_counter() - t
            for s in range(FSDP_CKPT_STEP, FSDP_STEPS):
                resumed, _ = step(resumed, batch_at(s))
            row["restart_leaves_differing"] = sum(
                not torch.equal(a, b) for a, b in zip(tree.leaves(resumed), tree.leaves(state)))
            del resumed
            # the elastic restore: ranks 0 and 1 as the ranks of a world of 2
            if rank < 2:
                plan2 = fsdp_plan(params, opt, 2, policy="none")
                sh = fsdp_state_shardings(state, plan2, rank, 2)
                part, _ = ckpt.restore(ckdir, FSDP_CKPT_STEP, state, shardings=sh)
                whole, _ = ckpt.restore(ckdir, FSDP_CKPT_STEP, state)
                row["world2_leaves_differing"] = sum(
                    not torch.equal(a, s_.take(w)) for a, s_, w in zip(
                        tree.leaves(part), tree.leaves(sh), tree.leaves(whole)))
                row["world2_leaves_cut"] = sum(s_.count > 1 for s_ in tree.leaves(sh))
                del part, whole
            dist.barrier()
        if pol == "auto" and gd == "float32" and rank == 0:
            torch.save(tree.tree_map(lambda t: t.cpu(), state["params"]),
                       os.path.join(out_dir, "auto_params.pt"))
        res["lanes"][lane] = row
        del state
        torch.cuda.empty_cache()
    res["linear_none_vs_dp"] = _linear_fsdp_vs_dp(torch, dist, params, opt, rank)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, f"four{rank}.json"), "w") as f:
        json.dump(res, f)


def fsdp_full_width(torch, card):
    """The [fsdp] phase: (a) a NCCL world of one, (b) a gloo world of 4 on
    one card; then the tables trained under "auto" in (b) scored through
    K1 + K2.  Returns the scoring's launch counts."""
    import shutil

    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.dist import world
    from repro_torch.serve.quantize import table_bytes

    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    os.makedirs(FSDP_DIR)
    t0 = time.perf_counter()
    one = os.path.join(FSDP_DIR, "one.json")
    job_a = _beside(world.spawn, _fsdp_one, 1, "nccl", one)    # (a) beside (b)
    t = time.perf_counter()
    world.spawn(_fsdp_four, DIST_WORLD, "gloo", FSDP_DIR)
    four_s = time.perf_counter() - t
    one_s = job_a.result()
    with open(one) as f:
        a = json.load(f)
    print(f"  (a) {a['backend']}, world of {a['world']}, deterministic algorithms: 'none' FSDP "
          f"vs make_train_step over 3 steps ({one_s:.1f} s with the spawn, beside (b)), "
          f"{a['differing']} of {a['leaves']} parameter and "
          f"Adagrad leaves differ (bit for bit expected); wall ms per step "
          f"{[round(x, 3) for x in a['wall_ms']]} | {card}")
    if a["differing"]:
        _fail("[fsdp] (a) the FSDP step at n = 1 is not make_train_step's bit for bit")

    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(FSDP_DIR, f"four{r}.json")) as f:
            ranks.append(json.load(f))
    b = ranks[0]
    print(f"  (b) {b['backend']}, world of {b['world']}, every rank on cuda:0 ({four_s:.1f} s "
          f"with the spawn); peak memory per rank "
          f"{[r['peak_memory_bytes'] for r in ranks]} B (DP's: {DP_PEAK_BYTES:.3g} B)")
    for lane, row in b["lanes"].items():
        ratio = row["recorded_bytes_per_step"] / row["accounted_bytes_per_step"]
        opt_ratio = row["opt_bytes_scattered_local"] / row["opt_bytes_scattered_full"]
        print(f"  (b) {lane:13s}: wall ms per step {sorted(row['wall_ms'])[FSDP_STEPS // 2]:.3f} "
              f"(median of {FSDP_STEPS}; first {row['wall_ms'][0]:.3f}), losses "
              f"{[round(x, 5) for x in row['losses']]}, replicas bitwise equal after every step"
              f"{' (scattered leaves at bf16)' if lane.endswith('bfloat16') else ''}; recorded "
              f"{row['recorded_bytes_per_step']:.0f} B per step vs accounted "
              f"{row['accounted_bytes_per_step']:.0f} (ratio {ratio:.9f}); optimizer bytes of "
              f"the {row['n_scattered']} of {row['n_leaves']} scattered leaves per rank "
              f"{row['opt_bytes_scattered_local']} = {opt_ratio:.6f} of DP's | {card}")
        if not all(math.isfinite(x) for x in row["losses"]):
            _fail(f"[fsdp] (b) {lane}: losses not finite")
        if row["recorded_bytes_per_step"] != row["accounted_bytes_per_step"]:
            _fail(f"[fsdp] (b) {lane}: recorded bytes {row['recorded_bytes_per_step']} != "
                  f"accounted {row['accounted_bytes_per_step']}")
        if any(r["lanes"][lane]["opt_bytes_scattered_local"] * DIST_WORLD
               != row["opt_bytes_scattered_full"] for r in ranks):
            _fail(f"[fsdp] (b) {lane}: a rank's optimizer state is not 1/{DIST_WORLD} of DP's")
    none = b["lanes"]["none/float32"]
    worst, where = none["first_step_grads_vs_dp"]
    print(f"  (b) 'none' FSDP vs 'none' DP, first step's reduced gradients: worst leaf {where} "
          f"{worst:.3e} of its largest |g| (tol {FSDP_DP_GRAD_TOL:.0e}; rank-order vs gloo's "
          f"summation)")
    if worst > FSDP_DP_GRAD_TOL:
        _fail("[fsdp] (b) 'none' FSDP's reduced gradients disagree with DP's")
    lin = b["linear_none_vs_dp"]
    print(f"  (b) 'none' FSDP vs 'none' DP on a loss with exact sums, {FSDP_LINEAR_STEPS} steps: "
          f"{lin['leaves_differing']} parameter leaves differ, worst {lin['worst'][0]:.3e} of "
          f"the leaf's largest |param| (tol {DIST_NONE_RTOL:.0e}; bit for bit expected)")
    if lin["worst"][0] > DIST_NONE_RTOL or any(r["linear_none_vs_dp"]["leaves_differing"]
                                               for r in ranks):
        _fail("[fsdp] (b) 'none' FSDP's parameters disagree with DP's on exact sums")
    print(f"  (b) checkpoint of the 'none' state at step {FSDP_CKPT_STEP} (gathered, written "
          f"by rank 0) in {none['checkpoint_s']:.2f} s, restored at world {DIST_WORLD} in "
          f"{none['restore_s']:.2f} s: the continued run's leaves differing from the "
          f"uninterrupted run's {[r['lanes']['none/float32']['restart_leaves_differing'] for r in ranks]}"
          f"; restored at world 2 (ranks 0, 1): leaves differing from the full leaves cut "
          f"{[r['lanes']['none/float32']['world2_leaves_differing'] for r in ranks[:2]]} of "
          f"{none['world2_leaves_cut']} cut")
    if any(r["lanes"]["none/float32"]["restart_leaves_differing"] for r in ranks) or any(
            r["lanes"]["none/float32"]["world2_leaves_differing"] for r in ranks[:2]) \
            or not none["world2_leaves_cut"]:
        _fail("[fsdp] (b) the checkpoint restart or the elastic restore is not exact")

    cfg = dlrm_criteo.config(reduced=False)
    kapi = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=True))
    plain = dlrm_criteo.api(cfg)
    auto_params = os.path.join(FSDP_DIR, "auto_params.pt")
    params = tree.tree_map(lambda x: x.to("cuda"), torch.load(auto_params))
    os.remove(auto_params)
    shutil.rmtree(os.path.join(FSDP_DIR, "ckpt"), ignore_errors=True)
    shape = Shape("bench", 1, B, "train")
    batches = [kapi.batch_fn(step, shape) for step in EVAL_STEPS]
    counts = _eval_run(torch, kapi, plain, params, batches, "fsdp auto f32", "qr_gather", 1,
                       table_bytes(params), torch.cuda.memory_allocated())
    del params
    secs = time.perf_counter() - t0
    print(f"  card: {card}; [fsdp] {secs:.1f} s")
    print(json.dumps({"fsdp_profile": {
        "card": card, "seconds": secs, "one": a,
        "four": ranks}}))
    return counts


# [serve_dist]: sharded serving (ROADMAP 16c) in a gloo world of 4 on cuda:0
SERVE_DIST_DIR = os.path.join(ROOT, "build", "serve_dist")
SERVE_DIST_CACHE_ROWS = 1 << 20
SERVE_DIST_CACHE_REQUESTS = 1024


def _sharded_lane(torch, label, cfg, qparams, placement, warm, main, single, cache=None):
    """Serve ``main`` through a sharded engine after ``warm`` with every
    launch count set to 0 just before and read just after; scores vs the
    single-device engine's (rank 0 passes them in ``single``)."""
    import numpy as np

    from repro_torch.dist import wire
    from repro_torch.serve.recsys import RecsysEngine

    engine = RecsysEngine(cfg, qparams, max_batch=256, batching="waves", device="cuda",
                          mesh_devices=DIST_WORLD, placement=placement, cache=cache)
    _serve_all(engine, warm)
    engine.reset_metrics()
    torch.cuda.synchronize()
    _zero_counts()
    wire.reset()
    t = time.perf_counter()
    scores = _serve_all(engine, main)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _read_counts()
    snap = wire.snapshot()
    m = engine.metrics()
    row = {"label": label, "waves": m["waves"], "requests": m["requests"],
           "buckets": m["buckets"], "wall_ms_per_wave": wall / max(m["waves"], 1) * 1e3,
           "qps": m["qps"], "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"], "counts": counts,
           "exchange_bytes": sum(b for leaf, b in snap["per_leaf"].items()
                                 if leaf.startswith("tables/")),
           "score_gather_bytes": snap["per_leaf"].get("_scores", 0.0),
           "finite": bool(np.isfinite(scores).all()),
           "checksum": float(scores.sum())}
    if single is not None:
        row["max_abs_vs_single"] = float(np.abs(scores - single).max())
    if cache is not None:
        from repro_torch.serve.recsys import _FEATURE_SHIFT
        keys, _ = cache.slot_items()
        feats = set((np.asarray(keys) >> _FEATURE_SHIFT).tolist())
        repl = set(np.flatnonzero(engine.placement.replicated_features(
            len(cfg.table_sizes))).tolist())
        row.update({"hit_rate": m["cache"]["hit_rate"], "cache_paths": m["cache_paths"],
                    "cached_features": sorted(feats),
                    "cached_replicated_only": bool(feats) and feats <= repl})
    del engine
    return row


def _single_scores(cfg, qparams, reqs):
    """The single-device engine's scores on the same stream (kernels on)."""
    from repro_torch.serve.recsys import RecsysEngine
    return _serve_all(RecsysEngine(cfg, qparams, max_batch=256, device="cuda"), reqs)


def _serve_dist_four(rank, world_size, plan_path, out_dir):
    """Rank ``rank`` of the gloo world of 4 on cuda:0: the full-width int8
    model and the [plan] model served sharded; results to ``out_dir``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import dlrm_criteo
    from repro_torch.dist.accounting import serve_wave_wire_bytes
    from repro_torch.dist.serve_placement import plan_placement
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.plan import MemoryPlan
    from repro_torch.serve.cache import DeviceHotRowCache
    from repro_torch.serve.quantize import memory_report, quantize_params

    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    res = {"rank": rank, "backend": dist.get_backend(), "lanes": {}}
    plan = MemoryPlan.load(plan_path)
    for name, cfg_plan in (("uniform", None), ("planned", plan)):
        base = dlrm_criteo.config(reduced=False, plan=cfg_plan) if cfg_plan is not None \
            else dlrm_criteo.config(reduced=False)
        cfg = dataclasses.replace(base, use_kernel=True)
        params = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        qparams = quantize_params(params, mode="int8")
        placement = plan_placement(qparams, world_size, plan=cfg_plan)
        rep = memory_report(params, qparams, placement=placement)
        del params
        warm, main = _serve_requests(cfg)
        single = _single_scores(cfg, qparams, main) if rank == 0 else None
        res[f"placement/{name}"] = {
            **placement.summary(),
            "sharded": [[e.feature, e.table_key, e.rows] for e in placement.sharded],
            "table_bytes_per_device": rep["placement"]["table_bytes_per_device"],
            "bound_bytes": ((cfg_plan.total_bytes if cfg_plan is not None
                             else placement.total_bytes()) // world_size
                            + placement.replicated_bytes() + placement.pad_bytes()),
            "wave_bytes": serve_wave_wire_bytes(placement, B // world_size, L)["total_bytes"]}
        torch.cuda.reset_peak_memory_stats()
        res["lanes"][name] = _sharded_lane(torch, name, cfg, qparams, placement, warm,
                                           main, single)
        res["lanes"][name]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        if name == "uniform":
            cache = DeviceHotRowCache(SERVE_DIST_CACHE_ROWS, device="cuda")
            res["lanes"]["uniform_cache"] = _sharded_lane(
                torch, "uniform cache", cfg, qparams, placement,
                main[:SERVE_DIST_CACHE_REQUESTS], main[:SERVE_DIST_CACHE_REQUESTS],
                None if single is None else single[:SERVE_DIST_CACHE_REQUESTS], cache=cache)
            del cache
        del qparams
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _serve_dist_launcher_start():
    """Start ``launch/serve.py --mesh-devices 4`` under torchrun, every rank
    on the card."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DIST_WORLD), "-m", "repro_torch.launch.serve", "--mesh-devices", str(DIST_WORLD),
           "--requests", "64", "--batch-size", "14"]
    BACKGROUND.start("serve_dist_launcher", cmd,
                     env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def _serve_dist_launcher(card):
    """The torchrun launcher's run, started with [dist]."""
    proc, secs = BACKGROUND.wait("serve_dist_launcher", 600)
    cmd = proc.args
    print(f"  $ torchrun --standalone --nproc_per_node {DIST_WORLD} -m repro_torch.launch.serve "
          + " ".join(cmd[8:]))
    for line in proc.stdout.strip().splitlines():
        print(f"    {line}")
    if proc.returncode != 0 or "placement: " not in proc.stdout \
            or "served 64 requests" not in proc.stdout:
        _fail(f"[serve_dist] the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"  launcher: exit 0 in {secs:.1f} s, started with [dist] | card: {card}")
    return secs


def serve_dist_full_width(torch, card):
    """The [serve_dist] phase: the full-width int8 model and the [plan]
    model served sharded over a gloo world of 4 on one card, then the
    launcher under torchrun; returns the launch counts of the served waves,
    summed over the ranks."""
    from repro_torch.dist import world

    t0 = time.perf_counter()
    plan_path = os.path.join(SERVE_DIST_DIR, "plan.json")
    for name in os.listdir(SERVE_DIST_DIR):
        if name != "plan.json":
            os.remove(os.path.join(SERVE_DIST_DIR, name))
    world.spawn(_serve_dist_four, DIST_WORLD, "gloo", plan_path, SERVE_DIST_DIR)
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(SERVE_DIST_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r in range(DIST_WORLD):    # plan.json stays: [analysis] certifies it
        os.remove(os.path.join(SERVE_DIST_DIR, f"rank{r}.json"))
    total = {name: 0 for name in _kernels()}
    r0 = ranks[0]
    for name in ("uniform", "planned"):
        p = r0[f"placement/{name}"]
        print(f"  {name}: placement over {p['n_devices']} ranks: threshold "
              f"{p['threshold_bytes']} B, {p['row_sharded']} row-sharded sub-tables "
              f"{[tuple(x) for x in p['sharded']]}, {p['replicated']} replicated "
              f"({p['replicated_bytes']} B), {p['pad_bytes']} B of row padding, "
              f"{p['table_bytes_per_device']} B per rank of {p['total_bytes']} (bound "
              f"{p['bound_bytes']}); the wave's exchange {p['wave_bytes']:.0f} B per rank at "
              f"{B // DIST_WORLD} requests per rank and bags of {L}")
        if p["table_bytes_per_device"] > p["bound_bytes"] or not p["row_sharded"]:
            _fail(f"[serve_dist] {name}: the placement shards nothing or breaks its bound")
    for lane in ("uniform", "uniform_cache", "planned"):
        rows = [r["lanes"][lane] for r in ranks]
        row = rows[0]
        waves = row["waves"]
        wave_bytes = r0[f"placement/{lane.split('_')[0]}"]["wave_bytes"]
        print(f"  {row['label']}: {row['requests']} requests in {waves} waves {row['buckets']}, "
              f"wall {row['wall_ms_per_wave']:.3f} ms per wave, qps {row['qps']:.1f}, p50 "
              f"{row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms; launches per rank "
              f"{[{k: v for k, v in x['counts'].items() if v} for x in rows]}; exchange bytes "
              f"per wave per rank {row['exchange_bytes'] / max(waves, 1):.0f} (accounted "
              f"{wave_bytes:.0f}); max |score - single device| "
              f"{row['max_abs_vs_single']:.3e} (tol {SCORE_TOL:.0e}); peak memory per rank "
              f"{[x.get('peak_memory_bytes') for x in rows]} B | {card}")
        if "hit_rate" in row:
            print(f"    cache: hit rate {row['hit_rate']:.4f}, paths {row['cache_paths']}, "
                  f"cached features {row['cached_features']} (replicated only: "
                  f"{row['cached_replicated_only']})")
            if not (row["hit_rate"] > 0 and row["cached_replicated_only"]):
                _fail("[serve_dist] the sharded cache saw no hits or cached a sharded feature")
        if not all(x["finite"] for x in rows) or len({x["checksum"] for x in rows}) != 1:
            _fail(f"[serve_dist] {lane}: scores not finite or not the same on every rank")
        if not row["max_abs_vs_single"] <= SCORE_TOL:
            _fail(f"[serve_dist] {lane}: sharded scores disagree with the single-device engine")
        if any(x["exchange_bytes"] != waves * wave_bytes for x in rows) \
                or any(tuple(b) != (B, L) for b in row["buckets"]):
            _fail(f"[serve_dist] {lane}: recorded exchange bytes are not the accounted "
                  f"{wave_bytes:.0f} per wave")
        for i, x in enumerate(rows):
            # per wave: one grouped K4 over the replicated features, one K2
            _check_counts(f"serve_dist {lane} rank {i}", x["counts"],
                          {"fused_serve_pool": waves, "dot_interaction": waves})
            _add_counts(total, x["counts"])
    launcher_s = _serve_dist_launcher(card)
    secs = time.perf_counter() - t0
    print(f"  card: {card}; [serve_dist] {secs:.1f} s")
    print(json.dumps({"serve_dist_profile": {"card": card, "seconds": secs,
                                             "launcher_s": launcher_s, "ranks": ranks}}))
    return total


# [analysis]: the port's static analyzer on the card (ROADMAP 17)
ANALYSIS_DIR = os.path.join(ROOT, "build", "analysis")
ANALYSIS_WORLD = 4              # WIRE-001's gloo ranks, all on cuda:0
ANALYSIS_KERNELS = ("fused_serve_pool", "dot_interaction", "qr_gather", "qr_gather_quant",
                    "qr_embedding_bag")
FULL_WIDTH_CATEGORIES = 33_762_577   # the 26 Kaggle tables


def _analysis_cli(plan_path, report_path):
    """``python -m repro_torch.analysis --device cuda --world 4 --plan ...
    --format json --out ...``, run in this process (``cli.run`` is what the
    module's ``main`` calls) so the launch counters see ACC-002's kernels;
    its JSON goes to a file beside the report.  Returns (exit code, the
    report, the run's launch counts)."""
    import contextlib

    from repro_torch.analysis.cli import run

    argv = ["--root", ROOT, "--device", "cuda", "--world", str(ANALYSIS_WORLD), "--plan",
            plan_path, "--format", "json", "--out", report_path]
    _zero_counts()
    with open(os.path.join(ANALYSIS_DIR, "stdout.json"), "w") as f, \
            contextlib.redirect_stdout(f):
        rc = run(argv)
    counts = _read_counts()
    with open(report_path) as f:
        return rc, json.load(f), counts


def _analysis_jit_full_width(torch):
    """JIT-002 on the full-width int8 DLRM-Criteo engine of [serve]
    (``max_batch=256``): the canonical stream, its ids drawn over the 26
    Kaggle table sizes, twice."""
    from repro_torch.analysis.jit_audit import replay_and_audit
    from repro_torch.configs import dlrm_criteo
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import quantize_params
    from repro_torch.serve.recsys import RecsysEngine

    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    qparams = quantize_params(dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                                        "cuda"), mode="int8")
    engine = RecsysEngine(cfg, qparams, max_batch=256, batching="continuous")
    _zero_counts()
    findings, tel = replay_and_audit(engine)
    counts = _read_counts()
    return findings, tel, counts


def _analysis_injected_start():
    """Start the injected WIRE-001 run: ``REPRO_ANALYSIS_INJECT=wire python
    -m repro_torch.analysis --device cuda --world 4 --select WIRE-001``,
    which must exit 1."""
    env = dict(os.environ, REPRO_ANALYSIS_INJECT="wire", PYTHONPATH=os.path.join(ROOT, "src"))
    BACKGROUND.start("analysis_injected",
                     [sys.executable, "-m", "repro_torch.analysis", "--device", "cuda",
                      "--world", str(ANALYSIS_WORLD), "--select", "WIRE-001"], env=env)


def analysis_full_width(torch, card):
    """The [analysis] phase: the analyzer's ten passes on the card (ACC-002
    over the five kernels, WIRE-001 in a gloo world of 4 on cuda:0, JIT-002
    on the small engine, INJ-001 over the 16 swept plans and the full-width
    plan [plan] solved), JIT-002 again on the full-width engine, the
    injected WIRE-001 run, and the report rendered by
    ``benchmarks/summary_md.py``.  Returns the launch counts of the CLI run
    and of the full-width replay."""
    t0 = time.perf_counter()
    os.makedirs(ANALYSIS_DIR, exist_ok=True)
    plan_path = os.path.join(SERVE_DIST_DIR, "plan.json")
    report_path = os.path.join(ANALYSIS_DIR, "report.json")
    rc, rep, counts = _analysis_cli(plan_path, report_path)
    cli_s = time.perf_counter() - t0
    for p in rep["passes"]:
        print(f"  {p['id']} ({p['name']}): {p['findings']} finding(s) in {p['seconds']} s")
    for f in rep["findings"]:
        print(f"    {f['rule']} {f['path']}:{f['line']} {f['message']}")
    if rc != 0 or not rep["ok"]:
        _fail(f"[analysis] the analyzer exited {rc} with {rep['counts']}")
    if {p["id"] for p in rep["passes"]} != {
            "ACC-001", "JIT-001", "OBS-001", "DET-001", "EXC-001", "DON-001", "ACC-002",
            "WIRE-001", "JIT-002", "INJ-001"}:
        _fail("[analysis] the report does not hold the ten passes")
    notes = {p["id"]: p["notes"] for p in rep["passes"]}
    progs = notes["ACC-002"]["programs"]
    by_kernel = {k: sum(r.get("launches", 0) for r in progs if r["kernel"] == k)
                 for k in ANALYSIS_KERNELS}
    for r in progs:
        print(f"    ACC-002 {r['name']}: |err| / magnitude {r['program_rel_err']:.3e}"
              + (f", at L=16 D=128 {r['audit_rel_err']:.3e} (bf16 running sum "
                 f"{r['control_rel_err']:.3e}, rtol {AUDIT_RTOL})" if "audit_rel_err" in r
                 else "") + (f", {r['launches']} launch(es)" if "launches" in r else ""))
    print(f"  launches (analysis CLI): {counts}; ACC-002's by kernel {by_kernel}")
    if any(by_kernel[k] < 1 or counts[k] < by_kernel[k] for k in ANALYSIS_KERNELS):
        _fail(f"[analysis] ACC-002 did not launch every kernel: {by_kernel}")
    wire = notes["WIRE-001"]
    for r in wire["exchanges"]:
        print(f"    WIRE-001 {r['name']}: {r['intercepted_bytes']:.0f} B intercepted, "
              f"{r['wire_bytes']:.0f} B recorded, {r['closed_form_bytes']:.0f} B closed form, "
              f"{r['calls']} calls, {r['ranks']} ranks")
    if wire["world"] != ANALYSIS_WORLD or len(wire["exchanges"]) != 8:
        _fail("[analysis] WIRE-001 did not run its 8 exchanges in a world of 4")
    inj = notes["INJ-001"]
    rel = os.path.relpath(plan_path, ROOT)
    full = [r for r in inj["plans"] if r["plan"] == rel]
    swept = [r for r in inj["plans"] if r["plan"].startswith("analysis://plan/")]
    print(f"  INJ-001: {inj['tables_certified']} tables certified, "
          f"{inj['exact_certificates']} exactly, over {len(inj['plans'])} plans")
    if len(swept) != 16 or any(r["exact"] != r["tables"] for r in swept) or len(full) != 1 \
            or full[0]["tables"] != 26 or full[0]["exact"] != 26 \
            or sum(c["size"] for c in full[0]["certificates"]) != FULL_WIDTH_CATEGORIES:
        _fail("[analysis] INJ-001 did not certify the 16 swept plans and the full-width "
              "plan's 26 tables exactly")
    jit = notes["JIT-002"]
    print(f"  JIT-002 (small engine): {jit['first_pass']['per_program']} for buckets "
          f"{jit['buckets_seen']}, replay total {jit['replay']['total']}")

    t = time.perf_counter()
    found, tel, jcounts = _analysis_jit_full_width(torch)
    jit_s = time.perf_counter() - t
    waves = tel["waves"]
    print(f"  JIT-002 full width: {tel['first_pass']['per_program']} for buckets "
          f"{tel['buckets_seen']} (bounds {tel['bounds']}), replay total "
          f"{tel['replay']['total']}, {tel['requests']} requests in {waves} waves, "
          f"{jit_s:.1f} s")
    if found or tel["replay"] != tel["first_pass"]:
        _fail(f"[analysis] JIT-002 at full width: {[f.message for f in found]}")
    _check_counts("analysis JIT-002 full width", jcounts,
                  {"fused_serve_pool": waves, "dot_interaction": waves})

    proc, inject_s = BACKGROUND.wait("analysis_injected", 600)
    print(f"  injected WIRE-001 run: exit {proc.returncode}, "
          f"{proc.stdout.count('WIRE-001')} finding(s), {inject_s:.1f} s, started with [dist]")
    if proc.returncode != 1 or "drifted apart" not in proc.stdout:
        _fail(f"[analysis] the injected WIRE-001 run exited {proc.returncode}: "
              f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    md = subprocess.run([sys.executable, "-m", "benchmarks.summary_md", "--analysis",
                         report_path, "--no-bench"], cwd=ROOT, capture_output=True, text=True,
                        timeout=120)
    if md.returncode != 0 or "**PASS**" not in md.stdout:
        _fail(f"[analysis] summary_md exited {md.returncode}: {md.stderr[-2000:]}")
    print("  " + "\n  ".join(md.stdout.strip().splitlines()[:16]))
    secs = time.perf_counter() - t0
    print(f"  card: {card}; [analysis] {secs:.1f} s (the CLI run {cli_s:.1f} s, full-width "
          f"JIT-002 {jit_s:.1f} s, injected run {inject_s:.1f} s)")
    return counts, jcounts


# [lm]: the full-width TinyLlama-1.1B (ROADMAP 18a) served and trained on the
# card, its QR vocabulary (8,000 + 4 rows x 2,048, bf16, mult) looked up
# through K1 when serving
LM_PARAMS = 1_050_904_576
LM_PARAM_BYTES = 2_101_809_152
# the serving queue: (prompt length, requests) buckets, served 16 per wave
LM_QUEUE = ((512, 32), (128, 16))
LM_BATCH, LM_MAX_LEN, LM_NEW_TOKENS = 16, 1024, 32
LM_LONG_PROMPT = 8192        # 16 q-blocks x 8 kv-blocks of the flash loop
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 10, 4, 256
# decode against teacher forcing, bf16: the decode attention (bf16
# probabilities times the bf16 cache, a bf16 product) and flash (the same
# probabilities, an f32 product rounded once) compute one function with
# other roundings.  The f32 check below measures the same two paths' gap at
# 2 layers in f32; the bf16 tolerance scales it by the ratio of the two
# unit roundoffs (2^-8 / 2^-24 = 2^16) and by sqrt(22 / 2) for the depth
# (the layers' roundoff differences add as a random walk; at width 256 on
# the CPU the bf16 gap grew 1.7x from 2 to 22 layers), relative to the
# largest teacher-forced |logit|
LM_ROUNDOFF_RATIO = 2.0 ** 16
# card against CPU in f32 (2 layers at full width, TF32 off): logits within
# 1e-3 of the largest |logit|, loss within 1e-5, gradients within GRAD_TOL of
# each leaf's largest |g| ([train]'s form)
LM_F32_LOGIT_TOL, LM_F32_LOSS_TOL = 1e-3, 1e-5


def _lm_counting(torch, fn, calls, record=None):
    """``fn`` wrapped for the engine: each call synchronised and timed, its
    kernel launches read from the counters, and, for the first wave's
    ``LM_NEW_TOKENS`` calls (one prefill and the decode steps), its token
    input and last logits kept in ``record``."""
    def call(*args):
        before = _read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = _read_counts()
        calls.append((ms, {k: after[k] - before[k] for k in after}))
        if record is not None and len(record) < LM_NEW_TOKENS:
            record.append((args[0].clone(), logits[:, -1].clone()))
        return logits, cache
    return call


def _lm_fns():
    """The decoder-only LM's serving functions as ``_ssm_fns`` gives the SSM
    family's: (make_cache, prefill, decode_step, final-normed forward)."""
    from repro_torch.models import lm

    return (lm.make_decode_cache, lm.prefill, lm.decode_step,
            lambda p, h, cfg: lm.forward_hidden(p, h, cfg)[0])


def _lm_engine(torch, cfg, params, calls, record, batch, max_len, fns=None):
    from repro_torch.serve.engine import ServeEngine

    make_cache, prefill, decode, _ = fns or _lm_fns()
    return ServeEngine(
        prefill_fn=_lm_counting(torch, lambda t, c: prefill(params, t, c, cfg), calls, record),
        decode_fn=_lm_counting(torch, lambda t, pos, c: decode(params, t, pos, c, cfg),
                               calls, record),
        make_cache_fn=lambda b, ml: make_cache(cfg, b, ml, "cuda"),
        batch_size=batch, max_len=max_len, device="cuda")


def _lm_prompts(torch, gen, vocab):
    out = []
    for plen, n in LM_QUEUE:
        ids = torch.randint(0, vocab, (n, plen), generator=gen, device="cuda")
        out += ids.tolist()
    return out


def _lm_check_calls(calls, waves, phase="[lm]"):
    """Every prefill and decode call launched exactly one K1 and nothing
    else; ``waves`` prefills among them."""
    bad = [c for _, c in calls if c != {**{k: 0 for k in c}, "qr_gather": 1}]
    if bad:
        _fail(f"{phase} a serving call launched {bad[0]}, expected one K1 (qr_gather) only")
    return {"calls": len(calls), "prefills": waves, "decode_steps": len(calls) - waves,
            "qr_gather_per_call": 1}


def _lm_decode_tol(f32_gap_rel, n_layers, f32_layers=2):
    """The bf16 decode-vs-teacher-forcing tolerance, relative to the
    largest teacher-forced |logit|, from the f32 check's relative gap at
    ``f32_layers`` layers."""
    return f32_gap_rel * LM_ROUNDOFF_RATIO * math.sqrt(n_layers / f32_layers)


def _lm_teacher(torch, lm, cfg, params, wave, tol_rel, forward=None):
    """The recorded wave (prompt, then each decode input, with the logits each
    call returned) against the plain teacher-forced forward on the card:
    ``embed.apply`` → ``forward`` (the final-normed hidden states,
    ``forward_hidden`` by default) → the LM head.  Returns the K1 vs plain
    embedding |diff|, the prefill logits |diff|, and the decode steps' max
    |diff| beside ``tol_rel`` of the largest teacher-forced |logit|, and
    the greedy agreement."""
    from repro_torch.nn.layers import dense

    forward = forward or _lm_fns()[3]
    prompts, pre_logits = wave[0]
    with torch.inference_mode():
        emb_diff = _max_err(torch, lm.embed_serving(params, prompts, cfg),
                            lm.embed_tokens(params, prompts, cfg))
        h = forward(params, lm.embed_tokens(params, prompts, cfg), cfg)
        plain = dense(params["lm_head"], h[:, -1:], cfg.cdtype).to(torch.float32)[:, -1]
        pre_diff = _max_err(torch, pre_logits, plain)
        if len(wave) == 1:
            return emb_diff, pre_diff, None
        seq = torch.cat([prompts] + [tok for tok, _ in wave[1:]], dim=1)
        h = forward(params, lm.embed_tokens(params, seq, cfg), cfg)
        plen = prompts.shape[1]
        tf_logits = dense(params["lm_head"], h[:, plen:], cfg.cdtype).to(torch.float32)
    dec = torch.stack([lg for _, lg in wave[1:]], dim=1)           # (B, steps, V)
    scale = float(tf_logits.abs().max())
    tol = tol_rel * scale
    dec_diff = _max_err(torch, dec, tf_logits)
    top = torch.topk(tf_logits, 2, dim=-1).values
    clear = (top[..., 0] - top[..., 1]) > tol
    agree = dec.argmax(-1) == tf_logits.argmax(-1)
    gaps = top[..., 0] - top[..., 1]
    return emb_diff, pre_diff, {
        "steps": dec.shape[1], "max_abs_diff": dec_diff, "max_abs_teacher_logit": scale,
        "rel_diff": dec_diff / scale, "tol_rel": tol_rel, "tol_abs": tol,
        "argmax_agree": int(agree.sum()), "positions": agree.numel(),
        "clear_positions": int(clear.sum()), "clear_disagree": int((clear & ~agree).sum()),
        "largest_gap_where_greedy_differs": float(gaps[~agree].max()) if (~agree).any() else 0.0,
        "median_top2_gap": float(gaps.median())}


def _lm_f32_vs_cpu(torch, tiny, lm, phase="[lm]"):
    """The same widths at 2 layers in f32, TF32 off: one prefill and 4
    decode steps, and one ``loss_fn`` value-and-grad, card against CPU; and
    the decode-vs-teacher-forcing gap at f32.  ``tiny`` is the arch's config
    module, ``phase`` names the phase in the messages."""
    from repro_torch import tree
    from repro_torch.nn.layers import dense
    from repro_torch.train.loop import value_and_grad

    if torch.backends.cuda.matmul.allow_tf32:
        _fail(f"{phase} TF32 is on for f32 matrix products")
    cfg = dataclasses.replace(tiny.config(), n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    host = lm.init(torch.Generator().manual_seed(3), cfg, "cpu")
    card = tree.tree_map(lambda t: t.to("cuda"), host)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (2, 128), generator=gen)
    toks = [torch.randint(0, cfg.vocab, (2, 1), generator=gen) for _ in range(4)]
    out = {}
    with torch.inference_mode():
        for name, params, dev in (("cpu", host, "cpu"), ("card", card, "cuda")):
            cache = lm.make_decode_cache(cfg, 2, 160, dev)
            logits, cache = lm.prefill(params, prompts.to(dev), cache, cfg)
            steps = [logits[:, -1]]
            for i, tok in enumerate(toks):
                logits, cache = lm.decode_step(params, tok.to(dev), 128 + i, cache, cfg)
                steps.append(logits[:, -1])
            out[name] = torch.stack(steps, 1).cpu()
        # the card's decode steps against its teacher-forced forward (positions
        # 128..131; position 127 is the prefill's)
        seq = torch.cat([prompts] + toks, 1).to("cuda")
        h, _ = lm.forward_hidden(card, lm.embed_tokens(card, seq, cfg), cfg)
        teacher = dense(card["lm_head"], h[:, 127:], cfg.cdtype).cpu()
    scale = float(out["cpu"].abs().max())
    logit_rel = float((out["card"] - out["cpu"]).abs().max()) / scale
    dec_gap = float((out["card"][:, 1:] - teacher[:, 1:]).abs().max())
    dec_rel = dec_gap / float(teacher.abs().max())
    batch = tiny.api(cfg, device="cpu").batch_fn(0, _lm_shape(64, 2))
    (loss, _), grads = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))(host, batch)
    (card_loss, _), card_grads = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))(
        card, {k: v.to("cuda") for k, v in batch.items()})
    worst, where = 0.0, ""
    for (path, g), cg in zip(tree.flatten_with_path(grads), tree.leaves(card_grads)):
        s = float(g.abs().max())
        rel = float((cg.cpu() - g).abs().max()) / s if s else float(cg.abs().max())
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    loss_diff = abs(float(card_loss) - float(loss))
    res = {"logits_rel_diff": logit_rel, "loss": float(loss), "card_loss": float(card_loss),
           "loss_diff": loss_diff, "worst_grad_rel": worst, "worst_grad_leaf": where,
           "decode_vs_teacher_f32_abs": dec_gap, "decode_vs_teacher_f32_rel": dec_rel}
    print(f"  f32, 2 layers at full width, card vs CPU: prefill + 4 decode steps' logits "
          f"{logit_rel:.3e} of the largest |logit| (tol {LM_F32_LOGIT_TOL:.0e}); loss "
          f"{float(card_loss):.7f} vs {float(loss):.7f} (|diff| {loss_diff:.3e}, tol "
          f"{LM_F32_LOSS_TOL:.0e}); worst gradient leaf {where} {worst:.3e} of its largest |g| "
          f"(tol {GRAD_TOL:.0e}); decode vs teacher forcing at f32: max |diff| {dec_gap:.3e} = "
          f"{dec_rel:.3e} of the largest |logit|")
    if not (logit_rel <= LM_F32_LOGIT_TOL and loss_diff <= LM_F32_LOSS_TOL * abs(float(loss))
            and worst <= GRAD_TOL):
        _fail(f"{phase} the f32 model on the card disagrees with the CPU")
    return res


def _lm_shape(seq, batch):
    from repro_torch.configs.common import Shape

    return Shape("lm", seq, batch, "train")


def _lm_train(torch, tiny, lm, cfg, card):
    """``LM_TRAIN_STEPS`` Adam steps through ``Trainer`` at full width on the
    port's LM stream (plain path, flash backward), timing and memory; then one wave
    served from the trained parameters through K1, and the refusal under
    grad.  Returns the profile and the wave's launch counts."""
    from repro_torch import tree
    from repro_torch.train.loop import TrainConfig, Trainer, init_state, make_train_step

    api = tiny.api(cfg)
    shape = _lm_shape(LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = init_state(api.init(torch.Generator(device="cuda").manual_seed(5)), api.optimizer)
    step_fn = make_train_step(api.loss_fn, api.optimizer)
    trainer = Trainer(step_fn, TrainConfig(num_steps=LM_TRAIN_STEPS, log_every=1),
                      batch_at=lambda s: api.batch_fn(s, shape))
    state, history = trainer.run(state)
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    losses = [x for _, x in history]
    tail = sum(losses[-5:]) / 5
    if len(losses) != LM_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        _fail("[lm] training losses are not all finite")
    if not tail < losses[0]:
        _fail(f"[lm] the loss did not fall: last 5 steps {tail:.5f} vs step 0 {losses[0]:.5f}")
    opt_bytes = sum(t.numel() * t.element_size() for s in state["opt"] for t in s.values())
    batches = [api.batch_fn(s, shape) for s in range(LM_TRAIN_STEPS, LM_TRAIN_STEPS + 6)]
    walls = []
    for b in batches[:3]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall_ms = sorted(walls)[1] * 1e3
    held = {"state": state}

    def steps():
        for b in batches[3:]:
            held["state"], _ = step_fn(held["state"], b)

    del state
    _, dev, ops_by_name = _profile_device(steps)
    device_ms = sum(dev.values()) / 3 / 1e3
    prof = {"card": card, "steps": LM_TRAIN_STEPS, "batch": LM_TRAIN_BATCH,
            "seq_len": LM_TRAIN_SEQ, "loss_step_0": losses[0], "loss_last_5": tail,
            "losses": losses, "run_s_with_init": run_s, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
            "device_ops_per_step": sum(ops_by_name.values()) / 3,
            "top_device_ms_per_step": _top_ms(dev, 3, k=8), "peak_memory_bytes": peak,
            "peak_above_phase_start_bytes": peak - base, "adam_state_bytes": opt_bytes,
            "straggler_events": len(trainer.straggler_events)}
    print(f"  {LM_TRAIN_STEPS} Adam(3e-4) steps at B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ} in "
          f"{run_s:.2f} s with init: loss {losses[0]:.5f} at step 0, {tail:.5f} over the last 5 "
          f"| per step wall {wall_ms:.2f} ms, device {device_ms:.2f} ms (busy "
          f"{prof['device_busy_share']:.3f}), {prof['device_ops_per_step']:.0f} device "
          f"operations | peak {peak} B ({peak - base} B above the phase's start; Adam's f32 "
          f"state {opt_bytes} B)")
    print(f"  top device ms per training step: {prof['top_device_ms_per_step']}")

    # one wave from the trained parameters through K1, then the refusal
    params = held["state"]["params"]
    del held
    calls = []
    engine = _lm_engine(torch, cfg, params, calls, None, 8, 160)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for p in torch.randint(0, cfg.vocab, (8, 128), generator=gen, device="cuda").tolist():
        engine.submit(p, max_new_tokens=8)
    _zero_counts()
    done = engine.run_until_drained()
    counts = _read_counts()
    _lm_check_calls(calls, 1)
    if len(done) != 8 or not all(len(r.output) == 8 and all(0 <= x < cfg.vocab for x in r.output)
                                 for r in done.values()):
        _fail("[lm] the trained model's wave did not complete")
    live = tree.tree_map(lambda x: x.detach().requires_grad_(True), params)
    try:
        lm.prefill(live, torch.zeros((1, 4), dtype=torch.long, device="cuda"),
                   lm.make_decode_cache(cfg, 1, 8, "cuda"), cfg)
    except RuntimeError as err:
        if "requires grad" not in str(err):
            raise
        print(f"  serving with parameters that require grad, outside inference_mode: raised "
              f"({str(err)[:60]}...)")
    else:
        _fail("[lm] K1 accepted parameters that require grad outside inference_mode")
    print(f"  trained model: one wave of 8 served through K1 ({len(calls)} calls, one K1 each)")
    return prof, counts


LM_LAUNCHERS = (("lm_serve_launcher", ["repro_torch.launch.serve", "--arch", "tinyllama-1.1b"]),
                ("lm_train_launcher", ["repro_torch.launch.train", "--arch", "tinyllama-1.1b",
                                       "--steps", "5"]))


def _lm_launchers_start():
    """Start the serving and training launchers on the LM, side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for name, args in LM_LAUNCHERS:
        BACKGROUND.start(name, [sys.executable, "-m", *args], env=env)


def _lm_launchers(torch, card):
    """The two launchers' runs, started with [dist]; both must exit 0."""
    secs = 0.0
    for name, args in LM_LAUNCHERS:
        proc, s = BACKGROUND.wait(name, 600)
        secs = max(secs, s)
        print("  $ python -m " + " ".join(args))
        for line in proc.stdout.strip().splitlines()[:6]:
            print(f"    {line}")
        if proc.returncode != 0:
            _fail(f"[lm] {' '.join(args)} exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"  the two launchers in {secs:.1f} s, side by side, started with [dist]")
    return secs


def lm_full_width(torch, card):
    """The [lm] phase (ROADMAP 18a): the full-width TinyLlama-1.1B served
    through ``ServeEngine`` with its QR vocabulary through K1, held against
    the plain route and teacher forcing, a long prompt, the f32 model
    against the CPU, 10 Adam steps through ``Trainer``, and the launchers.
    Returns the launch counts of the paths and K1's LM inputs for [time]."""
    from repro_torch.configs import tinyllama_1_1b as tiny
    from repro_torch.models import lm

    t0 = time.perf_counter()
    cfg = tiny.config()
    base = torch.cuda.memory_allocated()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    n = lm.num_params(params)
    nbytes = _tree_bytes(params)
    print(f"  {cfg.name}: vocab {cfg.vocab}, d {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {cfg.d_head}, d_ff {cfg.d_ff}, "
          f"QR c={cfg.embedding.num_collisions} {cfg.embedding.op} vocabulary "
          f"{tuple(params['embed']['table_0'].shape)} + {tuple(params['embed']['table_1'].shape)}"
          f", {cfg.param_dtype}: {n:,} parameters, {nbytes:,} B")
    if (n, nbytes) != (LM_PARAMS, LM_PARAM_BYTES):
        _fail(f"[lm] {n} parameters / {nbytes} B, expected {LM_PARAMS} / {LM_PARAM_BYTES}")

    # the queue: 32 prompts of 512 and 16 of 128, greedy, 32 new tokens each
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = _lm_prompts(torch, gen, cfg.vocab)
    calls, record = [], []
    engine = _lm_engine(torch, cfg, params, calls, record, LM_BATCH, LM_MAX_LEN)
    for p in prompts:
        engine.submit(p, max_new_tokens=LM_NEW_TOKENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    wave_ms = []
    while engine._queue:
        t = time.perf_counter()
        engine.step()
        wave_ms.append((time.perf_counter() - t) * 1e3)
    counts = {"lm": _read_counts()}
    peak = torch.cuda.max_memory_allocated()
    waves, serve_s, done = len(wave_ms), sum(wave_ms) / 1e3, engine.completed
    launch = _lm_check_calls(calls, waves)
    tokens = sum(len(r.output) for r in done.values())
    if len(done) != len(prompts) or any(
            len(r.output) != LM_NEW_TOKENS or not all(0 <= x < cfg.vocab for x in r.output)
            for r in done.values()):
        _fail("[lm] not every request completed with its tokens in range")
    if len(calls) != waves * LM_NEW_TOKENS or counts["lm"]["qr_gather"] != len(calls) \
            or sum(counts["lm"].values()) != len(calls):
        _fail(f"[lm] launches {counts['lm']} for {len(calls)} serving calls in {waves} waves")
    # each wave is one prefill, then LM_NEW_TOKENS - 1 decode steps
    pre_ms = [ms for j, (ms, _) in enumerate(calls) if j % LM_NEW_TOKENS == 0]
    dec_ms = sorted(ms for j, (ms, _) in enumerate(calls) if j % LM_NEW_TOKENS)
    print(f"  served {len(done)} requests ({', '.join(f'{n} of {p} tokens' for p, n in LM_QUEUE)}"
          f") in {waves} waves of {LM_BATCH}: {tokens} tokens in {serve_s:.2f} s = "
          f"{tokens / serve_s:.1f} tokens/s | prefill ms per wave {[round(x, 2) for x in pre_ms]}"
          f" | decode ms per step: median {dec_ms[len(dec_ms) // 2]:.2f}, min {dec_ms[0]:.2f}, "
          f"max {dec_ms[-1]:.2f} | peak memory {peak} B ({peak - base} B above the phase's "
          "start)")
    print(f"  launches: one K1 per call on all {len(calls)} calls ({waves} prefills, "
          f"{len(calls) - waves} decode steps), no other kernel: {counts['lm']}")

    # the lookup is one device operation; a decode step's device time and ops
    dec_tokens = torch.randint(0, cfg.vocab, (LM_BATCH, 1), generator=gen, device="cuda")
    with torch.inference_mode():
        plen = LM_QUEUE[-1][0]
        cache = lm.make_decode_cache(cfg, LM_BATCH, LM_MAX_LEN, "cuda")
        lm.prefill(params, torch.randint(0, cfg.vocab, (LM_BATCH, plen), generator=gen,
                                         device="cuda"), cache, cfg)
        pos = [plen]

        def decode(k=5):
            for _ in range(k):
                lm.decode_step(params, dec_tokens, pos[0], cache, cfg)
                pos[0] += 1

        decode(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode(5)
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t) / 5 * 1e3
        _, dev, ops = _profile_device(decode)
        lookup_ops = _device_ops_per_call(torch, lambda: lm.embed_serving(params, dec_tokens,
                                                                          cfg))
    if lookup_ops["ops"] != 1:
        _fail(f"[lm] the token lookup took {lookup_ops['ops']} device operations per call, "
              "expected the one K1 launch")
    dec_dev = sum(dev.values()) / 5 / 1e3
    dec_ops = sum(ops.values()) / 5
    print(f"  the token lookup: {lookup_ops['ops']:.0f} device operation per call "
          f"{lookup_ops['by_name']}; a decode step of {LM_BATCH}: wall {dec_wall:.2f} ms, device "
          f"{dec_dev:.3f} ms (busy {dec_dev / dec_wall:.3f}), {dec_ops:.0f} device operations; "
          f"top {_top_ms(dev, 5, k=6)}")

    # K1 and the prefill logits bit for bit against the plain route; decode
    # against teacher forcing, within the tolerance the f32 check gives
    f32 = _lm_f32_vs_cpu(torch, tiny, lm)
    tol_rel = _lm_decode_tol(f32["decode_vs_teacher_f32_rel"], cfg.n_layers)
    emb_diff, pre_diff, dec = _lm_teacher(torch, lm, cfg, params, record, tol_rel)
    print(f"  wave 0: K1 vs embed.apply max |diff| {emb_diff}; prefill logits vs the plain "
          f"teacher-forced forward max |diff| {pre_diff}; decode ({dec['steps']} steps) vs "
          f"teacher forcing max |diff| {dec['max_abs_diff']:.4f} = {dec['rel_diff']:.4f} of the "
          f"largest |logit| (tol {tol_rel:.4f} = the f32 gap x 2^16 x sqrt({cfg.n_layers} / 2))"
          f"; greedy agrees on "
          f"{dec['argmax_agree']}/{dec['positions']}, on {dec['clear_positions']} positions the "
          f"top-2 gap exceeds the tolerance and {dec['clear_disagree']} of them disagree (the "
          f"largest teacher-forced top-2 gap where greedy differs "
          f"{dec['largest_gap_where_greedy_differs']:.4f}, median gap "
          f"{dec['median_top2_gap']:.4f})")
    if emb_diff != 0 or pre_diff != 0:
        _fail("[lm] K1 or the prefill logits differ from the plain route")
    if dec["rel_diff"] > tol_rel or dec["clear_disagree"]:
        _fail("[lm] decode disagrees with teacher forcing beyond the tolerance")
    del record, engine

    # one long prompt: 8,192 tokens, 16 q-blocks x 8 kv-blocks
    long_ids = torch.randint(0, cfg.vocab, (1, LM_LONG_PROMPT), generator=gen, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.inference_mode():
        cache = lm.make_decode_cache(cfg, 1, LM_LONG_PROMPT, "cuda")
        long_logits, cache = lm.prefill(params, long_ids, cache, cfg)
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t) * 1e3
    long_peak = torch.cuda.max_memory_allocated() - held
    score_bytes = cfg.n_heads * LM_LONG_PROMPT * LM_LONG_PROMPT * 4
    print(f"  one {LM_LONG_PROMPT}-token prompt: prefill {long_ms:.1f} ms, logits finite "
          f"{bool(torch.isfinite(long_logits).all())}; peak memory above the parameters "
          f"{long_peak} B (the cache {_tree_bytes(cache)} B) against one {cfg.n_heads} x "
          f"{LM_LONG_PROMPT} x {LM_LONG_PROMPT} f32 score matrix's {score_bytes} B")
    if not bool(torch.isfinite(long_logits).all()) or long_peak >= score_bytes:
        _fail("[lm] the long prompt's logits are not finite or its memory is not linear")
    k1_inputs = {"prefill": long_ids.reshape(-1, 1), "decode": dec_tokens,
                 "tables": (params["embed"]["table_0"], params["embed"]["table_1"])}
    del cache, long_logits

    train_prof, counts["lm_trained"] = _lm_train(torch, tiny, lm, cfg, card)
    launch_s = _lm_launchers(torch, card)
    prof = {"card": card, "parameters": n, "parameter_bytes": nbytes, "requests": len(done),
            "waves": waves, "tokens": tokens, "serve_s": serve_s, "tokens_per_s": tokens / serve_s,
            "prefill_ms_per_wave": pre_ms, "decode_ms_per_step_median":
            dec_ms[len(dec_ms) // 2], "decode_wall_ms": dec_wall,
            "decode_device_ms": dec_dev, "decode_device_ops": dec_ops,
            "decode_busy_share": dec_dev / dec_wall, "serve_peak_bytes": peak,
            "lookup_device_ops_per_call": lookup_ops["ops"], "launches": launch,
            "k1_vs_plain_max_abs_diff": emb_diff, "prefill_vs_plain_max_abs_diff": pre_diff,
            "decode_vs_teacher": dec, "long_prompt_ms": long_ms,
            "long_prompt_peak_above_params_bytes": long_peak, "score_matrix_bytes": score_bytes,
            "f32_vs_cpu": f32, "train": train_prof, "launchers_s": launch_s,
            "phase_s": time.perf_counter() - t0}
    print(json.dumps({"lm_profile": prof}))
    del params
    return counts, k1_inputs, emb_diff


# [moe]: the full-width DeepSeek-V2 (ROADMAP 18b, first part): MLA and a
# 160-expert top-6 MoE with 2 shared experts, served on the card with its QR
# vocabulary (25,600 + 4 rows x 5,120, bf16, mult) through K1.  The one cut
# is the depth: 4 of its 60 layers.
MOE_LAYERS = 4
MOE_PARAMS = 16_543_851_520         # jax.eval_shape of the reference's init at 4 layers
MOE_PARAM_BYTES = 33_094_256_640
# card against CPU in f32 at full width and 1 layer, on 2 x 32 tokens (64
# single-token groups: no route is dropped): routes agree except at a
# near-tie (the k-th and (k+1)-th router probabilities within 1e-4
# relative); the logits of agreeing tokens within 1e-3 of the largest
# |logit|; the aux loss within 1e-5 relative
MOE_F32_TOKENS = (2, 32)
MOE_NEAR_TIE, MOE_F32_LOGIT_TOL, MOE_AUX_TOL = 1e-4, 1e-3, 1e-5
# 10 Adafactor steps at full width, 2 layers, B=4, S=256, at lr 1e-4: the
# arch's default, Adafactor(1e-3) (the reference's default_optimizer above
# 30 B parameters), moves every weight by about lr in its first steps (the
# factored second moment of one gradient gives updates of unit RMS), and at
# d_model 5,120 that overturns the random weights: its loss rose from 12.05
# to 14.76 over these 10 steps on an H100 80GB HBM3 at 700 W
MOE_TRAIN_STEPS, MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 10, 2, 4, 256
MOE_TRAIN_LR = 1e-4
# decode against teacher forcing: 4 rows of the first wave, replayed at a
# capacity that drops nothing (the served capacity drops routes in prefill
# and in the teacher-forced forward, by design, and the dropped rows
# change every later position's context)
MOE_TEACHER_ROWS = 4
# Arctic at full width and 1 of its 35 layers: 128 experts top-2 and the
# parallel dense FFN
ARCTIC_PARAMS, ARCTIC_PARAM_BYTES = 13_897_942_016, 27_797_719_040


class _RouteLog:
    """``repro_torch.nn.moe.route`` wrapped while the block runs: for each
    of its first ``limit`` calls (all when None), each token's top-k
    experts and which of its routes were kept under the capacity, in token
    order, and the router's probabilities when ``probs``."""

    def __init__(self, torch, limit=None, probs=False):
        self.torch, self.limit, self.probs, self.calls = torch, limit, probs, []

    def __enter__(self):
        from repro_torch.nn import moe

        real = self.real = moe.route

        def logged(params, xf, cfg, cap):
            r = real(params, xf, cfg, cap)
            if self.limit is None or len(self.calls) < self.limit:
                g, ng, k = r.idx.shape
                kept = self.torch.empty((g, ng * k), dtype=self.torch.bool, device=xf.device)
                kept.scatter_(1, r.order, r.dest < cfg.n_experts * cap)
                self.calls.append({"idx": r.idx.reshape(g * ng, k),
                                   "kept": kept.reshape(g * ng, k),
                                   "probs": r.probs.reshape(g * ng, -1) if self.probs else None})
            return r

        moe.route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import moe

        moe.route = self.real


def _same_sets(a, b):
    """Per token, whether two (..., k) expert lists hold the same experts."""
    return (a.sort(dim=-1).values == b.sort(dim=-1).values).all(dim=-1)


def _host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    _fail("[moe] /proc/meminfo has no MemAvailable")


def _moe_f32_vs_cpu(torch, ds, lm):
    """DeepSeek-V2 at full width and 1 layer in f32 (TF32 off), card
    against CPU on 2 x 32 tokens: routes, logits and the aux loss; then on
    the card, a prefill of 16 tokens and 16 decode steps (the absorbed MLA)
    against the teacher-forced forward (the materialised MLA) on the
    positions whose routes agree: the f32 gap the bf16 tolerance scales."""
    from repro_torch import tree
    from repro_torch.nn.layers import dense

    if torch.backends.cuda.matmul.allow_tf32:
        _fail("[moe] TF32 is on for f32 matrix products")
    cfg = dataclasses.replace(ds.config(), n_layers=1, param_dtype="float32",
                              compute_dtype="float32")
    need = lm.num_params(lm.init(torch.Generator(), cfg, "meta")) * 4
    avail = _host_available_bytes()
    print(f"  f32 check: the 1-layer model is {need} B in f32; the host has {avail} B available")
    if avail < 1.25 * need:
        _fail(f"[moe] the host has {avail} B available, the f32 1-layer model needs {need} B "
              "and its forward")
    card = lm.init(torch.Generator(device="cuda").manual_seed(3), cfg, "cuda")
    t = time.perf_counter()
    host = tree.tree_map(lambda x: x.cpu(), card)
    copy_s = time.perf_counter() - t
    b, s = MOE_F32_TOKENS
    seq = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(4))
    out = {}
    with torch.inference_mode():
        for name, params, dev in (("cpu", host, "cpu"), ("card", card, "cuda")):
            t = time.perf_counter()
            with _RouteLog(torch, probs=True) as log:
                h, aux = lm.forward_hidden(params, lm.embed_tokens(params, seq.to(dev), cfg), cfg)
                logits = dense(params["lm_head"], h, cfg.cdtype)
            out[name] = {"logits": logits.cpu(), "aux": float(aux),
                         **{k: v.cpu() for k, v in log.calls[0].items()},
                         "s": time.perf_counter() - t}
        half = s // 2
        cache = lm.make_decode_cache(cfg, b, s, "cuda")
        with _RouteLog(torch) as dlog:
            logits, cache = lm.prefill(card, seq[:, :half].cuda(), cache, cfg)
            steps = [logits[:, -1]]
            for i in range(half, s):
                logits, cache = lm.decode_step(card, seq[:, i:i + 1].cuda(), i, cache, cfg)
                steps.append(logits[:, -1])
    del card, host, cache
    torch.cuda.empty_cache()
    cpu, dev = out["cpu"], out["card"]
    k = cfg.moe.top_k
    agree = _same_sets(dev["idx"], cpu["idx"])
    top = cpu["probs"].sort(dim=-1, descending=True).values
    near = (top[:, k - 1] - top[:, k]) <= MOE_NEAR_TIE * top[:, k - 1]
    scale = float(cpu["logits"].abs().max())
    tok_diff = (dev["logits"] - cpu["logits"]).abs().amax(-1).reshape(-1)
    logit_rel = float(tok_diff[agree].max()) / scale if agree.any() else 0.0
    aux_rel = abs(dev["aux"] - cpu["aux"]) / abs(cpu["aux"])
    # decode (positions half-1 .. s-1) vs the card's teacher-forced logits
    dec = torch.stack(steps, 1).cpu()
    teacher = dev["logits"][:, half - 1:]
    t_idx = dev["idx"].reshape(b, s, k)
    d_idx = torch.stack([dlog.calls[0]["idx"].cpu().reshape(b, half, k)[:, -1]]
                        + [c["idx"].cpu() for c in dlog.calls[1:]], 1)
    same = _same_sets(d_idx, t_idx[:, half - 1:])
    dec_gap = float((dec - teacher).abs().amax(-1)[same].max())
    dec_rel = dec_gap / float(teacher.abs().max())
    res = {"params": need // 4, "host_available_bytes": avail, "copy_to_host_s": copy_s,
           "cpu_forward_s": cpu["s"], "tokens": b * s, "routes_agree": int(agree.sum()),
           "near_ties": int(near.sum()), "route_disagree_not_near_tie": int((~agree & ~near).sum()),
           "logits_rel_diff": logit_rel, "aux": cpu["aux"], "card_aux": dev["aux"],
           "aux_rel_diff": aux_rel, "decode_positions": same.numel(),
           "decode_positions_same_routes": int(same.sum()),
           "decode_vs_teacher_f32_abs": dec_gap, "decode_vs_teacher_f32_rel": dec_rel}
    print(f"  f32, 1 layer at full width, card vs CPU on {b} x {s} tokens (copy to the host "
          f"{copy_s:.1f} s, CPU forward {cpu['s']:.1f} s): routes agree on {res['routes_agree']}"
          f"/{b * s} tokens ({res['near_ties']} near-ties within {MOE_NEAR_TIE:.0e}, "
          f"{res['route_disagree_not_near_tie']} disagreements that are not); logits of agreeing "
          f"tokens {logit_rel:.3e} of the largest |logit| (tol {MOE_F32_LOGIT_TOL:.0e}); aux "
          f"{dev['aux']:.8f} vs {cpu['aux']:.8f} ({aux_rel:.3e} relative, tol "
          f"{MOE_AUX_TOL:.0e}); absorbed decode vs teacher forcing on {int(same.sum())}/"
          f"{same.numel()} positions with the same routes: max |diff| {dec_gap:.3e} = "
          f"{dec_rel:.3e} of the largest |logit|")
    if res["route_disagree_not_near_tie"] or logit_rel > MOE_F32_LOGIT_TOL \
            or aux_rel > MOE_AUX_TOL or not same.any():
        _fail("[moe] the f32 model on the card disagrees with the CPU")
    return res


def _moe_served_wave(torch, lm, cfg, params, wave, routes):
    """The recorded wave's K1 embedding and prefill logits against the
    plain route (``embed.apply`` → ``forward_hidden`` → the LM head: the
    same token groups, so the same drops), and its routes dropped by the
    capacity in prefill and decode."""
    from repro_torch.nn.layers import dense

    prompts, pre_logits = wave[0]
    n_layers = cfg.n_layers
    with torch.inference_mode():
        emb_diff = _max_err(torch, lm.embed_serving(params, prompts, cfg),
                            lm.embed_tokens(params, prompts, cfg))
        h, _ = lm.forward_hidden(params, lm.embed_tokens(params, prompts, cfg), cfg)
        plain = dense(params["lm_head"], h[:, -1:], cfg.cdtype).to(torch.float32)[:, -1]
    pre_kept = torch.stack([c["kept"] for c in routes.calls[:n_layers]])
    dec_kept = [c["kept"] for c in routes.calls[n_layers:]]
    return emb_diff, _max_err(torch, pre_logits, plain), {
        "prefill_routes_dropped": int((~pre_kept).sum()), "prefill_routes": pre_kept.numel(),
        "decode_routes_dropped": sum(int((~k).sum()) for k in dec_kept),
        "decode_routes": sum(k.numel() for k in dec_kept)}


def _moe_teacher(torch, lm, cfg, params, wave, tol_rel):
    """Decode against teacher forcing, on ``MOE_TEACHER_ROWS`` rows of the
    recorded wave (its prompts and the tokens it fed each decode step) in
    the same model with a capacity that drops nothing (``capacity_factor``
    E/k: C = N_g), so the two paths differ only by the absorbed MLA's
    roundoff and the routes it flips: the logits are compared at the
    positions where no layer dropped a route and every layer chose the
    same top-k set in both."""
    from repro_torch.nn.layers import dense

    rows = MOE_TEACHER_ROWS
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    dropless = dataclasses.replace(cfg, moe=moe)
    n_layers, k = cfg.n_layers, cfg.moe.top_k
    prompts = wave[0][0][:rows]
    toks = [tok[:rows] for tok, _ in wave[1:]]
    plen, steps = prompts.shape[1], len(toks)
    with torch.inference_mode():
        with _RouteLog(torch) as dlog:
            cache = lm.make_decode_cache(dropless, rows, plen + steps, "cuda")
            lm.prefill(params, prompts, cache, dropless)
            dec = []
            for i, tok in enumerate(toks):
                logits, cache = lm.decode_step(params, tok, plen + i, cache, dropless)
                dec.append(logits[:, -1])
        seq = torch.cat([prompts] + toks, dim=1)
        with _RouteLog(torch) as tlog:
            h, _ = lm.forward_hidden(params, lm.embed_tokens(params, seq, dropless), dropless)
            tf_logits = dense(params["lm_head"], h[:, plen:], cfg.cdtype).to(torch.float32)
    del cache
    total = seq.shape[1]
    t_idx = torch.stack([c["idx"].reshape(rows, total, k) for c in tlog.calls])[:, :, plen:]
    t_kept = torch.stack([c["kept"].reshape(rows, total, k) for c in tlog.calls])
    d_calls = dlog.calls[n_layers:]
    d_idx = torch.stack([c["idx"] for c in d_calls]).reshape(steps, n_layers, rows, k)
    d_idx = d_idx.permute(1, 2, 0, 3)                                  # (L, B, steps, k)
    d_dropped = sum(int((~c["kept"]).sum()) for c in dlog.calls)
    dropped = ~t_kept[:, :, plen:].all(dim=-1).all(dim=0)              # (B, steps)
    flipped = ~_same_sets(d_idx, t_idx).all(dim=0)
    compared = ~dropped & ~flipped
    dec = torch.stack(dec, dim=1)                                      # (B, steps, V)
    scale = float(tf_logits.abs().max())
    diff = (dec - tf_logits).abs().amax(dim=-1)
    dec_diff = float(diff[compared].max()) if compared.any() else float("nan")
    agree = dec.argmax(-1) == tf_logits.argmax(-1)
    return {"rows": rows, "steps": steps, "capacity_factor": moe.capacity_factor,
            "positions": compared.numel(), "dropped": int(dropped.sum()),
            "decode_routes_dropped": d_dropped,
            "teacher_routes_dropped": int((~t_kept).sum()), "flipped": int(flipped.sum()),
            "compared": int(compared.sum()), "max_abs_diff": dec_diff,
            "max_abs_diff_all_positions": float(diff.max()), "max_abs_teacher_logit": scale,
            "rel_diff": dec_diff / scale, "tol_rel": tol_rel, "tol_abs": tol_rel * scale,
            "argmax_agree_compared": int((agree & compared).sum()),
            "argmax_agree_all": int(agree.sum())}


def _moe_train(torch, ds, lm, card):
    """10 Adafactor steps (``MOE_TRAIN_LR``) at full width and 2 layers on
    the port's LM stream, by ``make_train_step`` in a loop that drops
    each old state as the next one comes (a caller of ``Trainer.run``
    keeps its first state alive, 17.2 GB here): the loss finite and
    falling, the aux loss positive; time per step and peak memory."""
    from repro_torch.optim import optimizers
    from repro_torch.train.loop import init_state, make_train_step

    cfg = dataclasses.replace(ds.config(), n_layers=MOE_TRAIN_LAYERS)
    api = ds.api(cfg)
    opt = optimizers.adafactor(MOE_TRAIN_LR)
    shape = _lm_shape(MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    print(f"  training: {base} B held on the card before the 2-layer model")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(5))
    n = lm.num_params(params)
    state = init_state(params, opt)
    del params
    train_step = make_train_step(api.loss_fn, opt)
    losses, auxs, walls = [], [], []
    for s in range(MOE_TRAIN_STEPS + 3):
        batch = api.batch_fn(s, shape)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        if s < MOE_TRAIN_STEPS:
            losses.append(float(metrics["loss"]))
            auxs.append(float(metrics["aux"]))
        else:
            walls.append(time.perf_counter() - t1)
        if s == MOE_TRAIN_STEPS - 1:
            run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    tail = sum(losses[-3:]) / 3
    if not all(math.isfinite(x) for x in losses):
        _fail("[moe] training losses are not all finite")
    if not tail < losses[0]:
        _fail(f"[moe] the loss did not fall: last 3 steps {tail:.5f} vs step 0 {losses[0]:.5f} "
              f"({losses})")
    if not all(a > 0 for a in auxs):
        _fail(f"[moe] the aux loss is not positive: {auxs}")
    wall_ms = sorted(walls)[1] * 1e3
    opt_bytes = sum(x.numel() * x.element_size() for s in state["opt"] for x in s.values())
    del state
    torch.cuda.empty_cache()
    prof = {"card": card, "layers": MOE_TRAIN_LAYERS, "parameters": n,
            "optimizer": f"adafactor({MOE_TRAIN_LR:g})", "steps": MOE_TRAIN_STEPS,
            "batch": MOE_TRAIN_BATCH, "seq_len": MOE_TRAIN_SEQ, "losses": losses, "aux": auxs,
            "loss_step_0": losses[0], "loss_last_3": tail, "run_s_with_init": run_s, "wall_ms_per_step": wall_ms,
            "peak_memory_bytes": peak, "peak_above_phase_start_bytes": peak - base,
            "adafactor_state_bytes": opt_bytes}
    print(f"  {MOE_TRAIN_STEPS} Adafactor({MOE_TRAIN_LR:g}) steps at {MOE_TRAIN_LAYERS} layers "
          f"({n:,} parameters), B={MOE_TRAIN_BATCH} S={MOE_TRAIN_SEQ}, one microbatch, in "
          f"{run_s:.2f} s with init: loss {losses[0]:.5f} at step 0, {tail:.5f} over the last 3, aux "
          f"{auxs[0]:.6f} -> {auxs[-1]:.6f} | per step wall {wall_ms:.1f} ms (median of 3 after "
          f"them) | peak {peak} B ({peak - base} B above the phase's start; Adafactor's factored "
          f"state {opt_bytes} B)")
    return prof


def _moe_arctic(torch, lm, card):
    """Arctic at full width and 1 layer (128 experts top-2 beside the
    parallel dense FFN): one wave of 16 prompts of 128 tokens, one K1 per
    call and nothing else; K1 and the prefill logits bit-equal to the
    plain route."""
    from repro_torch.configs import arctic_480b
    from repro_torch.nn.layers import dense

    cfg = dataclasses.replace(arctic_480b.config(), n_layers=1)
    gc.collect()
    params = lm.init(torch.Generator(device="cuda").manual_seed(7), cfg, "cuda")
    n, nbytes = lm.num_params(params), _tree_bytes(params)
    if (n, nbytes) != (ARCTIC_PARAMS, ARCTIC_PARAM_BYTES):
        _fail(f"[moe] arctic: {n} parameters / {nbytes} B, expected {ARCTIC_PARAMS} / "
              f"{ARCTIC_PARAM_BYTES}")
    calls, record = [], []
    engine = _lm_engine(torch, cfg, params, calls, record, LM_BATCH, 256)
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, 128), generator=gen, device="cuda")
    for p in prompts.tolist():
        engine.submit(p, max_new_tokens=LM_NEW_TOKENS)
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    done = engine.run_until_drained()
    wave_s = time.perf_counter() - t
    counts = _read_counts()
    launch = _lm_check_calls(calls, 1, "[moe]")
    if len(done) != LM_BATCH or any(
            len(r.output) != LM_NEW_TOKENS or not all(0 <= x < cfg.vocab for x in r.output)
            for r in done.values()):
        _fail("[moe] arctic's wave did not complete with its tokens in range")
    prompts_in, pre_logits = record[0]
    with torch.inference_mode():
        emb_diff = _max_err(torch, lm.embed_serving(params, prompts_in, cfg),
                            lm.embed_tokens(params, prompts_in, cfg))
        h, _ = lm.forward_hidden(params, lm.embed_tokens(params, prompts_in, cfg), cfg)
        plain = dense(params["lm_head"], h[:, -1:], cfg.cdtype).to(torch.float32)[:, -1]
    pre_diff = _max_err(torch, pre_logits, plain)
    dec_ms = sorted(ms for ms, _ in calls[1:])
    print(f"  arctic-480b at full width, 1 of {arctic_480b.config().n_layers} layers ({n:,} "
          f"parameters, {nbytes:,} B; {cfg.moe.n_experts} experts top-{cfg.moe.top_k} and the "
          f"parallel dense FFN): one wave of {LM_BATCH} x 128 tokens, {LM_NEW_TOKENS} new each, "
          f"in {wave_s:.2f} s (prefill {calls[0][0]:.1f} ms, decode median "
          f"{dec_ms[len(dec_ms) // 2]:.2f} ms); one K1 per call on all {len(calls)} calls; K1 vs "
          f"embed.apply max |diff| {emb_diff}, prefill logits vs the plain forward {pre_diff}")
    if emb_diff != 0 or pre_diff != 0:
        _fail("[moe] arctic: K1 or the prefill logits differ from the plain route")
    del params, engine, record
    torch.cuda.empty_cache()
    return {"parameters": n, "parameter_bytes": nbytes, "wave_s": wave_s,
            "prefill_ms": calls[0][0], "decode_ms_median": dec_ms[len(dec_ms) // 2],
            "launches": launch, "k1_vs_plain_max_abs_diff": emb_diff,
            "prefill_vs_plain_max_abs_diff": pre_diff}, counts


def moe_full_width(torch, card):
    """The [moe] phase (ROADMAP 18b, first part): DeepSeek-V2 at full width
    and 4 of its 60 layers served through ``ServeEngine`` with its QR
    vocabulary through K1, held against the plain route and (on a dropless
    replay of 4 rows) teacher forcing, routes compared, an 8,192-token
    prompt, the f32 model against the CPU
    at 1 layer, 10 Adafactor steps at 2 layers, and Arctic's wave at 1
    layer.  Returns the launch counts of the paths and K1's inputs at
    DeepSeek's vocabulary for [time]."""
    from repro_torch.configs import deepseek_v2_236b as ds
    from repro_torch.models import lm

    t0 = time.perf_counter()
    full = ds.config()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  held on the card at the phase's start: {torch.cuda.memory_allocated()} B")
    f32 = _moe_f32_vs_cpu(torch, ds, lm)
    tol_rel = _lm_decode_tol(f32["decode_vs_teacher_f32_rel"], MOE_LAYERS, f32_layers=1)

    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated() - base
    n, nbytes = lm.num_params(params), _tree_bytes(params)
    print(f"  {cfg.name}: vocab {cfg.vocab}, d {cfg.d_model}, MLA {cfg.mla.n_heads} heads "
          f"(q_lora {cfg.mla.q_lora}, kv_lora {cfg.mla.kv_lora}, d_nope {cfg.mla.d_nope}, d_rope "
          f"{cfg.mla.d_rope}, d_v {cfg.mla.d_v}), MoE {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} d_ff {cfg.moe.d_ff} + {cfg.n_shared_experts} shared, QR c="
          f"{cfg.embedding.num_collisions} {cfg.embedding.op} vocabulary "
          f"{tuple(params['embed']['table_0'].shape)} + {tuple(params['embed']['table_1'].shape)}"
          f", {cfg.param_dtype}; the one cut: {MOE_LAYERS} of {full.n_layers} layers: {n:,} "
          f"parameters, {nbytes:,} B, drawn in {init_s:.1f} s (peak {init_peak} B above the "
          "phase's start)")
    if (n, nbytes) != (MOE_PARAMS, MOE_PARAM_BYTES):
        _fail(f"[moe] {n} parameters / {nbytes} B, expected {MOE_PARAMS} / {MOE_PARAM_BYTES}")

    # the queue: 32 prompts of 512 and 16 of 128, greedy, 32 new tokens each
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = _lm_prompts(torch, gen, cfg.vocab)
    calls, record = [], []
    engine = _lm_engine(torch, cfg, params, calls, record, LM_BATCH, LM_MAX_LEN)
    for p in prompts:
        engine.submit(p, max_new_tokens=LM_NEW_TOKENS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    wave_ms = []
    with _RouteLog(torch, limit=LM_NEW_TOKENS * cfg.n_layers) as routes:
        while engine._queue:
            t = time.perf_counter()
            engine.step()
            wave_ms.append((time.perf_counter() - t) * 1e3)
    counts = {"moe": _read_counts()}
    peak = torch.cuda.max_memory_allocated()
    waves, serve_s, done = len(wave_ms), sum(wave_ms) / 1e3, engine.completed
    launch = _lm_check_calls(calls, waves, "[moe]")
    tokens = sum(len(r.output) for r in done.values())
    if len(done) != len(prompts) or any(
            len(r.output) != LM_NEW_TOKENS or not all(0 <= x < cfg.vocab for x in r.output)
            for r in done.values()):
        _fail("[moe] not every request completed with its tokens in range")
    if len(calls) != waves * LM_NEW_TOKENS or counts["moe"]["qr_gather"] != len(calls) \
            or sum(counts["moe"].values()) != len(calls):
        _fail(f"[moe] launches {counts['moe']} for {len(calls)} serving calls in {waves} waves")
    pre_ms = [ms for j, (ms, _) in enumerate(calls) if j % LM_NEW_TOKENS == 0]
    dec_ms = sorted(ms for j, (ms, _) in enumerate(calls) if j % LM_NEW_TOKENS)
    print(f"  served {len(done)} requests ({', '.join(f'{n} of {p} tokens' for p, n in LM_QUEUE)}"
          f") in {waves} waves of {LM_BATCH}: {tokens} tokens in {serve_s:.2f} s = "
          f"{tokens / serve_s:.1f} tokens/s | prefill ms per wave {[round(x, 2) for x in pre_ms]}"
          f" | decode ms per step: median {dec_ms[len(dec_ms) // 2]:.2f}, min {dec_ms[0]:.2f}, "
          f"max {dec_ms[-1]:.2f} | peak memory {peak} B ({peak - base} B above the phase's "
          "start)")
    print(f"  launches: one K1 per call on all {len(calls)} calls ({waves} prefills, "
          f"{len(calls) - waves} decode steps), no other kernel: {counts['moe']}")

    # a decode step's device time and operations; the lookup is one operation
    dec_tokens = torch.randint(0, cfg.vocab, (LM_BATCH, 1), generator=gen, device="cuda")
    with torch.inference_mode():
        plen = LM_QUEUE[-1][0]
        cache = lm.make_decode_cache(cfg, LM_BATCH, LM_MAX_LEN, "cuda")
        lm.prefill(params, torch.randint(0, cfg.vocab, (LM_BATCH, plen), generator=gen,
                                         device="cuda"), cache, cfg)
        pos = [plen]

        def decode(k=5):
            for _ in range(k):
                lm.decode_step(params, dec_tokens, pos[0], cache, cfg)
                pos[0] += 1

        decode(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode(5)
        torch.cuda.synchronize()
        dec_wall = (time.perf_counter() - t) / 5 * 1e3
        _, dev, ops = _profile_device(decode)
        lookup_ops = _device_ops_per_call(torch, lambda: lm.embed_serving(params, dec_tokens,
                                                                          cfg))
    if lookup_ops["ops"] != 1:
        _fail(f"[moe] the token lookup took {lookup_ops['ops']} device operations per call, "
              "expected the one K1 launch")
    dec_dev = sum(dev.values()) / 5 / 1e3
    dec_ops = sum(ops.values()) / 5
    expert_bytes = 3 * cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff * 2 * cfg.n_layers
    print(f"  a decode step of {LM_BATCH}: wall {dec_wall:.2f} ms, device {dec_dev:.3f} ms (busy "
          f"{dec_dev / dec_wall:.3f}), {dec_ops:.0f} device operations; the expert weights it "
          f"reads ({expert_bytes} B, all {cfg.moe.n_experts} experts x {cfg.n_layers} layers) "
          f"take {expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s; "
          f"top {_top_ms(dev, 5, k=6)}")

    # K1 and the prefill logits bit for bit against the plain route; decode
    # against teacher forcing where no route was dropped and the routes agree
    emb_diff, pre_diff, drops = _moe_served_wave(torch, lm, cfg, params, record, routes)
    dec = _moe_teacher(torch, lm, cfg, params, record, tol_rel)
    print(f"  wave 0: K1 vs embed.apply max |diff| {emb_diff}; prefill logits vs the plain "
          f"teacher-forced forward max |diff| {pre_diff}; routes dropped by the capacity: "
          f"prefill {drops['prefill_routes_dropped']}/{drops['prefill_routes']}, decode "
          f"{drops['decode_routes_dropped']}/{drops['decode_routes']}")
    print(f"  decode vs teacher forcing, {dec['rows']} of the wave's rows and the tokens it fed, "
          f"at capacity_factor E/k = {dec['capacity_factor']:.4f}: routes dropped "
          f"{dec['decode_routes_dropped']} (decode) and {dec['teacher_routes_dropped']} "
          f"(teacher-forced); of {dec['positions']} positions {dec['dropped']} with a route "
          f"dropped, {dec['flipped']} with another top-{cfg.moe.top_k} set in some layer, "
          f"{dec['compared']} compared: max |diff| {dec['max_abs_diff']:.4f} = "
          f"{dec['rel_diff']:.4f} of the largest |logit| (tol {tol_rel:.4f} = the f32 gap x "
          f"2^16 x sqrt({MOE_LAYERS} / 1); over all positions "
          f"{dec['max_abs_diff_all_positions']:.4f}); greedy agrees on "
          f"{dec['argmax_agree_compared']}/{dec['compared']} compared positions, "
          f"{dec['argmax_agree_all']}/{dec['positions']} in all")
    if emb_diff != 0 or pre_diff != 0:
        _fail("[moe] K1 or the prefill logits differ from the plain route")
    if dec["decode_routes_dropped"] or dec["teacher_routes_dropped"] or drops[
            "decode_routes_dropped"]:
        _fail("[moe] a route was dropped where the capacity takes every route")
    if not dec["compared"] or not dec["rel_diff"] <= tol_rel:
        _fail("[moe] decode disagrees with teacher forcing beyond the tolerance")
    del record, engine, routes

    # one long prompt: 8,192 tokens (256 groups of 32, capacity 2)
    long_ids = torch.randint(0, cfg.vocab, (1, LM_LONG_PROMPT), generator=gen, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.inference_mode():
        cache = lm.make_decode_cache(cfg, 1, LM_LONG_PROMPT, "cuda")
        long_logits, cache = lm.prefill(params, long_ids, cache, cfg)
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t) * 1e3
    long_peak = torch.cuda.max_memory_allocated() - held
    score_bytes = cfg.n_heads * LM_LONG_PROMPT * LM_LONG_PROMPT * 4
    print(f"  one {LM_LONG_PROMPT}-token prompt: prefill {long_ms:.1f} ms, logits finite "
          f"{bool(torch.isfinite(long_logits).all())}; peak memory above the parameters "
          f"{long_peak} B (the latent cache {_tree_bytes(cache)} B) against one {cfg.n_heads} x "
          f"{LM_LONG_PROMPT} x {LM_LONG_PROMPT} f32 score matrix's {score_bytes} B")
    if not bool(torch.isfinite(long_logits).all()) or long_peak >= score_bytes:
        _fail("[moe] the long prompt's logits are not finite or its memory is not linear")
    k1_inputs = {"prefill": long_ids.reshape(-1, 1), "decode": dec_tokens,
                 "tables": (params["embed"]["table_0"].clone(),
                            params["embed"]["table_1"].clone())}
    del cache, long_logits, params
    torch.cuda.empty_cache()

    train_prof = _moe_train(torch, ds, lm, card)
    arctic, counts["moe_arctic"] = _moe_arctic(torch, lm, card)
    prof = {"card": card, "arch": cfg.name, "layers": MOE_LAYERS, "of_layers": full.n_layers,
            "parameters": n, "parameter_bytes": nbytes, "init_s": init_s, "requests": len(done),
            "waves": waves, "tokens": tokens, "serve_s": serve_s,
            "tokens_per_s": tokens / serve_s, "prefill_ms_per_wave": pre_ms,
            "decode_ms_per_step_median": dec_ms[len(dec_ms) // 2], "decode_wall_ms": dec_wall,
            "decode_device_ms": dec_dev, "decode_device_ops": dec_ops,
            "decode_busy_share": dec_dev / dec_wall, "decode_expert_weight_bytes": expert_bytes,
            "serve_peak_bytes": peak, "lookup_device_ops_per_call": lookup_ops["ops"],
            "launches": launch, "k1_vs_plain_max_abs_diff": emb_diff,
            "prefill_vs_plain_max_abs_diff": pre_diff, "served_wave_drops": drops,
            "decode_vs_teacher": dec, "long_prompt_ms": long_ms,
            "long_prompt_peak_above_params_bytes": long_peak,
            "f32_vs_cpu": f32, "train": train_prof, "arctic": arctic,
            "phase_s": time.perf_counter() - t0}
    print(f"  card: {card}; [moe] {prof['phase_s']:.1f} s")
    print(json.dumps({"moe_profile": prof}))
    return counts, k1_inputs, emb_diff


# [ssm]: the SSM family (ROADMAP 18b-ii) at full width on the card, its QR
# vocabularies looked up through K1 when serving: mamba2-370m (a pure Mamba2
# stack; 12,570 + 4 rows x 1,024, bf16, mult) and zamba2-1.2b (Mamba2 with a
# shared attention block; 8,000 + 4 rows x 2,048); then one wave of the
# full-width qwen3-14b, whose qk_norm attention no other phase runs (18b-i')
SSM_MAMBA = (381_214_208, 762_437_632)        # jax.eval_shape of the reference's init
SSM_ZAMBA = (1_121_330_048, 2_242_674_688)
# the caches at B = 16: Mamba's the same at max_len 1,024 and 8,192 (the
# f32 state, 805,306,368 B of it, is O(1) in the length), Zamba's at 1,024
SSM_MAMBA_CACHE, SSM_MAMBA_STATE, SSM_ZAMBA_CACHE = 815_923_200, 805_306_368, 1_458_249_728
# the prefill's final state against the state reached by decoding the prompt
# token by token, 1 layer in f32: 2 prompts of 300 tokens (two chunks of
# 256, the second padded), the reference's tolerances (rtol, atol)
SSM_STATE_PROMPT = (2, 300)
SSM_STATE_TOL = {"ssm": (2e-3, 1e-4), "conv": (1e-4, 1e-5)}
# the long prompt's peak memory above the parameters against a prompt of
# half its length: linear in the length allows a ratio of 2 (and a margin)
SSM_LONG_RATIO = 2.2
SSM_TRAIN_STEPS = {"mamba2-370m": 10, "zamba2-1.2b": 10}
# the f32 check's depth: Mamba at 2 layers, Zamba at 1 block of 2 layers
# and 1 tail layer (3 Mamba layers and one application of the shared block)
SSM_F32_CUT = {"mamba2-370m": {"n_layers": 2},
               "zamba2-1.2b": {"n_blocks": 1, "block_len": 2, "n_tail": 1}}
# the f32 decode's gap to teacher forcing on the card, relative to the
# largest |logit|: decode (the conv window, the O(1) state update) and the
# chunked prefill compute one function, so at f32 they agree to roundoff;
# this bound holds the decode on its own (the bf16 tolerance scales it)
SSM_F32_DECODE_TOL = 1e-4
QWEN_PARAMS = (14_184_893_440, 28_369_786_880)
QWEN_WAVE = (16, 128, 16)          # prompts, prompt length, new tokens


def _ssm_fns(kind):
    """(make_cache, prefill, decode_step, final-normed forward) of the SSM
    family's ``kind`` ("mamba" or "hybrid"), as ``_lm_fns`` gives the LM's."""
    from repro_torch.models import hybrid

    return tuple(getattr(hybrid, f"{kind}_{n}") for n in ("make_cache", "prefill",
                                                           "decode_step", "forward"))


def _ssm_depth(cfg) -> int:
    """Mamba layers of a config."""
    return getattr(cfg, "n_layers", None) or cfg.n_blocks * cfg.block_len + cfg.n_tail


def _ssm_f32_vs_cpu(torch, mod, lm, fns):
    """The arch at full width and ``SSM_F32_CUT``'s depth in f32, TF32 off:
    one prefill of 2 x 128 and 4 decode steps, and one ``loss_fn``
    value-and-grad, card against CPU; and the card's decode-vs-teacher-
    forcing gap at f32.  [lm]'s bounds."""
    from repro_torch import tree
    from repro_torch.nn.layers import dense
    from repro_torch.train.loop import value_and_grad

    make_cache, prefill, decode, forward = fns
    if torch.backends.cuda.matmul.allow_tf32:
        _fail("[ssm] TF32 is on for f32 matrix products")
    cfg = dataclasses.replace(mod.config(), param_dtype="float32", compute_dtype="float32",
                              **SSM_F32_CUT[mod.ARCH])
    host_api = mod.api(cfg, device="cpu")
    host = host_api.init(torch.Generator().manual_seed(3))
    card = tree.tree_map(lambda t: t.to("cuda"), host)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (2, 128), generator=gen)
    toks = [torch.randint(0, cfg.vocab, (2, 1), generator=gen) for _ in range(4)]
    out = {}
    with torch.inference_mode():
        for name, params, dev in (("cpu", host, "cpu"), ("card", card, "cuda")):
            cache = make_cache(cfg, 2, 160, dev)
            logits, cache = prefill(params, prompts.to(dev), cache, cfg)
            steps = [logits[:, -1]]
            for i, tok in enumerate(toks):
                logits, cache = decode(params, tok.to(dev), 128 + i, cache, cfg)
                steps.append(logits[:, -1])
            out[name] = torch.stack(steps, 1).cpu()
        seq = torch.cat([prompts] + toks, 1).to("cuda")
        h = forward(card, lm.embed_tokens(card, seq, cfg), cfg)
        teacher = dense(card["lm_head"], h[:, 127:], cfg.cdtype).cpu()
    scale = float(out["cpu"].abs().max())
    logit_rel = float((out["card"] - out["cpu"]).abs().max()) / scale
    dec_gap = float((out["card"][:, 1:] - teacher[:, 1:]).abs().max())
    dec_rel = dec_gap / float(teacher.abs().max())
    batch = host_api.batch_fn(0, _lm_shape(64, 2))
    (loss, _), grads = value_and_grad(host_api.loss_fn)(host, batch)
    (card_loss, _), card_grads = value_and_grad(mod.api(cfg).loss_fn)(
        card, {k: v.to("cuda") for k, v in batch.items()})
    worst, where = 0.0, ""
    for (path, g), cg in zip(tree.flatten_with_path(grads), tree.leaves(card_grads)):
        s = float(g.abs().max())
        rel = float((cg.cpu() - g).abs().max()) / s if s else float(cg.abs().max())
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    loss_diff = abs(float(card_loss) - float(loss))
    depth = _ssm_depth(cfg)
    res = {"mamba_layers": depth, "logits_rel_diff": logit_rel, "loss": float(loss),
           "card_loss": float(card_loss), "loss_diff": loss_diff, "worst_grad_rel": worst,
           "worst_grad_leaf": where, "decode_vs_teacher_f32_abs": dec_gap,
           "decode_vs_teacher_f32_rel": dec_rel}
    print(f"  f32, {depth} Mamba layers at full width, card vs CPU: prefill + 4 decode steps' "
          f"logits {logit_rel:.3e} of the largest |logit| (tol {LM_F32_LOGIT_TOL:.0e}); loss "
          f"{float(card_loss):.7f} vs {float(loss):.7f} (|diff| {loss_diff:.3e}, tol "
          f"{LM_F32_LOSS_TOL:.0e}); worst gradient leaf {where} {worst:.3e} of its largest |g| "
          f"(tol {GRAD_TOL:.0e}); decode vs teacher forcing at f32: max |diff| {dec_gap:.3e} = "
          f"{dec_rel:.3e} of the largest |logit| (tol {SSM_F32_DECODE_TOL:.0e})")
    if not (logit_rel <= LM_F32_LOGIT_TOL and loss_diff <= LM_F32_LOSS_TOL * abs(float(loss))
            and worst <= GRAD_TOL):
        _fail(f"[ssm] the f32 {mod.ARCH} on the card disagrees with the CPU")
    if not dec_rel <= SSM_F32_DECODE_TOL:
        _fail(f"[ssm] the f32 {mod.ARCH}'s decode on the card disagrees with teacher forcing: "
              f"{dec_rel:.3e} of the largest |logit|, tol {SSM_F32_DECODE_TOL:.0e}")
    return res


def _ssm_state_check(torch, mod):
    """1 Mamba layer at full width in f32 on the card: the prefill's final
    state and conv window against those reached by decoding the prompt
    token by token from an empty cache."""
    from repro_torch.models import hybrid

    cfg = dataclasses.replace(mod.config(), n_layers=1, param_dtype="float32",
                              compute_dtype="float32")
    params = hybrid.mamba_init(torch.Generator(device="cuda").manual_seed(7), cfg, "cuda")
    b, s = SSM_STATE_PROMPT
    prompt = torch.randint(0, cfg.vocab, (b, s), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(8))
    with torch.inference_mode():
        pre = hybrid.mamba_make_cache(cfg, b, 0, "cuda")
        hybrid.mamba_prefill(params, prompt, pre, cfg)
        dec = hybrid.mamba_make_cache(cfg, b, 0, "cuda")
        for t in range(s):
            hybrid.mamba_decode_step(params, prompt[:, t:t + 1], t, dec, cfg)
    out = {}
    for k, (rtol, atol) in SSM_STATE_TOL.items():
        diff = (pre[k] - dec[k]).abs()
        excess = float((diff - rtol * dec[k].abs()).max())
        out[k] = {"max_abs_diff": float(diff.max()), "max_abs": float(dec[k].abs().max()),
                  "rtol": rtol, "atol": atol, "worst_excess_over_rtol": excess}
    print(f"  prefill state vs {s} decode steps, 1 layer, f32, {b} prompts: ssm max |diff| "
          f"{out['ssm']['max_abs_diff']:.3e} (largest |state| {out['ssm']['max_abs']:.3e}), "
          f"conv {out['conv']['max_abs_diff']:.3e} (largest {out['conv']['max_abs']:.3e}); "
          "tolerances rtol 2e-3 / atol 1e-4 and 1e-4 / 1e-5")
    for k, (rtol, atol) in SSM_STATE_TOL.items():
        if not torch.allclose(pre[k], dec[k], rtol=rtol, atol=atol):
            _fail(f"[ssm] the prefill's {k} cache differs from the state decoded token by token")
    return out


def _ssm_serve(torch, lm, cfg, params, fns, label, queue, new_tokens, profile=True,
               phase="[ssm]", emb=None):
    """``queue``'s prompts through ``ServeEngine`` (waves of ``LM_BATCH``):
    one K1 per call and no other kernel, tokens in range; then a decode
    step's wall and device time after a 128-token prefill and the lookup's
    device operations (on ``emb``, the vocabulary's (params, config);
    ``(params, cfg)`` by default).  ``phase`` names the phase in the
    messages.  Returns (profile, launch counts, the recorded first wave,
    the decode tokens)."""
    emb_params, emb_cfg = emb or (params, cfg)
    vocab = emb_cfg.vocab
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = []
    for plen, n in queue:
        prompts += torch.randint(0, vocab, (n, plen), generator=gen, device="cuda").tolist()
    calls, record = [], []
    engine = _lm_engine(torch, cfg, params, calls, record, LM_BATCH, LM_MAX_LEN, fns)
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    wave_ms = []
    while engine._queue:
        t = time.perf_counter()
        engine.step()
        wave_ms.append((time.perf_counter() - t) * 1e3)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    waves, serve_s, done = len(wave_ms), sum(wave_ms) / 1e3, engine.completed
    launch = _lm_check_calls(calls, waves, phase)
    tokens = sum(len(r.output) for r in done.values())
    if len(done) != len(prompts) or any(
            len(r.output) != new_tokens or not all(0 <= x < vocab for x in r.output)
            for r in done.values()):
        _fail(f"{phase} {label}: not every request completed with its tokens in range")
    if len(calls) != waves * new_tokens or counts["qr_gather"] != len(calls) \
            or sum(counts.values()) != len(calls):
        _fail(f"{phase} {label}: launches {counts} for {len(calls)} serving calls in {waves} "
              "waves")
    pre_ms = [ms for j, (ms, _) in enumerate(calls) if j % new_tokens == 0]
    dec_ms = sorted(ms for j, (ms, _) in enumerate(calls) if j % new_tokens)
    prof = {"requests": len(done), "waves": waves, "tokens": tokens, "serve_s": serve_s,
            "tokens_per_s": tokens / serve_s, "prefill_ms_per_wave": pre_ms,
            "decode_ms_per_step_median": dec_ms[len(dec_ms) // 2], "serve_peak_bytes": peak,
            "serve_peak_above_start_bytes": peak - base, "launches": launch}
    print(f"  {label}: served {len(done)} requests "
          f"({', '.join(f'{n} of {p} tokens' for p, n in queue)}) in {waves} waves of "
          f"{LM_BATCH}: {tokens} tokens in {serve_s:.2f} s = {tokens / serve_s:.1f} tokens/s | "
          f"prefill ms per wave {[round(x, 2) for x in pre_ms]} | decode ms per step: median "
          f"{prof['decode_ms_per_step_median']:.2f}, min {dec_ms[0]:.2f}, max {dec_ms[-1]:.2f} | "
          f"peak memory {peak} B ({peak - base} B above the serving's start)")
    print(f"  launches: one K1 per call on all {len(calls)} calls ({waves} prefills, "
          f"{len(calls) - waves} decode steps), no other kernel: {counts}")
    dec_tokens = torch.randint(0, vocab, (LM_BATCH, 1), generator=gen, device="cuda")
    if profile:
        make_cache, prefill, decode, _ = fns
        with torch.inference_mode():
            lookup_ops = _device_ops_per_call(torch, lambda: lm.embed_serving(
                emb_params, dec_tokens, emb_cfg))
            cache = make_cache(cfg, LM_BATCH, LM_MAX_LEN, "cuda")
            _, cache = prefill(params, torch.randint(0, vocab, (LM_BATCH, 128), generator=gen,
                                                     device="cuda"), cache, cfg)
            dec = _ssm_decode_profile(torch, params, cfg, decode, cache, dec_tokens, 128)
        if lookup_ops["ops"] != 1:
            _fail(f"{phase} {label}: the token lookup took {lookup_ops['ops']} device operations "
                  "per call, expected the one K1 launch")
        prof.update({f"decode_{k}": v for k, v in dec.items()})
        prof["lookup_device_ops_per_call"] = lookup_ops["ops"]
        prof["cache_bytes_b16"] = _tree_bytes(cache)
        print(f"  a decode step of {LM_BATCH} after 128 tokens: wall {dec['wall_ms']:.2f} ms, "
              f"device {dec['device_ms']:.3f} ms (busy {dec['busy_share']:.3f}), "
              f"{dec['device_ops']:.0f} device operations; top {dec['top']}; the token lookup "
              f"{lookup_ops['ops']:.0f} device operation per call {lookup_ops['by_name']}")
        del cache
    return prof, counts, record, dec_tokens


def _ssm_decode_profile(torch, params, cfg, decode, cache, tokens, pos, k=3):
    """Wall ms per decode step (``k`` steps after one), device ms, device
    operations and busy share (``torch.profiler`` over ``k`` more)."""
    at = [pos]

    def steps(n=k):
        for _ in range(n):
            decode(params, tokens, at[0], cache, cfg)
            at[0] += 1

    steps(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / k * 1e3
    _, dev, ops = _profile_device(steps)
    device = sum(dev.values()) / k / 1e3
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "device_ops": sum(ops.values()) / k, "top": _top_ms(dev, k, k=6)}


def _ssm_long(torch, fns, cfg, params, label):
    """Prefill one prompt of ``LM_LONG_PROMPT`` tokens and one of half that:
    finite logits, and the longer one's peak memory above the parameters at
    most ``SSM_LONG_RATIO`` times the shorter one's; then a decode step of
    one after the longer beside one after 128 tokens (device ms).  Returns
    the profile and K1's prefill ids."""
    make_cache, prefill, decode, _ = fns
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for n in (LM_LONG_PROMPT // 2, LM_LONG_PROMPT, 128):
        ids = torch.randint(0, cfg.vocab, (1, n), generator=gen, device="cuda")
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with torch.inference_mode():
            cache = make_cache(cfg, 1, n + 16, "cuda")
            logits, cache = prefill(params, ids, cache, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated() - held
            finite = bool(torch.isfinite(logits).all())
            out[n] = {"prefill_ms": ms, "peak_above_params_bytes": peak, "finite": finite,
                      "cache_bytes": _tree_bytes(cache)}
            if n != LM_LONG_PROMPT // 2:
                dec = _ssm_decode_profile(torch, params, cfg, decode, cache, ids[:, -1:], n)
                out[n].update({"decode_wall_ms": dec["wall_ms"],
                               "decode_device_ms": dec["device_ms"],
                               "decode_device_ops": dec["device_ops"]})
        if n == LM_LONG_PROMPT:
            k1_ids = ids.reshape(-1, 1)
        del cache, logits
    short, long_ = out[LM_LONG_PROMPT // 2], out[LM_LONG_PROMPT]
    ratio = long_["peak_above_params_bytes"] / short["peak_above_params_bytes"]
    print(f"  {label}: prompts of {LM_LONG_PROMPT // 2} and {LM_LONG_PROMPT} tokens: prefill "
          f"{short['prefill_ms']:.1f} and {long_['prefill_ms']:.1f} ms, logits finite "
          f"{short['finite'] and long_['finite']}; peak memory above the parameters "
          f"{short['peak_above_params_bytes']} and {long_['peak_above_params_bytes']} B (ratio "
          f"{ratio:.3f}, at most {SSM_LONG_RATIO}; the caches {short['cache_bytes']} and "
          f"{long_['cache_bytes']} B) | a decode step of 1 after {LM_LONG_PROMPT} tokens: "
          f"device {long_['decode_device_ms']:.3f} ms (wall {long_['decode_wall_ms']:.2f}), after "
          f"128: device {out[128]['decode_device_ms']:.3f} ms (wall "
          f"{out[128]['decode_wall_ms']:.2f})")
    if not (short["finite"] and long_["finite"]):
        _fail(f"[ssm] {label}: the long prompt's logits are not finite")
    if ratio > SSM_LONG_RATIO:
        _fail(f"[ssm] {label}: the long prompt's memory grows faster than its length")
    return {"by_prompt_tokens": out, "peak_ratio": ratio}, k1_ids


def _ssm_train(torch, mod, card, steps, phase="[ssm]", cfg=None):
    """``steps`` steps of the arch's default Adam(3e-4) at full width (at
    ``cfg``'s depth when given), B = 4, S = 256, through ``Trainer`` on the
    port's LM stream (the arch's ``api.batch_fn``): the loss finite and
    falling; wall and device time per step; and the peak memory taken
    apart: the train state (parameters and Adam's f32 state), one step's
    peak above it, and one value-and-grad's peak above it with the model's
    checkpoints and without them."""
    from repro_torch.train.loop import (TrainConfig, Trainer, init_state, make_train_step,
                                        value_and_grad)

    api = mod.api(cfg or mod.config())
    shape = _lm_shape(LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    step_fn = make_train_step(api.loss_fn, api.optimizer)
    trainer = Trainer(step_fn, TrainConfig(num_steps=steps, log_every=1),
                      batch_at=lambda s: api.batch_fn(s, shape))
    # the first state is the Trainer's alone, so that its first step frees it
    state, history = trainer.run(init_state(
        api.init(torch.Generator(device="cuda").manual_seed(5)), api.optimizer))
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    losses = [x for _, x in history]
    tail = sum(losses[-3:]) / 3
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        _fail(f"{phase} {mod.ARCH}: training losses are not all finite: {losses}")
    if not tail < losses[0]:
        _fail(f"{phase} {mod.ARCH}: the loss did not fall: last 3 steps {tail:.5f} vs step 0 "
              f"{losses[0]:.5f} ({losses})")
    held = {"state": state}
    del state
    state_bytes = _tree_bytes(held["state"])
    param_bytes = _tree_bytes(held["state"]["params"])
    opt_bytes = _tree_bytes(held["state"]["opt"])
    batches = [api.batch_fn(s, shape) for s in range(steps, steps + 2)]

    def run(b):
        held["state"], _ = step_fn(held["state"], b)

    def peak_above_now(fn):
        gc.collect()
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        del out
        return torch.cuda.max_memory_allocated() - now, wall

    step_peak, wall_ms = peak_above_now(lambda: run(batches[0]))
    _, dev, ops = _profile_device(lambda: run(batches[1]))
    device_ms = sum(dev.values()) / 1e3
    grad_peak = {}
    for remat in (True, False):
        loss_fn = mod.api(dataclasses.replace(api.cfg, remat=remat)).loss_fn
        grad_peak[remat], _ = peak_above_now(
            lambda f=loss_fn: value_and_grad(f)(held["state"]["params"], batches[0]))
    del held
    prof = {"card": card, "steps": steps, "batch": LM_TRAIN_BATCH, "seq_len": LM_TRAIN_SEQ,
            "losses": losses, "loss_step_0": losses[0], "loss_last_3": tail,
            "run_s_with_init": run_s, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
            "device_ops_per_step": sum(ops.values()), "top_device_ms_per_step":
            _top_ms(dev, 1, k=6), "peak_memory_bytes": peak,
            "peak_above_phase_start_bytes": peak - base, "train_state_bytes": state_bytes,
            "param_bytes": param_bytes, "adam_state_bytes": opt_bytes,
            "step_peak_above_state_bytes": step_peak,
            "grad_peak_above_state_bytes": {"checkpointed": grad_peak[True],
                                            "no_checkpoints": grad_peak[False]}}
    print(f"  {steps} Adam(3e-4) steps at B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ} through Trainer in "
          f"{run_s:.2f} s with init: loss {losses[0]:.5f} at step 0, {tail:.5f} over the last 3 | "
          f"per step wall {wall_ms:.1f} ms, device {device_ms:.1f} ms (busy "
          f"{prof['device_busy_share']:.3f}), {prof['device_ops_per_step']:.0f} device "
          f"operations | peak {peak} B, {peak - base} B above the start")
    print(f"  memory: the train state {state_bytes} B (parameters {param_bytes}, Adam's f32 "
          f"state {opt_bytes}); a step's peak above it {step_peak} B (the new state, the "
          f"gradients and the update's f32 temporaries); a value-and-grad's peak above it "
          f"{grad_peak[True]} B with a checkpoint per "
          f"{'block' if mod.FAMILY == 'hybrid' else 'layer'}, {grad_peak[False]} B without")
    print(f"  top device ms per training step: {prof['top_device_ms_per_step']}")
    return prof


def _ssm_arch(torch, lm, mod, card, sizes, cache_bytes):
    """One arch of [ssm] at full width: size, serving, the cache, decode vs
    teacher forcing (after the f32 check that sets its tolerance), the long
    prompt (Mamba), training.  Returns the profile, the serving launch
    counts, K1's inputs at the arch's vocabulary (Mamba; else None) and
    K1's error."""
    kind = "mamba" if mod.FAMILY == "ssm" else "hybrid"
    fns = _ssm_fns(kind)
    t0 = time.perf_counter()
    f32 = _ssm_f32_vs_cpu(torch, mod, lm, fns)
    print(f"  ({time.perf_counter() - t0:.1f} s into {mod.ARCH})")
    cfg = mod.config()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = mod.api(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    n, nbytes = lm.num_params(params), _tree_bytes(params)
    depth = _ssm_depth(cfg)
    emb = params["embed"]
    print(f"  {cfg.name}: vocab {cfg.vocab}, d {cfg.d_model}, {depth} Mamba layers (d_state "
          f"{cfg.ssm.d_state}, {cfg.ssm.n_heads} heads of {cfg.ssm.headdim}, chunk "
          f"{cfg.ssm.chunk})" + ("" if kind == "mamba" else
                                 f" in {cfg.n_blocks} blocks of {cfg.block_len} + "
                                 f"{cfg.n_tail}, the shared block {cfg.n_heads} heads of "
                                 f"{cfg.d_head}, d_ff {cfg.d_ff}")
          + f", QR c={cfg.embedding.num_collisions} {cfg.embedding.op} vocabulary "
          f"{tuple(emb['table_0'].shape)} + {tuple(emb['table_1'].shape)}, {cfg.param_dtype}: "
          f"{n:,} parameters, {nbytes:,} B ({torch.cuda.memory_allocated() - base} B on the "
          "card)")
    if (n, nbytes) != sizes:
        _fail(f"[ssm] {cfg.name}: {n} parameters / {nbytes} B, expected {sizes}")
    make_cache = fns[0]
    got_cache = {ml: _tree_bytes(make_cache(cfg, LM_BATCH, ml, "meta"))
                 for ml in (LM_MAX_LEN, LM_LONG_PROMPT)}
    print(f"  the cache at B={LM_BATCH}: {got_cache[LM_MAX_LEN]} B at max_len {LM_MAX_LEN}, "
          f"{got_cache[LM_LONG_PROMPT]} B at {LM_LONG_PROMPT}")
    if got_cache[LM_MAX_LEN] != cache_bytes or (
            kind == "mamba" and got_cache[LM_LONG_PROMPT] != cache_bytes):
        _fail(f"[ssm] {cfg.name}: cache bytes {got_cache}, expected {cache_bytes}")
    if kind == "mamba":
        state = _tree_bytes({"ssm": make_cache(cfg, LM_BATCH, 0, "meta")["ssm"]})
        if state != SSM_MAMBA_STATE:
            _fail(f"[ssm] {cfg.name}: the state cache is {state} B, expected {SSM_MAMBA_STATE}")

    serve, counts, record, dec_tokens = _ssm_serve(torch, lm, cfg, params, fns, cfg.name,
                                                   LM_QUEUE, LM_NEW_TOKENS)
    if serve["cache_bytes_b16"] != cache_bytes:
        _fail(f"[ssm] {cfg.name}: the served cache is {serve['cache_bytes_b16']} B")
    print(f"  ({time.perf_counter() - t0:.1f} s into {cfg.name})")
    tol_rel = _lm_decode_tol(f32["decode_vs_teacher_f32_rel"], depth,
                             f32_layers=f32["mamba_layers"])
    emb_diff, pre_diff, dec = _lm_teacher(torch, lm, cfg, params, record, tol_rel,
                                          forward=fns[3])
    print(f"  wave 0: K1 vs embed.apply max |diff| {emb_diff}; prefill logits vs the plain "
          f"teacher-forced forward max |diff| {pre_diff}; decode ({dec['steps']} steps) vs "
          f"teacher forcing max |diff| {dec['max_abs_diff']:.4f} = {dec['rel_diff']:.4f} of the "
          f"largest |logit| (tol {tol_rel:.4f} = the f32 gap x 2^16 x sqrt({depth} / "
          f"{f32['mamba_layers']})); greedy agrees on {dec['argmax_agree']}/{dec['positions']}, "
          f"on {dec['clear_positions']} positions the top-2 gap exceeds the tolerance and "
          f"{dec['clear_disagree']} of them disagree (the largest teacher-forced top-2 gap where "
          f"greedy differs {dec['largest_gap_where_greedy_differs']:.4f}, median gap "
          f"{dec['median_top2_gap']:.4f})")
    if emb_diff != 0 or pre_diff != 0:
        _fail(f"[ssm] {cfg.name}: K1 or the prefill logits differ from the plain route")
    if dec["rel_diff"] > tol_rel or dec["clear_disagree"]:
        _fail(f"[ssm] {cfg.name}: decode disagrees with teacher forcing beyond the tolerance")
    del record
    print(f"  ({time.perf_counter() - t0:.1f} s into {cfg.name})")
    long_, k1_inputs = None, None
    if kind == "mamba":
        long_, k1_ids = _ssm_long(torch, fns, cfg, params, cfg.name)
        k1_inputs = {"prefill": k1_ids, "decode": dec_tokens,
                     "tables": (emb["table_0"].clone(), emb["table_1"].clone())}
    del params, emb
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  ({time.perf_counter() - t0:.1f} s into {cfg.name})")
    train = _ssm_train(torch, mod, card, SSM_TRAIN_STEPS[mod.ARCH])
    prof = {"card": card, "arch": cfg.name, "parameters": n, "parameter_bytes": nbytes,
            "cache_bytes": got_cache, "serve": serve, "k1_vs_plain_max_abs_diff": emb_diff,
            "prefill_vs_plain_max_abs_diff": pre_diff, "decode_vs_teacher": dec,
            "f32_vs_cpu": f32, "long_prompt": long_, "train": train,
            "arch_s": time.perf_counter() - t0}
    return prof, counts, k1_inputs, emb_diff


def _qwen3_wave(torch, lm, card):
    """The full-width qwen3-14b (qk_norm; 37,984 + 4 rows x 5,120 bf16 QR
    vocabulary) for one wave: ``QWEN_WAVE``'s prompts and new tokens, one K1
    per call and no other kernel, K1 and the prefill logits bit-equal to
    the plain route.  Returns the profile, the launch counts and K1's
    inputs at Qwen3's vocabulary."""
    from repro_torch.configs import qwen3_14b

    cfg = qwen3_14b.config()
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n, nbytes = lm.num_params(params), _tree_bytes(params)
    emb = params["embed"]
    print(f"  {cfg.name}: vocab {cfg.vocab}, d {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {cfg.d_head} with qk_norm "
          f"{cfg.qk_norm}, d_ff {cfg.d_ff}, QR vocabulary {tuple(emb['table_0'].shape)} + "
          f"{tuple(emb['table_1'].shape)}: {n:,} parameters, {nbytes:,} B, drawn in "
          f"{init_s:.1f} s")
    if (n, nbytes) != QWEN_PARAMS or not cfg.qk_norm:
        _fail(f"[ssm] {cfg.name}: {n} parameters / {nbytes} B, expected {QWEN_PARAMS}")
    prompts, plen, new = QWEN_WAVE
    serve, counts, record, dec_tokens = _ssm_serve(torch, lm, cfg, params, _lm_fns(), cfg.name,
                                                   ((plen, prompts),), new, profile=False)
    emb_diff, pre_diff, _ = _lm_teacher(torch, lm, cfg, params, record[:1], 0.0)
    print(f"  {cfg.name} wave: K1 vs embed.apply max |diff| {emb_diff}; prefill logits vs the "
          f"plain forward (qk_norm in every layer) max |diff| {pre_diff}")
    if emb_diff != 0 or pre_diff != 0:
        _fail(f"[ssm] {cfg.name}: K1 or the prefill logits differ from the plain route")
    gen = torch.Generator(device="cuda").manual_seed(10)
    k1_inputs = {"prefill": torch.randint(0, cfg.vocab, (LM_LONG_PROMPT, 1), generator=gen,
                                          device="cuda"),
                 "decode": dec_tokens.reshape(-1, 1),
                 "tables": (emb["table_0"].clone(), emb["table_1"].clone())}
    del params, emb, record
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": card, "parameters": n, "parameter_bytes": nbytes, "init_s": init_s,
            "serve": serve, "k1_vs_plain_max_abs_diff": emb_diff,
            "prefill_vs_plain_max_abs_diff": pre_diff}, counts, k1_inputs, emb_diff


def ssm_full_width(torch, card):
    """The [ssm] phase (ROADMAP 18b-ii, and 18b-i'): mamba2-370m and
    zamba2-1.2b at full width, each served through ``ServeEngine`` with
    its QR vocabulary through K1, held against the plain route and teacher
    forcing, its cache sized, the f32 model against the CPU and training
    through ``Trainer``; Mamba's 8,192-token prompt and its prefill state
    against token-by-token decoding; one wave of the full-width
    qwen3-14b.  Returns the launch counts of the
    paths, K1's inputs at Mamba's and Qwen3's vocabularies, and K1's
    largest error."""
    from repro_torch.configs import mamba2_370m, zamba2_1_2b
    from repro_torch.models import lm

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  held on the card at the phase's start: {torch.cuda.memory_allocated()} B")
    state = _ssm_state_check(torch, mamba2_370m)
    print(f"  ({time.perf_counter() - t0:.0f} s into [ssm])")
    counts, k1, errs = {}, {}, []
    mamba, counts["ssm_mamba"], k1["mamba"], err = _ssm_arch(
        torch, lm, mamba2_370m, card, SSM_MAMBA, SSM_MAMBA_CACHE)
    errs.append(err)
    print(f"  ({time.perf_counter() - t0:.0f} s into [ssm])")
    zamba, counts["ssm_zamba"], _, err = _ssm_arch(torch, lm, zamba2_1_2b, card, SSM_ZAMBA,
                                                   SSM_ZAMBA_CACHE)
    errs.append(err)
    print(f"  ({time.perf_counter() - t0:.0f} s into [ssm])")
    qwen, counts["ssm_qwen3"], k1["qwen3"], err = _qwen3_wave(torch, lm, card)
    errs.append(err)
    print(f"  ({time.perf_counter() - t0:.0f} s into [ssm])")
    prof = {"card": card, "state_check": state, "mamba2_370m": mamba, "zamba2_1_2b": zamba,
            "qwen3_14b": qwen, "phase_s": time.perf_counter() - t0}
    print(f"  card: {card}; [ssm] {prof['phase_s']:.1f} s")
    print(json.dumps({"ssm_profile": prof}))
    return counts, k1, max(errs)


# [encdec] and [vlm]: the encoder-decoder and the VLM (ROADMAP 18b-iii) at
# full width on the card, their QR vocabularies looked up through K1 when
# serving: seamless-m4t-large-v2 whole (vocab 256,206 as 64,052 + 4 rows x
# 1,024, bf16, mult; stub audio frames) and llava-next-34b cut to 28 of its
# 60 layers (vocab 64,000 as 16,000 + 4 rows x 7,168; 1,152 stub patches per
# request, which bypass the vocabulary; the full depth would take 68.3 GB)
ENCDEC_PARAMS = (1_436_418_048, 2_872_836_096)    # jax.eval_shape of the reference's init
VLM_LAYERS = 28
VLM_PARAMS = (16_296_225_792, 32_592_451_584)     # the same at 28 layers
# f32 card vs CPU: seamless at 2 encoder + 2 decoder layers; llava at 1 layer
# and 64 of its 1,152 patches (the CPU's side of the check stays seconds)
ENCDEC_F32_CUT = {"enc_layers": 2, "dec_layers": 2}
VLM_F32_LAYERS, VLM_F32_PATCHES = 1, 64
ENCDEC_TRAIN_STEPS = 10
# llava trains at 2 layers, B=2, S = 1,152 patches + 256 tokens, by
# Adafactor at lr 1e-4: the arch's default, Adafactor(1e-3), moves every
# weight by about lr in its first steps and at d_model 5,120 overturned
# DeepSeek-V2's random weights (MOE_TRAIN_LR)
VLM_TRAIN_STEPS, VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH, VLM_TRAIN_TEXT = 10, 2, 2, 256
VLM_TRAIN_LR = 1e-4


def _mm_stub(torch, kind, cfg, wave, batch, plen):
    """The stub input of a wave of ``batch`` prompts of ``plen`` tokens, as
    the api's ``batch_fn`` draws it (bf16): ``frames_at(0, wave, batch,
    plen // enc_ratio, d)`` or ``patches_at(0, wave, batch, n_patches, d)``."""
    from repro_torch.data import lm as lm_data

    if kind == "encdec":
        return lm_data.frames_at(0, wave, batch, max(1, plen // cfg.enc_ratio), cfg.d_model,
                                 device="cuda").to(torch.bfloat16)
    return lm_data.patches_at(0, wave, batch, cfg.n_patches, cfg.lm.d_model,
                              device="cuda").to(torch.bfloat16)


def _mm_fns(torch, kind, cfg):
    """(make_cache, prefill, decode_step, None) as ``_lm_engine`` and
    ``_ssm_serve`` call them: each prefill call takes the next wave's stub
    input (``_mm_stub`` of the call's index); the VLM's decode writes after
    its ``n_patches`` patch rows, into a cache that many rows longer, as
    ``launch/serve.py`` drives it (ROADMAP §3 finding 13)."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import vlm as vl

    make, prefill, decode = ((ed.encdec_make_cache, ed.encdec_prefill, ed.encdec_decode_step)
                             if kind == "encdec" else
                             (vl.vlm_make_cache, vl.vlm_prefill, vl.vlm_decode_step))
    rows = 0 if kind == "encdec" else cfg.n_patches
    waves = [0]

    def prefill_fn(params, tokens, cache, c):
        stub = _mm_stub(torch, kind, c, waves[0], *tokens.shape)
        waves[0] += 1
        return prefill(params, stub, tokens, cache, c)

    return (lambda c, b, ml, dev: make(c, b, ml + rows, dev), prefill_fn,
            lambda params, tok, pos, cache, c: decode(params, tok, pos + rows, cache, c), None)


def _mm_teacher_forward(torch, lm, kind, cfg, params, stub):
    """The ``forward`` hook of ``_lm_teacher`` for a wave with ``stub``: the
    seamless decoder as its prefill runs it (the cross K/V from the
    memory of the frames; the plain route of the served prefill), or
    llava's LM stack after the projected patches, the text positions."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import vlm as vl

    with torch.inference_mode():
        if kind == "encdec":
            memory = ed.encode(params, stub, cfg)
            return lambda p, h, c: ed._prefill_hidden(
                p, h, memory, ed.encdec_make_cache(c, h.shape[0], h.shape[1], "cuda")["self"],
                c)[0]
        img = vl._project(params, stub, cfg)
    return lambda p, h, c: lm.forward_hidden(p, torch.cat([img, h], 1), c)[0][:, img.shape[1]:]


def _mm_f32_vs_cpu(torch, mod, lm, kind):
    """The arch at full width and cut depth in f32, TF32 off (seamless
    ``ENCDEC_F32_CUT``; llava ``VLM_F32_LAYERS`` layer and
    ``VLM_F32_PATCHES`` patches): one prefill of 2 x 128 tokens after the
    stub input and 4 decode steps, and one ``loss_fn`` value-and-grad,
    card against CPU; and the card's decode against the plain
    teacher-forced training forward at f32.  [lm]'s bounds, and the f32
    decode gap gated at ``SSM_F32_DECODE_TOL``."""
    from repro_torch import tree
    from repro_torch.models import encdec as ed
    from repro_torch.models import vlm as vl
    from repro_torch.train.loop import value_and_grad

    phase = f"[{kind}]"
    if torch.backends.cuda.matmul.allow_tf32:
        _fail(f"{phase} TF32 is on for f32 matrix products")
    f32 = {"param_dtype": "float32", "compute_dtype": "float32"}
    if kind == "encdec":
        cfg = dataclasses.replace(mod.config(), **f32, **ENCDEC_F32_CUT)
        depth, d, vocab = cfg.enc_layers + cfg.dec_layers, cfg.d_model, cfg.vocab
        make, prefill, decode = ed.encdec_make_cache, ed.encdec_prefill, ed.encdec_decode_step
        rows = 0
    else:
        full = mod.config()
        cfg = dataclasses.replace(full, n_patches=VLM_F32_PATCHES, lm=dataclasses.replace(
            full.lm, n_layers=VLM_F32_LAYERS, **f32))
        depth, d, vocab = VLM_F32_LAYERS, cfg.lm.d_model, cfg.lm.vocab
        make, prefill, decode = vl.vlm_make_cache, vl.vlm_prefill, vl.vlm_decode_step
        rows = VLM_F32_PATCHES
    host_api = mod.api(cfg, device="cpu")
    t = time.perf_counter()
    host = host_api.init(torch.Generator().manual_seed(3))
    card = tree.tree_map(lambda x: x.to("cuda"), host)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, vocab, (2, 128), generator=gen)
    stub = torch.randn((2, 32 if kind == "encdec" else rows, d), generator=gen) * 0.1
    toks = [torch.randint(0, vocab, (2, 1), generator=gen) for _ in range(4)]
    out = {}
    with torch.inference_mode():
        for name, params, dev in (("cpu", host, "cpu"), ("card", card, "cuda")):
            cache = make(cfg, 2, rows + 160, dev)
            logits, cache = prefill(params, stub.to(dev), prompts.to(dev), cache, cfg)
            steps = [logits[:, -1]]
            for i, tok in enumerate(toks):
                logits, cache = decode(params, tok.to(dev), rows + 128 + i, cache, cfg)
                steps.append(logits[:, -1])
            out[name] = torch.stack(steps, 1).cpu()
        seq = torch.cat([prompts] + toks, 1).to("cuda")
        if kind == "encdec":
            h = ed.encdec_forward(card, lm.embed_tokens(card, seq, cfg),
                                  ed.encode(card, stub.to("cuda"), cfg), cfg)
            head = card["lm_head"]
        else:
            h = vl.vlm_forward(card, stub.to("cuda"), lm.embed_tokens(card["lm"], seq, cfg.lm),
                               cfg)[0][:, rows:]
            head = card["lm"]["lm_head"]
        teacher = (h[:, 127:] @ head["w"]).cpu()
    scale = float(out["cpu"].abs().max())
    logit_rel = float((out["card"] - out["cpu"]).abs().max()) / scale
    dec_gap = float((out["card"][:, 1:] - teacher[:, 1:]).abs().max())
    dec_rel = dec_gap / float(teacher.abs().max())
    batch = host_api.batch_fn(0, _lm_shape(rows + 64, 2))
    (loss, _), grads = value_and_grad(host_api.loss_fn)(host, batch)
    (card_loss, _), card_grads = value_and_grad(mod.api(cfg).loss_fn)(
        card, {k: v.to("cuda") for k, v in batch.items()})
    worst, where = 0.0, ""
    for (path, g), cg in zip(tree.flatten_with_path(grads), tree.leaves(card_grads)):
        s = float(g.abs().max())
        rel = float((cg.cpu() - g).abs().max()) / s if s else float(cg.abs().max())
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    loss_diff = abs(float(card_loss) - float(loss))
    res = {"layers": depth, "stub_rows": stub.shape[1], "logits_rel_diff": logit_rel,
           "loss": float(loss), "card_loss": float(card_loss), "loss_diff": loss_diff,
           "worst_grad_rel": worst, "worst_grad_leaf": where, "decode_vs_teacher_f32_abs": dec_gap,
           "decode_vs_teacher_f32_rel": dec_rel, "seconds": time.perf_counter() - t}
    print(f"  f32, {depth} layers at full width, {stub.shape[1]} stub rows, card vs CPU: prefill + "
          f"4 decode steps' logits {logit_rel:.3e} of the largest |logit| (tol "
          f"{LM_F32_LOGIT_TOL:.0e}); loss {float(card_loss):.7f} vs {float(loss):.7f} (|diff| "
          f"{loss_diff:.3e}, tol {LM_F32_LOSS_TOL:.0e}); worst gradient leaf {where} {worst:.3e} "
          f"of its largest |g| (tol {GRAD_TOL:.0e}); decode vs the teacher-forced training "
          f"forward at f32: max |diff| {dec_gap:.3e} = {dec_rel:.3e} of the largest |logit| (tol "
          f"{SSM_F32_DECODE_TOL:.0e}); {res['seconds']:.1f} s")
    if not (logit_rel <= LM_F32_LOGIT_TOL and loss_diff <= LM_F32_LOSS_TOL * abs(float(loss))
            and worst <= GRAD_TOL):
        _fail(f"{phase} the f32 {mod.ARCH} on the card disagrees with the CPU")
    if not dec_rel <= SSM_F32_DECODE_TOL:
        _fail(f"{phase} the f32 {mod.ARCH}'s decode on the card disagrees with teacher forcing: "
              f"{dec_rel:.3e} of the largest |logit|, tol {SSM_F32_DECODE_TOL:.0e}")
    return res


def _vlm_train(torch, mod, card):
    """``VLM_TRAIN_STEPS`` Adafactor(``VLM_TRAIN_LR``) steps of llava at full
    width and ``VLM_TRAIN_LAYERS`` layers on the port's LM stream (the
    api's ``batch_fn``: 1,152 patches and 256 tokens per row), by
    ``make_train_step`` in a loop that drops each old state as the next
    one comes: the loss finite and falling; time per step and peak
    memory."""
    from repro_torch import tree
    from repro_torch.optim import optimizers
    from repro_torch.train.loop import init_state, make_train_step

    full = mod.config()
    cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, n_layers=VLM_TRAIN_LAYERS))
    api = mod.api(cfg)
    opt = optimizers.adafactor(VLM_TRAIN_LR)
    shape = _lm_shape(cfg.n_patches + VLM_TRAIN_TEXT, VLM_TRAIN_BATCH)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(5))
    n = sum(x.numel() for x in tree.leaves(params))
    state = init_state(params, opt)
    del params
    train_step = make_train_step(api.loss_fn, opt)
    losses, walls = [], []
    for s in range(VLM_TRAIN_STEPS + 3):
        batch = api.batch_fn(s, shape)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        if s < VLM_TRAIN_STEPS:
            losses.append(float(metrics["loss"]))
        else:
            walls.append(time.perf_counter() - t1)
        if s == VLM_TRAIN_STEPS - 1:
            run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    tail = sum(losses[-3:]) / 3
    if not all(math.isfinite(x) for x in losses):
        _fail(f"[vlm] training losses are not all finite: {losses}")
    if not tail < losses[0]:
        _fail(f"[vlm] the loss did not fall: last 3 steps {tail:.5f} vs step 0 {losses[0]:.5f} "
              f"({losses})")
    wall_ms = sorted(walls)[1] * 1e3
    opt_bytes = _tree_bytes(state["opt"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    prof = {"card": card, "layers": VLM_TRAIN_LAYERS, "parameters": n,
            "optimizer": f"adafactor({VLM_TRAIN_LR:g})", "steps": VLM_TRAIN_STEPS,
            "batch": VLM_TRAIN_BATCH, "patches": cfg.n_patches, "text_tokens": VLM_TRAIN_TEXT,
            "losses": losses, "loss_step_0": losses[0], "loss_last_3": tail,
            "run_s_with_init": run_s, "wall_ms_per_step": wall_ms, "peak_memory_bytes": peak,
            "peak_above_phase_start_bytes": peak - base, "adafactor_state_bytes": opt_bytes}
    print(f"  {VLM_TRAIN_STEPS} Adafactor({VLM_TRAIN_LR:g}) steps at {VLM_TRAIN_LAYERS} layers "
          f"({n:,} parameters), B={VLM_TRAIN_BATCH}, {cfg.n_patches} patches + {VLM_TRAIN_TEXT} "
          f"tokens, in {run_s:.2f} s with init: loss {losses[0]:.5f} at step 0, {tail:.5f} over "
          f"the last 3 | per step wall {wall_ms:.1f} ms (median of 3 after them) | peak {peak} B "
          f"({peak - base} B above the phase's start; Adafactor's factored state {opt_bytes} B)")
    return prof


def mm_full_width(torch, card, kind):
    """The [encdec] or [vlm] phase (ROADMAP 18b-iii): seamless-m4t-large-v2
    whole, or llava-next-34b at ``VLM_LAYERS`` of 60: the f32 model
    against the CPU (which sets the decode tolerance), the size, ``[lm]``'s
    queue served through ``ServeEngine`` with each wave's stub input (one
    K1 per call and no other kernel), K1 and the prefill logits bit-equal
    to the plain route and decode against teacher forcing on wave 0,
    training.  Returns the serving path's launch counts, K1's inputs at
    the arch's vocabulary (the first wave's 16 x 512 prompt ids, a decode
    step's 16) and K1's error."""
    from repro_torch.configs import llava_next_34b, seamless_m4t_large_v2
    from repro_torch.models import lm

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  held on the card at the phase's start: {torch.cuda.memory_allocated()} B")
    mod = seamless_m4t_large_v2 if kind == "encdec" else llava_next_34b
    phase = f"[{kind}]"
    t0 = time.perf_counter()
    f32 = _mm_f32_vs_cpu(torch, mod, lm, kind)
    print(f"  ({time.perf_counter() - t0:.1f} s into {mod.ARCH})")
    if kind == "encdec":
        cfg, sizes = mod.config(), ENCDEC_PARAMS
        depth = cfg.enc_layers + cfg.dec_layers
    else:
        full = mod.config()
        cfg = dataclasses.replace(full, lm=dataclasses.replace(full.lm, n_layers=VLM_LAYERS))
        sizes, depth = VLM_PARAMS, VLM_LAYERS
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    params = mod.api(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n, nbytes = lm.num_params(params), _tree_bytes(params)
    emb_params, emb_cfg = (params, cfg) if kind == "encdec" else (params["lm"], cfg.lm)
    emb = emb_params["embed"]
    shape = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, {cfg.n_heads} heads "
             f"of {cfg.d_head}, d_ff {cfg.d_ff} (gelu), frames of 1 per {cfg.enc_ratio} tokens"
             if kind == "encdec" else
             f"{VLM_LAYERS} of {full.lm.n_layers} layers, {emb_cfg.n_heads} heads / "
             f"{emb_cfg.n_kv_heads} KV heads of {emb_cfg.d_head}, d_ff {emb_cfg.d_ff}, "
             f"{cfg.n_patches} patches per request")
    print(f"  {cfg.name}: vocab {emb_cfg.vocab}, d {emb_cfg.d_model}, {shape}, QR "
          f"c={emb_cfg.embedding.num_collisions} {emb_cfg.embedding.op} vocabulary "
          f"{tuple(emb['table_0'].shape)} + {tuple(emb['table_1'].shape)}, "
          f"{emb_cfg.param_dtype}: {n:,} parameters, {nbytes:,} B "
          f"({torch.cuda.memory_allocated() - base} B on the card), drawn in {init_s:.1f} s")
    if (n, nbytes) != sizes:
        _fail(f"{phase} {cfg.name}: {n} parameters / {nbytes} B, expected {sizes}")

    fns = _mm_fns(torch, kind, cfg)
    serve, counts, record, dec_tokens = _ssm_serve(
        torch, lm, cfg, params, fns, cfg.name, LM_QUEUE, LM_NEW_TOKENS, phase=phase,
        emb=(emb_params, emb_cfg))
    print(f"  ({time.perf_counter() - t0:.1f} s into {cfg.name})")
    prompts = record[0][0]
    forward = _mm_teacher_forward(torch, lm, kind, cfg, params,
                                  _mm_stub(torch, kind, cfg, 0, *prompts.shape))
    tol_rel = _lm_decode_tol(f32["decode_vs_teacher_f32_rel"], depth, f32_layers=f32["layers"])
    emb_diff, pre_diff, dec = _lm_teacher(torch, lm, emb_cfg, emb_params, record, tol_rel,
                                          forward=forward)
    print(f"  wave 0 ({prompts.shape[0]} x {prompts.shape[1]} tokens after their "
          f"{'frames' if kind == 'encdec' else 'patches'}): K1 vs embed.apply max |diff| "
          f"{emb_diff}; prefill logits vs the plain route max |diff| {pre_diff}; decode "
          f"({dec['steps']} steps) vs teacher forcing max |diff| {dec['max_abs_diff']:.4f} = "
          f"{dec['rel_diff']:.4f} of the largest |logit| (tol {tol_rel:.4f} = the f32 gap x 2^16 "
          f"x sqrt({depth} / {f32['layers']})); greedy agrees on {dec['argmax_agree']}/"
          f"{dec['positions']}, on {dec['clear_positions']} positions the top-2 gap exceeds the "
          f"tolerance and {dec['clear_disagree']} of them disagree (median top-2 gap "
          f"{dec['median_top2_gap']:.4f})")
    if emb_diff != 0 or pre_diff != 0:
        _fail(f"{phase} {cfg.name}: K1 or the prefill logits differ from the plain route")
    if dec["rel_diff"] > tol_rel or dec["clear_disagree"]:
        _fail(f"{phase} {cfg.name}: decode disagrees with teacher forcing beyond the tolerance")
    k1_inputs = {"prefill": prompts.reshape(-1, 1), "decode": dec_tokens,
                 "tables": (emb["table_0"].clone(), emb["table_1"].clone())}
    del params, emb, emb_params, record, forward
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  ({time.perf_counter() - t0:.1f} s into {cfg.name})")
    train = (_ssm_train(torch, mod, card, ENCDEC_TRAIN_STEPS, phase) if kind == "encdec"
             else _vlm_train(torch, mod, card))
    prof = {"card": card, "arch": cfg.name, "layers": depth, "parameters": n,
            "parameter_bytes": nbytes, "init_s": init_s, "serve": serve,
            "k1_vs_plain_max_abs_diff": emb_diff, "prefill_vs_plain_max_abs_diff": pre_diff,
            "decode_vs_teacher": dec, "f32_vs_cpu": f32, "train": train,
            "phase_s": time.perf_counter() - t0}
    print(f"  card: {card}; {phase} {prof['phase_s']:.1f} s")
    print(json.dumps({f"{kind}_profile": prof}))
    return {kind: counts}, k1_inputs, emb_diff


# ------------------------------------------------------------------ [granite]

# [granite]: the full-width granite-8b (llama arch at 36 x 4,096, 32 heads /
# 8 KV heads of 128, d_ff 14,336), its 49,152-token vocabulary a bf16 QR pair
# of 12,288 + 4 rows x 4,096 looked up through K1 when serving.  Served whole;
# trained at GRANITE_TRAIN_LAYERS of its 36 layers, where Adam's f32 state
# and the step's new state fit the card (the whole model's Adam state alone
# is 64.8 GB)
GRANITE_PARAMS = (8_103_710_720, 16_207_421_440)        # jax.eval_shape of the reference's init
GRANITE_TRAIN_LAYERS = 8
GRANITE_TRAIN_PARAMS = (1_996_574_720, 3_993_149_440)   # the same at 8 layers
GRANITE_TRAIN_STEPS = 10


def granite_full_width(torch, card):
    """The [granite] phase: granite-8b at full width, held as [lm] holds
    TinyLlama: the f32 model at 2 layers card against CPU, ``LM_QUEUE``'s
    48 requests served whole through ``ServeEngine`` with one K1 per call
    (K1 and the prefill logits bit-equal to the plain route, decode within
    the f32 gap x 2^16 x sqrt(36 / 2) of teacher forcing), a decode step's
    device time, and ``GRANITE_TRAIN_STEPS`` Adam steps through ``Trainer``
    at ``GRANITE_TRAIN_LAYERS`` layers.  Returns the serving launch counts,
    K1's inputs at granite's vocabulary and K1's error."""
    from repro_torch.configs import granite_8b
    from repro_torch.models import lm

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  held on the card at the phase's start: {torch.cuda.memory_allocated()} B")
    f32 = _lm_f32_vs_cpu(torch, granite_8b, lm, phase="[granite]")
    print(f"  ({time.perf_counter() - t0:.1f} s into [granite])")
    cfg = granite_8b.config()
    t = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n, nbytes = lm.num_params(params), _tree_bytes(params)
    emb = params["embed"]
    print(f"  {cfg.name}: vocab {cfg.vocab}, d {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {cfg.d_head}, d_ff {cfg.d_ff}, "
          f"QR c={cfg.embedding.num_collisions} {cfg.embedding.op} vocabulary "
          f"{tuple(emb['table_0'].shape)} + {tuple(emb['table_1'].shape)}, {cfg.param_dtype}: "
          f"{n:,} parameters, {nbytes:,} B, drawn in {init_s:.1f} s")
    if (n, nbytes) != GRANITE_PARAMS:
        _fail(f"[granite] {n} parameters / {nbytes} B, expected {GRANITE_PARAMS}")
    serve, counts, record, dec_tokens = _ssm_serve(torch, lm, cfg, params, _lm_fns(), cfg.name,
                                                   LM_QUEUE, LM_NEW_TOKENS, phase="[granite]")
    print(f"  ({time.perf_counter() - t0:.1f} s into [granite])")
    tol_rel = _lm_decode_tol(f32["decode_vs_teacher_f32_rel"], cfg.n_layers)
    emb_diff, pre_diff, dec = _lm_teacher(torch, lm, cfg, params, record, tol_rel)
    print(f"  wave 0: K1 vs embed.apply max |diff| {emb_diff}; prefill logits vs the plain "
          f"teacher-forced forward max |diff| {pre_diff}; decode ({dec['steps']} steps) vs "
          f"teacher forcing max |diff| {dec['max_abs_diff']:.4f} = {dec['rel_diff']:.4f} of the "
          f"largest |logit| (tol {tol_rel:.4f} = the f32 gap x 2^16 x sqrt({cfg.n_layers} / 2))"
          f"; greedy agrees on {dec['argmax_agree']}/{dec['positions']}, on "
          f"{dec['clear_positions']} positions the top-2 gap exceeds the tolerance and "
          f"{dec['clear_disagree']} of them disagree (the largest teacher-forced top-2 gap where "
          f"greedy differs {dec['largest_gap_where_greedy_differs']:.4f}, median gap "
          f"{dec['median_top2_gap']:.4f})")
    if emb_diff != 0 or pre_diff != 0:
        _fail("[granite] K1 or the prefill logits differ from the plain route")
    if dec["rel_diff"] > tol_rel or dec["clear_disagree"]:
        _fail("[granite] decode disagrees with teacher forcing beyond the tolerance")
    gen = torch.Generator(device="cuda").manual_seed(10)
    k1_inputs = {"prefill": torch.randint(0, cfg.vocab, (LM_LONG_PROMPT, 1), generator=gen,
                                          device="cuda"),
                 "decode": dec_tokens.reshape(-1, 1),
                 "tables": (emb["table_0"].clone(), emb["table_1"].clone())}
    del params, emb, record
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  ({time.perf_counter() - t0:.1f} s into [granite])")
    cut = dataclasses.replace(cfg, n_layers=GRANITE_TRAIN_LAYERS)
    sizes = lm.init(torch.Generator().manual_seed(0), cut, "meta")
    if (lm.num_params(sizes), _tree_bytes(sizes)) != GRANITE_TRAIN_PARAMS:
        _fail(f"[granite] the {GRANITE_TRAIN_LAYERS}-layer cut is not {GRANITE_TRAIN_PARAMS}")
    print(f"  training at {GRANITE_TRAIN_LAYERS} of {cfg.n_layers} layers: "
          f"{GRANITE_TRAIN_PARAMS[0]:,} parameters, {GRANITE_TRAIN_PARAMS[1]:,} B")
    train = _ssm_train(torch, granite_8b, card, GRANITE_TRAIN_STEPS, "[granite]", cut)
    prof = {"card": card, "arch": cfg.name, "parameters": n, "parameter_bytes": nbytes,
            "init_s": init_s, "serve": serve, "k1_vs_plain_max_abs_diff": emb_diff,
            "prefill_vs_plain_max_abs_diff": pre_diff, "decode_vs_teacher": dec,
            "f32_vs_cpu": f32, "train_layers": GRANITE_TRAIN_LAYERS,
            "train_parameters": GRANITE_TRAIN_PARAMS[0], "train": train,
            "phase_s": time.perf_counter() - t0}
    print(f"  card: {card}; [granite] {prof['phase_s']:.1f} s")
    print(json.dumps({"granite_profile": prof}))
    return counts, k1_inputs, emb_diff


# ------------------------------------------------------------------ [mesh] / [dryrun]

MESH_DIR = os.path.join(ROOT, "build", "mesh")
MESH_PARAMS = 135_528_097           # the full-width DLRM-Criteo (26 Kaggle tables, QR c=4)
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
# one cell per family of the ten assigned archs on pod_32x8 (dense, moe, ssm,
# hybrid, audio, vlm), the dense family at every shape kind
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
                ("tinyllama-1.1b", "decode_32k"), ("deepseek-v2-236b", "decode_32k"),
                ("mamba2-370m", "long_500k"), ("zamba2-1.2b", "decode_32k"),
                ("seamless-m4t-large-v2", "decode_32k"), ("llava-next-34b", "decode_32k"))
DRYRUN_TIMEOUT = 600


def _mesh_lane(torch, cfg, qparams, warm, main, label, **kw):
    """One engine over ``warm`` then the timed ``main`` requests; the launch
    counts of the timed pass (one K2 per dense stage and one grouped K4 per
    wave the tables served: ``_cache_counts``), its scores and metrics."""
    import numpy as np

    from repro_torch.serve.recsys import RecsysEngine

    engine = RecsysEngine(cfg, qparams, max_batch=256, batching="continuous", **kw)
    for dense, bags in warm:
        engine.submit(dense, bags)
    engine.run_until_drained()
    engine.reset_metrics()
    torch.cuda.synchronize()
    _zero_counts()
    uids = [engine.submit(dense, bags) for dense, bags in main]
    done = engine.run_until_drained()
    counts = _read_counts()
    m = engine.metrics()
    scores = np.array([done[u].score for u in uids], dtype=np.float32)
    if len(scores) != len(main) or not np.isfinite(scores).all():
        _fail(f"[mesh] {label}: not every request was scored with a finite value")
    _check_counts(f"mesh/{label}", counts, _cache_counts(m))
    cache = "" if "cache" not in m else (
        f" | paths {m['cache_paths']} | hits {m['cache']['hits']} misses "
        f"{m['cache']['misses']} evictions {m['cache']['evictions']} rejections "
        f"{m['cache']['rejections']}")
    print(f"  {label}: {m['requests']} requests in {m['waves']} waves | p50 {m['p50_ms']:.3f} ms "
          f"p99 {m['p99_ms']:.3f} ms qps {m['qps']:.1f}{cache}")
    return counts, scores, m


MESH_CACHES = (("device", 1 << 20), ("host", 4096))   # [mesh]'s cache lanes: kind, rows


def _mesh_cache_lanes(torch, cfg, qparams, warm, main, mesh):
    """The meshed engine through each of ``MESH_CACHES`` against the
    unmeshed engine through the same cache: scores bit-equal, the cache's
    statistics and branches and the launches equal, nothing gathered.
    Returns the meshed lanes' launch counts and the lanes' figures."""
    import numpy as np

    from repro_torch.serve.cache import DeviceHotRowCache, HotRowCache

    total, lanes = {}, {}
    for kind, rows in MESH_CACHES:
        make = {"device": DeviceHotRowCache, "host": HotRowCache}[kind]
        name = f"{kind} cache of {rows} rows"
        c_one, one, m_one = _mesh_lane(torch, cfg, qparams, warm, main, f"unmeshed, {name}",
                                       cache=make(rows))
        c_mesh, got, m_mesh = _mesh_lane(torch, cfg, qparams, warm, main, f"meshed, {name}",
                                         mesh=mesh, cache=make(rows))
        if not np.array_equal(got, one):
            _fail(f"[mesh] {name}: meshed scores differ from the unmeshed engine's: max |diff| "
                  f"{float(np.abs(got - one).max()):.3e}")
        for key in ("cache", "cache_paths", "waves"):
            if m_mesh[key] != m_one[key]:
                _fail(f"[mesh] {name}: {key} {m_mesh[key]} against the unmeshed {m_one[key]}")
        if c_mesh != c_one:
            _fail(f"[mesh] {name}: launches {c_mesh} against the unmeshed {c_one}")
        if m_mesh["mesh"]["gather_bytes"] != 0:
            _fail(f"[mesh] {name}: a (1, 1) mesh gathered {m_mesh['mesh']['gather_bytes']} B")
        print(f"  {name}: meshed scores bit-equal to the unmeshed engine's on {len(main)} "
              f"requests; cache statistics, branches and launches equal; nothing gathered")
        _add_counts(total, c_mesh)
        lanes[kind] = {"rows": rows, "waves": m_mesh["waves"], "paths": m_mesh["cache_paths"],
                       "hit_rate": m_mesh["cache"]["hit_rate"], "launches": c_mesh,
                       "unmeshed": {k: m_one[k] for k in ("p50_ms", "p99_ms", "qps")},
                       "meshed": {k: m_mesh[k] for k in ("p50_ms", "p99_ms", "qps")}}
    return total, lanes


def mesh_full_width(torch, card):
    """``[mesh]``: the full-width int8 DLRM-Criteo served by
    ``RecsysEngine(mesh=)`` on a (data=1, model=1) NCCL ``DeviceMesh`` of
    this card, and by the unmeshed engine on the same 2,048 requests in
    waves of 256: scores bit-equal, one grouped K4 and one K2 per wave and
    nothing else on each, nothing gathered; then both through each of
    ``MESH_CACHES`` (``_mesh_cache_lanes``).  Returns the meshed runs'
    launch counts."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import dlrm_criteo
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.dlrm import dlrm_init
    from repro_torch.serve.quantize import quantize_params

    t0 = time.perf_counter()
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=False), use_kernel=True)
    params = dlrm_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n = sum(leaf.numel() for leaf in tree.leaves(params))
    if n != MESH_PARAMS:
        _fail(f"[mesh] the full-width DLRM-Criteo has {n} parameters, expected {MESH_PARAMS}")
    qparams = quantize_params(params, mode="int8")
    del params
    warm, main = _serve_requests(cfg)
    os.makedirs(MESH_DIR, exist_ok=True)
    store = os.path.join(MESH_DIR, "store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_local_mesh(1, 1)
        print(f"  {n} parameters, int8 tables; mesh {mesh}")
        _, one, m_one = _mesh_lane(torch, cfg, qparams, warm, main, "unmeshed")
        counts, got, m_mesh = _mesh_lane(torch, cfg, qparams, warm, main, "meshed", mesh=mesh)
        _, again, m_again = _mesh_lane(torch, cfg, qparams, warm, main, "meshed again",
                                       mesh=mesh)
        cached, lanes = _mesh_cache_lanes(torch, cfg, qparams, warm, main, mesh)
    finally:
        dist.destroy_process_group()
    if not (np.array_equal(got, one) and np.array_equal(again, one)):
        _fail(f"[mesh] meshed scores differ from the unmeshed engine's: max |diff| "
              f"{float(np.abs(got - one).max()):.3e}")
    if m_mesh["mesh"]["gather_bytes"] != 0:
        _fail(f"[mesh] a (1, 1) mesh gathered {m_mesh['mesh']['gather_bytes']} B")
    print(f"  meshed scores bit-equal to the unmeshed engine's on {len(main)} requests; "
          f"nothing gathered")
    prof = {"card": card, "requests": len(main), "waves": m_mesh["waves"],
            "unmeshed": {k: m_one[k] for k in ("p50_ms", "p99_ms", "qps")},
            "meshed": {k: m_mesh[k] for k in ("p50_ms", "p99_ms", "qps")},
            "meshed_again": {k: m_again[k] for k in ("p50_ms", "p99_ms", "qps")},
            "cache_lanes": lanes, "phase_s": time.perf_counter() - t0}
    print(f"  card: {card}; [mesh] {prof['phase_s']:.1f} s")
    print(json.dumps({"mesh_profile": prof}))
    _add_counts(counts, cached)
    return counts


def _dryrun_start():
    """Start the dry run's cells, one process each, all together, on the
    CPU alone and at the lowest priority: they take the cores the worlds of
    [dist] to [analysis] leave idle."""
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    for a, s in DRYRUN_CELLS:
        BACKGROUND.start(f"dryrun_{a}_{s}", [sys.executable, "-m", "repro_torch.launch.dryrun",
                                             "--arch", a, "--shape", s, "--mesh", "single",
                                             "--out", DRYRUN_DIR, "--force"], env=env, nice=19)


def dryrun_cells(card):
    """``[dryrun]``: the port's dry run of ``DRYRUN_CELLS`` at full width on
    pod_32x8 (a fake process group of 256 in each of the cells' processes,
    started together with [dist] by ``_dryrun_start``; ``meta`` tensors,
    nothing launched), then the roofline at the H100 constants.  Gates:
    every cell ``ok``, each cell's MODEL/counted flops at most 1, and its
    argument bytes times the 256 GPUs at least the unsharded arguments'."""
    from repro_torch.benchmarks import roofline

    t0 = time.perf_counter()
    slowest = 0.0
    for a, s in DRYRUN_CELLS:
        proc, secs = BACKGROUND.wait(f"dryrun_{a}_{s}", DRYRUN_TIMEOUT)
        slowest = max(slowest, secs)
        if proc.returncode != 0:
            print((proc.stdout + proc.stderr)[-3000:])
            _fail(f"[dryrun] {a} {s} exited {proc.returncode}")
    cells = []
    for arch, shape in DRYRUN_CELLS:
        with open(os.path.join(DRYRUN_DIR, f"{arch}__{shape}__pod_32x8.json")) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            _fail(f"[dryrun] {arch} {shape}: {rec.get('error')}")
        c = roofline.analyze_cell(rec)
        mem = rec["memory_analysis"]
        print(f"  {arch} {shape}: flops {rec['flops_per_chip']:.6g}, bytes "
              f"{rec['hbm_bytes_per_chip']:.6g}, wire by axis "
              f"{ {k: round(v) for k, v in rec['collective_wire_bytes_by_axis'].items()} }, "
              f"argument {mem['argument_size_in_bytes']:.6g} B, peak {mem['peak_live_bytes']:.6g}"
              f" B per GPU; dominant {c['dominant']}; MODEL/counted "
              f"{c['model_over_counted_flops']:.4f} (depths {rec['depths_traced']} of "
              f"{rec['depth']}, {rec['time_trace_s']} s)")
        if not c["model_over_counted_flops"] <= 1.0:
            _fail(f"[dryrun] {arch} {shape}: counted flops below the model's useful flops")
        total = mem["argument_size_in_bytes"] * rec["devices"]
        if total < mem["unsharded_argument_bytes"]:
            _fail(f"[dryrun] {arch} {shape}: {rec['devices']} GPUs hold {total} B of arguments, "
                  f"under the unsharded {mem['unsharded_argument_bytes']} B")
        cells.append(c)
    print("  roofline at the H100 constants (derived, not measured):")
    print("  " + roofline.markdown_table(cells).replace("\n", "\n  "))
    secs = time.perf_counter() - t0
    print(f"  card: {card}; [dryrun] {len(cells)} cells in {slowest:.1f} s from their start "
          f"with [dist] to the last one's exit, beside the phases; {secs:.1f} s here")
    print(json.dumps({"dryrun_profile": {"card": card, "seconds": secs,
                                         "cells_wall_s": slowest, "cells": cells}}))


def _lm_gather_bound(ids, w_a, w_b):
    """K1 on the LM's vocabulary pair at these ids: the raw ids once, each
    distinct row of both tables once, the output once (table dtype); one
    f32 multiply per output element."""
    m, d, elem = w_a.shape[0], w_a.shape[1], w_a.element_size()
    n = ids.numel()
    rows = _distinct(ids % m) + _distinct(ids // m)
    return n * ids.element_size() + rows * d * elem + n * d * elem, n * d


def time_lm_k1(torch, lm_k1, model, prefix, launches):
    """K1 at an LM's two shapes, as ``embed_serving`` calls it (raw ids
    ``(N, 1)``, one bf16 QR pair): the 8,192-token prompt and one decode
    step of 16 — held bit for bit against its plain version, timed beside
    it and beside two ``F.embedding`` calls and the multiply on pre-split
    ids, with its bound from these ids.  ``model`` names the vocabulary,
    ``prefix`` the entries' keys, ``launches`` K1's launches on the model's
    serving paths."""
    import torch.nn.functional as tf

    from repro_torch.kernels import qr_gather, ref

    w_a, w_b = lm_k1["tables"]
    m = w_a.shape[0]
    group = [ref.GroupTable(w_a, w_b, m=m, op="mult")]
    out = {}
    for name in ("prefill", "decode"):
        ids = lm_k1[name]
        got = qr_gather.qr_gather_grouped(ids, group)
        if not torch.equal(got, ref.qr_gather_grouped(ids, group)):
            _fail(f"[time] K1 at {model}'s {name} shape differs from its plain version")
        rem, quo = ids[:, 0] % m, ids[:, 0] // m
        nbytes, ops = _lm_gather_bound(ids, w_a, w_b)
        bound_ms, bound_by = _bound(nbytes, ops)
        out[f"{prefix}_{name}"] = e = {
            "shape": f"{model}'s vocabulary, {str(w_a.dtype).removeprefix('torch.')} QR pair "
                     f"{m} + {w_b.shape[0]} rows x "
                     f"{w_a.shape[1]}, {ids.shape[0]} raw int64 ids, one launch",
            "ms": _time_ms(torch, lambda ids=ids: qr_gather.qr_gather_grouped(ids, group), 200),
            "plain_ms": _time_ms(torch, lambda ids=ids: ref.qr_gather_grouped(ids, group), 50),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes, "bound_ops": ops,
            "yardstick": "two F.embedding calls + the multiply on pre-split ids",
            "yardstick_ms": _time_ms(torch, lambda rem=rem, quo=quo: tf.embedding(rem, w_a)
                                     * tf.embedding(quo, w_b), 200),
            "max_abs_err": 0.0, "launches_on_lm_paths": launches}
        print(f"  K1 at {model}'s {name} shape ({ids.shape[0]} ids): {e['ms']:.6f} ms, plain "
              f"{e['plain_ms']:.6f}, two F.embedding + multiply {e['yardstick_ms']:.6f}, bound "
              f"{bound_ms:.6f} ({bound_by}, {nbytes} B)")
    return out


def _paper_device_profile(torch, pt, spec, warm=3, steps=5):
    """Device ms and device operations per training step of one
    ``paper_tables`` row (``torch.profiler``, ``steps`` steps after
    ``warm``, each step's batch drawn on the CPU and copied as the row's
    loop does), and the top device operations."""
    from repro_torch.train.loop import init_state, make_train_step

    _, api, params = pt.setup(pt.MODULES[spec.net], **spec.kw)
    held = {"state": init_state(pt.to_device(params, "cuda"), api.optimizer)}
    step_fn = make_train_step(api.loss_fn, api.optimizer)

    def run(lo, hi):
        for s in range(lo, hi):
            held["state"], _ = step_fn(held["state"], pt.to_device(api.batch_fn(s, pt.SHAPE),
                                                                   "cuda"))

    run(0, warm)
    torch.cuda.synchronize()
    _, dev, ops_by_name = _profile_device(lambda: run(warm, warm + steps))
    return sum(dev.values()) / steps / 1e3, sum(ops_by_name.values()) / steps, \
        _top_ms(dev, steps, k=6)


def _k6_calls_per_step(cfg) -> int:
    """K6 calls of one training step of ``cfg`` on the card: one per dtype
    and width of its dense mult/add QR pairs, per ``MAX_PAIRS`` of them (none
    with ``use_kernel`` or in feature mode)."""
    from repro_torch.kernels.qr_pairs_backward import MAX_PAIRS
    from repro_torch.models import dlrm

    if getattr(cfg, "use_kernel", False) or cfg.embedding.kind == "feature":
        return 0
    widths = {}
    for mod in dlrm.tables_for(cfg):
        if dlrm._qr2(mod):
            widths[mod.out_dim] = widths.get(mod.out_dim, 0) + 1
    return sum(-(-n // MAX_PAIRS) for n in widths.values())


def _first_steps_vs_cpu(torch, pt, mod, spec, card_losses):
    """[paper]'s check (c): the row's first ``PAPER_CPU_STEPS`` steps on
    the machine's CPU and, from each of those states on the same batch,
    the card's loss (within rtol ``PAPER_CPU_RTOL`` of the CPU's) and
    gradients (each leaf within ``GRAD_TOL`` of its largest |g|).  Also
    measures, unchecked, how far the free-running first steps split: the
    card's ``card_losses`` against the CPU's, and a second card run
    against the first."""
    from repro_torch import tree
    from repro_torch.train.loop import init_state, make_train_step, value_and_grad

    _, api, params = pt.setup(mod, **spec.kw)
    grads_of = value_and_grad(api.loss_fn)
    step_fn = make_train_step(api.loss_fn, api.optimizer)
    state = init_state(params, api.optimizer)
    cpu_losses, loss_rel, grad_rel = [], 0.0, 0.0
    for s in range(PAPER_CPU_STEPS):
        batch = api.batch_fn(s, pt.SHAPE)
        (loss, _), grads = grads_of(state["params"], batch)
        (card_loss, _), card_grads = grads_of(pt.to_device(state["params"], "cuda"),
                                              pt.to_device(batch, "cuda"))
        loss_rel = max(loss_rel, abs(float(card_loss) - float(loss)) / abs(float(loss)))
        for g, cg in zip(tree.leaves(grads), tree.leaves(card_grads)):
            scale = float(g.abs().max())
            diff = float((cg.cpu() - g).abs().max())
            grad_rel = max(grad_rel, diff / scale if scale else diff)
        cpu_losses.append(float(loss))
        state, _ = step_fn(state, batch)
    if not (loss_rel <= PAPER_CPU_RTOL and grad_rel <= GRAD_TOL):
        _fail(f"{spec.name}: from the CPU's first {PAPER_CPU_STEPS} states the card's loss is "
              f"{loss_rel:.3e} relative (tol {PAPER_CPU_RTOL:.0e}) and its worst gradient leaf "
              f"{grad_rel:.3e} of its largest |g| (tol {GRAD_TOL:.0e}) from the CPU's")
    again = pt.train(api.loss_fn, api.optimizer, params, lambda s: api.batch_fn(s, pt.SHAPE),
                     PAPER_CPU_STEPS, "cuda").losses

    def rel(xs, ys):
        return max(abs(x - y) / abs(y) for x, y in zip(xs, ys))

    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "cpu_losses": cpu_losses,
            "free_vs_cpu_rel": rel(card_losses, cpu_losses),
            "free_vs_card_rel": rel(again, card_losses)}


def paper_rows(torch, card):
    """The [paper] phase: ``PAPER_ROWS`` of ``paper_tables`` on the card at
    the reference's 400 steps, each held to (a) a finite, falling training
    loss, (b) kernel scoring equal to plain with the expected launches
    (``run_row`` raises otherwise), (c) its first ``PAPER_CPU_STEPS``
    steps equal to the CPU's (``_first_steps_vs_cpu``), and (d) its held-out BCE
    within its tolerance of ``reference_rows.json``; then
    ``PAPER_FULL_CPU`` trained on the CPU too, and the device profile of
    ``PAPER_PROFILED``.  Returns the path's launch counts."""
    from repro_torch.benchmarks import paper_tables as pt

    with open(os.path.join(ROOT, "src", "repro_torch", "benchmarks", "reference_rows.json")) as f:
        ref = json.load(f)
    if ref["steps"] != pt.TRAIN_STEPS:
        _fail(f"reference rows are of {ref['steps']} steps, paper_tables trains "
              f"{pt.TRAIN_STEPS} (REPRO_BENCH_STEPS)")
    specs = {s.name: s for s in pt.row_specs()}
    out, expected = {}, {}
    _zero_counts()
    t = time.perf_counter()
    for name in PAPER_ROWS:
        spec = specs[name]
        mod = pt.MODULES[spec.net]
        r = pt.run_row(mod, device="cuda", **spec.kw)
        losses = r.train_losses
        tail = sum(losses[-10:]) / 10
        if len(losses) != pt.TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            _fail(f"{name}: training losses are not all finite")
        if not tail < losses[0]:
            _fail(f"{name}: the loss did not fall: last 10 {tail:.5f} vs step 0 {losses[0]:.5f}")
        if r.kernel is not None:
            for k, v in r.kernel["expected_launches"].items():
                expected[k] = expected.get(k, 0) + v
        # K6 on every gradient the row takes on the card: its training, and
        # the first steps' check below (a gradient and a step each)
        k6 = (pt.TRAIN_STEPS + 2 * PAPER_CPU_STEPS) \
            * _k6_calls_per_step(pt.setup(mod, **spec.kw)[0])
        if k6:
            expected["qr_pairs_backward"] = expected.get("qr_pairs_backward", 0) + k6
        first = _first_steps_vs_cpu(torch, pt, mod, spec, losses[:PAPER_CPU_STEPS])
        want = ref["rows"][name]
        gap = abs(r.loss - want["loss"])
        if r.params != want["params"]:
            _fail(f"{name}: {r.params} parameters, the reference {want['params']}")
        out[name] = {"heldout_bce": r.loss, "heldout_acc": r.acc, "params": r.params,
                     "us_per_step": r.us_per_step, "batch_share": r.batch_share,
                     "loss_step_0": losses[0], "loss_last_10": tail,
                     "first_steps": first, "reference_bce": want["loss"],
                     "abs_dbce_vs_reference": gap, "tol": want["tol"], "kernel": r.kernel}
        k = r.kernel
        print(f"  {name}: held-out BCE {r.loss:.6f} acc {r.acc:.5f} | reference {want['loss']:.6f}"
              f" |Δ| {gap:.6f} (tol {want['tol']:.4f}) | {r.us_per_step:.1f} us/step "
              f"(batch draw + copy {r.batch_share:.3f}) | loss {losses[0]:.5f} -> {tail:.5f} | "
              f"first {PAPER_CPU_STEPS} steps from the CPU's states: loss {first['loss_rel']:.2e}, "
              f"gradients {first['grad_rel']:.2e} (free-running: vs CPU "
              f"{first['free_vs_cpu_rel']:.2e}, vs a second card run "
              f"{first['free_vs_card_rel']:.2e}) | "
              + ("no kernel (DCNConfig has no use_kernel)" if k is None else
                 f"kernels: BCE |Δ| {k['abs_dbce']:.2e}, max |Δlogit| {k['max_abs_dlogit']:.2e}, "
                 f"launches {k['launches']}"), flush=True)
        if not gap <= want["tol"]:
            _fail(f"{name}: held-out BCE {r.loss:.6f} is {gap:.6f} from the reference's "
                  f"{want['loss']:.6f} (tol {want['tol']})")
    run_s = time.perf_counter() - t
    counts = _read_counts()
    _check_counts("paper", counts, expected)

    spec = specs[PAPER_FULL_CPU]
    cpu = pt.run_row(pt.MODULES[spec.net], device="cpu", **spec.kw)
    full_cpu = {"row": PAPER_FULL_CPU, "cpu_heldout_bce": cpu.loss, "cpu_us_per_step":
                cpu.us_per_step, "abs_dbce_card_vs_cpu": abs(cpu.loss - out[PAPER_FULL_CPU][
                    "heldout_bce"])}
    print(f"  {PAPER_FULL_CPU}, {pt.TRAIN_STEPS} steps on the machine's CPU: held-out BCE "
          f"{cpu.loss:.6f}, card {out[PAPER_FULL_CPU]['heldout_bce']:.6f}, |Δ| "
          f"{full_cpu['abs_dbce_card_vs_cpu']:.6f}")
    profiles = {}
    for name in PAPER_PROFILED:
        device_ms, ops, top = _paper_device_profile(torch, pt, specs[name])
        wall_ms = out[name]["us_per_step"] / 1e3
        profiles[name] = {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                          "device_ops_per_step": ops, "device_busy_share": device_ms / wall_ms,
                          "top_device_ms_per_step": top}
        print(f"  {name} per step: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms (busy "
              f"{device_ms / wall_ms:.3f}), {ops:.1f} device operations; top {top}")
    print(f"  card: {card}; {len(PAPER_ROWS)} rows in {run_s:.1f} s")
    print(json.dumps({"paper_profile": {"card": card, "steps": pt.TRAIN_STEPS, "rows": out,
                                        "full_cpu": full_cpu, "profiles": profiles}}))
    return counts


ROWS_COUNTS = os.path.join(ROOT, "build", "background", "paper_counts.json")
SWEEP_HEADER = ("[sweep] the planner-driven compression sweep: 9 models trained on the card, "
                "held against the JAX package's run")
PAPER_HEADER = ("[paper] paper_tables rows trained on the card, held against the CPU and the "
                "reference")


def rows_worker(out):
    """``[sweep]`` and ``[paper]`` in a process of their own, started with
    [dist]: their models are small and their steps wait on the host, so
    they run beside the worlds of [dist] to [analysis] on the cores and
    the card time those leave.  [paper]'s launch counts (zeroed just
    before its rows, read just after, in this process) go to ``out``.
    Returns the exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card_line()
    print(SWEEP_HEADER, flush=True)
    sweep_rows(torch, card)
    print(PAPER_HEADER, flush=True)
    counts = paper_rows(torch, card)
    with open(out, "w") as f:
        json.dump(counts, f)
    return 0


def _rows_start():
    if os.path.exists(ROWS_COUNTS):
        os.remove(ROWS_COUNTS)
    BACKGROUND.start("rows", _smoke_cmd("rows_worker", ROWS_COUNTS))


def rows_read():
    """[sweep] and [paper] as ``rows_worker`` ran them: its output, its exit
    code and [paper]'s launch counts."""
    proc, secs = BACKGROUND.wait("rows", 600)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        _fail(f"[sweep] / [paper] exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"  [sweep] and [paper] in {secs:.1f} s, started with [dist]")
    with open(ROWS_COUNTS) as f:
        return json.load(f)


def drive_bag_path(torch, shapes):
    """K3's own entry point, ``ops.qr_bag_lookup``: as the reference's
    kernel bench calls it (B=32, L=8, m=2048, q=16, D=128, every slot on)
    and on the largest Kaggle table (B=256, L=4, D=16, fractional weights),
    one K3 launch each; then its device operations per call at both
    shapes (``_device_ops_per_call``: exactly one, the kernel).  Returns the
    launch counts and the device operations per call by shape."""
    from repro_torch.kernels import ops

    args = {name: _bag_case(shapes, name, "f32")[:4] for name in ("bench", "serving")}
    _zero_counts()
    outs = {name: ops.qr_bag_lookup(*a) for name, a in args.items()}
    counts = _read_counts()
    _check_counts("bag", counts, {"qr_embedding_bag": 2})
    per_call = {}
    for name, a in args.items():
        _hold(torch, f"ops.qr_bag_lookup {name} B={a[0].shape[0]} L={a[0].shape[1]} "
                     f"D={a[2].shape[1]}", "f32", outs[name],
              ops.qr_bag_lookup(*a, use_kernel=False))
        per_call[name] = _device_ops_per_call(torch, lambda: ops.qr_bag_lookup(*a))
        print(f"  ops.qr_bag_lookup {name}: {per_call[name]['ops']:.1f} device operations per "
              f"call {per_call[name]['by_name']}")
        if per_call[name]["ops"] != 1:
            _fail(f"ops.qr_bag_lookup {name}: {per_call[name]['ops']} device operations per "
                  "call, expected the one K3 launch")
    return counts, per_call


# ATen operations that allocate or re-view storage and launch nothing
_NO_DEVICE_WORK = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "view",
    "_unsafe_view", "reshape", "_reshape_alias", "as_strided", "alias", "detach", "expand",
    "unsqueeze", "squeeze", "select", "slice", "split", "split_with_sizes", "unbind",
    "permute", "transpose", "t", "lift_fresh"})


def _device_ops_per_call(torch, fn, calls: int = 20):
    """Device operations per ``fn()`` call over ``calls`` calls after one
    outside the count: the kernel launches the port's counters count (each
    wrapper counts where it launches its kernel) and every ATen operation
    dispatched on a card tensor that does device work (each a kernel or a
    copy), seen by a ``TorchDispatchMode``.  Returns the mean per call and
    its split by kernel and operation name."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    fn()
    torch.cuda.synchronize()
    seen = {}

    class _Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            # an out-of-place operation that hands back its input (``.to``
            # of the dtype a tensor has) did nothing
            unchanged = not name.endswith("_") and any(out is t for t in ins)
            if name not in _NO_DEVICE_WORK and not unchanged and any(
                    t.device.type == "cuda" for t in ins + [
                        o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]):
                seen[name] = seen.get(name, 0) + 1
            return out

    before = _read_counts()
    with _Log():
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    after = _read_counts()
    by_name = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    for k, v in seen.items():
        by_name[f"aten.{k}"] = v
    return {"ops": sum(by_name.values()) / calls,
            "by_name": {k: v / calls for k, v in by_name.items()}}


def _k4_bound(rem, quo, mask):
    """Bytes the function must move at these inputs (ids, mask and output
    once; each distinct live row once: D int8 bytes + 2 scale + 1 zp) and
    its f32 operations (2 dequant x 2 tables, combine, weight, add per
    element of a live slot)."""
    live = mask > 0
    rows = int(rem[live].unique().numel()) + int(quo[live].unique().numel())
    nbytes = 3 * rem.numel() * 4 + rows * (D + 3) + rem.shape[0] * D * 4
    ops = int(live.sum()) * D * 7
    return nbytes, ops


def _distinct(ids, live=None):
    return int((ids if live is None else ids[live]).unique().numel())


def _gather_bound(rem, quo, row_bytes, ops_per_elem):
    """K1 / K5: ids once, each distinct gathered row once, the f32 or table
    dtype output once (``row_bytes`` is a stored row's bytes, and the
    output's width is ``D`` of 4 bytes at most); f32 operations per output
    element."""
    n = rem.numel()
    nbytes = 2 * n * 4 + (_distinct(rem) + _distinct(quo)) * row_bytes + n * D * 4
    return nbytes, n * D * ops_per_elem


def _bag_bound(idx, mask, m, d, elem):
    """K3 as ``ops.qr_bag_lookup`` calls it: the raw ids and the mask once,
    each distinct live row of both tables once (``d`` elements of ``elem``
    bytes), the pooled output once; combine, weight and add per element of
    a live slot."""
    live = mask != 0
    rows = _distinct(idx % m, live) + _distinct(idx // m, live)
    nbytes = idx.numel() * idx.element_size() + mask.numel() * mask.element_size() \
        + rows * d * elem + idx.shape[0] * d * elem
    return nbytes, int(live.sum()) * d * 3


def _grouped_bound(idx, tables, mask=None, row_bytes=D + 3, ops_per_elem=None):
    """A grouped kernel over QR pairs: the per-table bounds summed — raw ids
    and mask once, each distinct live row of each table once at
    ``row_bytes`` (D + 3 for an int8 row with its scale and zero point),
    the f32 output once — and the f32 operations per element of a live
    slot (default: dequant x 2 tables and combine for K5, and weight and
    add for K4)."""
    ops_per_elem = ops_per_elem or (5 if mask is None else 7)
    nbytes = idx.numel() * 4 * (1 if mask is None else 2) + idx.shape[0] * len(tables) * D * 4
    ops = 0
    for t, tab in enumerate(tables):
        ids = idx[:, t]
        live = (ids >= 0) if mask is None else mask[:, t] > 0
        nbytes += (_distinct(ids % tab.m, live) + _distinct(ids // tab.m, live)) * row_bytes
        ops += int(live.sum()) * D * ops_per_elem
    return nbytes, ops


def _plan_wave_bound(idx, mask, group):
    """Grouped K4 at a planned wave: raw ids and mask once; each distinct
    live row of each table once (d + 3 bytes for an int8 row with its scale
    and zero point, 4·d for f32); each projection once; the f32 output
    once.  Operations per element of a live slot: dequant (2) per table,
    the combine of a pair, weight and add; and 2·d·D per bag for a
    projection."""
    d_out = max(tab.w_a.shape[1] if tab.proj is None else tab.proj.shape[1] for tab in group)
    nbytes = idx.numel() * 4 * 2 + idx.shape[0] * len(group) * d_out * 4
    ops = 0
    for t, tab in enumerate(group):
        ids, live = idx[:, t], mask[:, t] > 0
        d = tab.w_a.shape[1]
        row = d + 3 if tab.scale_a is not None else d * tab.w_a.element_size()
        if tab.w_b is not None:
            rows = _distinct(ids % tab.m, live) + _distinct(ids // tab.m, live)
        else:
            rows = _distinct(ids % tab.m if tab.m else ids, live)
        nbytes += rows * row
        per_elem = (2 + 2 + 1 if tab.w_b is not None else 2) + 2
        ops += int(live.sum()) * d * per_elem
        if tab.proj is not None:
            nbytes += tab.proj.numel() * 4
            ops += idx.shape[0] * d * d_out * 2
    return nbytes, ops


def time_plan_wave(torch, wave):
    """Grouped K4 at the planned wave: device ms at the launcher's threads
    per bag, plain version, bound, and host enqueue µs."""
    from repro_torch.kernels import grouped_lookup, ref, serve_path

    idx, mask, group = wave
    nbytes, ops = _plan_wave_bound(idx, mask, group)
    bound_ms, bound_by = _bound(nbytes, ops)
    pairs = sum(tab.w_b is not None for tab in group)
    out = {"shape": f"grouped, the planned model's wave: {len(group)} int8 tables ({pairs} QR "
                    f"pairs) at widths {sorted({tab.w_a.shape[1] for tab in group})}, "
                    f"{sum(tab.proj is not None for tab in group)} projections to D={D}, "
                    f"B={idx.shape[0]} L={idx.shape[2]}",
           "ms": _time_ms(torch, lambda: serve_path.fused_serve_pool_grouped(idx, mask, group),
                          200),
           "threads_per_bag": grouped_lookup.THREADS_PER_BAG,
           "plain_ms": _time_ms(torch, lambda: ref.fused_serve_pool_grouped(idx, mask, group),
                                20),
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
           "bound_operations": ops,
           "host_us": _host_us(torch, lambda: serve_path.fused_serve_pool_grouped(
               idx, mask, group), 200)}
    print(f"  grouped K4 at the planned wave: {out['ms']:.6f} ms, bound {bound_ms:.7f} ms "
          f"({bound_by}, {nbytes} B), plain {out['plain_ms']:.6f} ms; host {out['host_us']:.1f} "
          "us per call")
    return out


def _host_us(torch, fn, iters: int) -> float:
    """Host time to enqueue one ``fn()`` call, in µs: ``iters`` calls back to
    back on the host clock, one synchronise at the end."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e6


def time_grouped(torch, grouped_inputs, errs):
    """The grouped kernels at a full 26-table wave (K4, B=256, L=4) and
    batch (K5 over int8 pairs, K1 over f32 pairs, B=256): device ms at 1,
    2, 4, 8 and 16 threads per (bag, table), the route each replaces on the
    same inputs (26 x (id split [+ mask copy] + per-table launch),
    stacked), host enqueue µs of both routes, the plain version and the
    bound.  Returns the fields of the K4, K5 and K1 entries."""
    from repro_torch.kernels import grouped_lookup, qr_gather, ref, serve_path

    idx, mask, tables, sparse, dense = grouped_inputs
    n_tables = len(tables)

    def k4():
        return serve_path.fused_serve_pool_grouped(idx, mask, tables)

    def k4_replaced():
        return torch.stack([serve_path.fused_serve_pool(
            idx[:, t] % tab.m, mask[:, t].contiguous(), tab.w_a, idx[:, t] // tab.m, tab.w_b,
            tab.scale_a, tab.zp_a, tab.scale_b, tab.zp_b) for t, tab in enumerate(tables)], dim=1)

    def k5():
        return qr_gather.qr_gather_quant_grouped(sparse, tables)

    def k5_replaced():
        return torch.stack([qr_gather.qr_gather_quant(
            sparse[:, t] % tab.m, sparse[:, t] // tab.m, tab.w_a, tab.w_b, tab.scale_a, tab.zp_a,
            tab.scale_b, tab.zp_b) for t, tab in enumerate(tables)], dim=1)

    def k1():
        return qr_gather.qr_gather_grouped(sparse, dense)

    def k1_replaced():
        return torch.stack([qr_gather.qr_gather(
            sparse[:, t] % tab.m, sparse[:, t] // tab.m, tab.w_a, tab.w_b)
            for t, tab in enumerate(dense)], dim=1)

    fields = {}
    for name, key, fn, replaced, plain, bound, pairs in (
            ("fused_serve_pool", "k4", k4, k4_replaced,
             lambda: ref.fused_serve_pool_grouped(idx, mask, tables),
             _grouped_bound(idx, tables, mask), "int8"),
            ("qr_gather_quant", "k5", k5, k5_replaced,
             lambda: ref.qr_gather_quant_grouped(sparse, tables),
             _grouped_bound(sparse, tables), "int8"),
            ("qr_gather", "k1", k1, k1_replaced, lambda: ref.qr_gather_grouped(sparse, dense),
             _grouped_bound(sparse, dense, row_bytes=D * 4, ops_per_elem=1), "f32")):
        kept = grouped_lookup.THREADS_PER_BAG
        want = fn()
        by_tpb = {}
        for tpb in (1, 2, 4, 8, 16):
            grouped_lookup.THREADS_PER_BAG = tpb
            if not torch.equal(fn(), want):
                _fail(f"grouped {name}: {tpb} threads per bag change the result")
            by_tpb[tpb] = _time_ms(torch, fn, 200)
        grouped_lookup.THREADS_PER_BAG = kept
        bound_ms, bound_by = _bound(*bound)
        fields[name] = {
            "shape": (f"{pairs} QR pairs (c=4) of the {n_tables} Kaggle tables, B={B}"
                      + (f" L={L}" if key == "k4" else "") + f" D={D}, Zipf ids"),
            "ms": by_tpb[kept], "threads_per_bag": kept,
            "ms_by_threads_per_bag": by_tpb, "plain_ms": _time_ms(torch, plain, 20),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": bound[0],
            "bound_operations": bound[1],
            "replaced_route_ms": _time_ms(torch, replaced, 6),
            "host_us": _host_us(torch, fn, 200),
            "replaced_route_host_us": _host_us(torch, replaced, 20),
            "max_abs_err": errs[key], "max_abs_diff_vs_per_table": errs[f"{key}_vs_per_table"]}
        g = fields[name]
        print(f"  grouped {name}: {g['ms']:.6f} ms ({kept} thread(s) per bag; by threads per "
              f"bag {by_tpb}), bound {bound_ms:.7f} ms ({bound[0]} B), plain "
              f"{g['plain_ms']:.6f} ms, replaced route {g['replaced_route_ms']:.6f} ms; host "
              f"{g['host_us']:.1f} us vs {g['replaced_route_host_us']:.1f} us per call")
    return fields


def time_interaction(torch, k2_inputs):
    """K2 as the model calls it — z (B, D) and the features (B, 26, D) in,
    the top MLP's input out — at 1, 2, 4 and 8 examples per block, beside
    the route it replaces (cat + K2 on the stacked x + cat), the stacked
    ``dot_interaction(x)``, and both routes' host enqueue µs per call."""
    from repro_torch.kernels import dot_interaction

    x, z, feats = k2_inputs

    def k2():
        return dot_interaction.dot_interaction_concat(z, feats)

    def replaced():
        stacked = torch.cat([z[:, None], feats], dim=1)
        return torch.cat([z, dot_interaction.dot_interaction(stacked)], dim=-1)

    kept = dot_interaction.EXAMPLES_PER_BLOCK
    want = k2()
    if not torch.equal(replaced(), want):
        _fail("K2: the replaced route (cat + K2 + cat) differs from dot_interaction_concat")
    by_e = {}
    for e in (1, 2, 4, 8):
        dot_interaction.EXAMPLES_PER_BLOCK = e
        if not torch.equal(k2(), want):
            _fail(f"K2: {e} examples per block change the result")
        by_e[e] = _time_ms(torch, k2, 200)
    dot_interaction.EXAMPLES_PER_BLOCK = kept
    out = {"ms": by_e[kept], "examples_per_block": kept, "ms_by_examples_per_block": by_e,
           "ms_stacked_x": _time_ms(torch, lambda: dot_interaction.dot_interaction(x), 200),
           "replaced_route_ms": _time_ms(torch, replaced, 100),
           "host_us": _host_us(torch, k2, 200),
           "replaced_route_host_us": _host_us(torch, replaced, 200)}
    print(f"  dot_interaction_concat: {out['ms']:.6f} ms ({kept} example(s) per block; by "
          f"examples per block {by_e}), stacked dot_interaction(x) {out['ms_stacked_x']:.6f} ms, "
          f"replaced route {out['replaced_route_ms']:.6f} ms; host {out['host_us']:.1f} us vs "
          f"{out['replaced_route_host_us']:.1f} us per call")
    return out


def time_bag(torch, shapes):
    """K3 at its three shapes through ``ops.qr_bag_lookup`` (raw ids, one
    launch): device ms, the pre-split per-table entry, the plain version,
    the bound from these inputs and its share, the yardstick (two
    ``F.embedding_bag(mode="sum", per_sample_weights=)`` + add, at op=add),
    host µs and device operations per call; and the sweep of threads per
    bag (8, 16, 32) at the bandwidth and bench shapes.  Returns the fields
    by case."""
    import torch.nn.functional as tf

    from repro_torch.kernels import embedding_bag, grouped_lookup, ops, ref

    fields = {}
    for shape, kind, op in BAG_CASES:
        idx, mask, wr, wq, m = _bag_case(shapes, shape, kind)
        rem, quo = idx % m, idx // m
        weights = mask.to(wr.dtype)
        iters = 50 if shape == "bandwidth" else 200

        def k3(idx=idx, mask=mask, wr=wr, wq=wq, op=op):
            return ops.qr_bag_lookup(idx, mask, wr, wq, op=op)

        nbytes, n_ops = _bag_bound(idx, mask, m, wr.shape[1], wr.element_size())
        bound_ms, bound_by = _bound(nbytes, n_ops)
        f = {"shape": f"{kind} B={idx.shape[0]} L={idx.shape[1]} m={m} q={wq.shape[0]} "
                      f"D={wr.shape[1]} {op}",
             "ms": _time_ms(torch, k3, iters),
             "per_table_ms": _time_ms(torch, lambda: embedding_bag.qr_embedding_bag(
                 rem, quo, mask, wr, wq, op=op), iters),
             "plain_ms": _time_ms(torch, lambda: ref.qr_embedding_bag(rem, quo, mask, wr, wq,
                                                                      op=op), 20),
             "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
             "bound_operations": n_ops,
             "yardstick_ms": None if op != "add" else _time_ms(torch, lambda: (
                 tf.embedding_bag(rem, wr, mode="sum", per_sample_weights=weights)
                 + tf.embedding_bag(quo, wq, mode="sum", per_sample_weights=weights)), iters),
             "host_us": _host_us(torch, k3, 200),
             "device_ops_per_call": _device_ops_per_call(torch, k3)["ops"]}
        f["share_of_bound"] = bound_ms / f["ms"]
        fields[f"{shape} {kind} {op}"] = f
        print(f"  K3 {shape} {f['shape']}: {f['ms']:.6f} ms, bound {bound_ms:.7f} ms "
              f"({nbytes} B; {f['share_of_bound']:.3f} of it), per-table entry "
              f"{f['per_table_ms']:.6f}, plain {f['plain_ms']:.6f}, yardstick "
              f"{f['yardstick_ms']} ms; host {f['host_us']:.1f} us, "
              f"{f['device_ops_per_call']} device operations per call")

    kept = grouped_lookup.WIDE_THREADS_PER_BAG
    for shape in ("bandwidth", "bench"):
        idx, mask, wr, wq, _ = _bag_case(shapes, shape, "f32")
        sweep = {}
        for tpb in (8, 16, 32):
            grouped_lookup.WIDE_THREADS_PER_BAG = tpb
            sweep[tpb] = _time_ms(torch, lambda: ops.qr_bag_lookup(idx, mask, wr, wq, op="add"),
                                  50 if shape == "bandwidth" else 200)
        grouped_lookup.WIDE_THREADS_PER_BAG = kept
        fields[f"{shape} f32 add"]["ms_by_threads_per_bag"] = sweep
        print(f"  K3 {shape} f32 add by threads per bag (kept {kept}): {sweep}")
    return fields


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure(torch, gen, k4_inputs, k2_inputs, k2_fields, qr_inputs, grouped_inputs, bag,
            counts, errs, grouped):
    """The ``kernels`` JSON entries: each kernel's time on the card at the
    main path's shapes (the grouped launch for K1, K4 and K5; K2 as the
    model calls it), its plain version's, its bound from these inputs, a
    PyTorch yardstick, and its launches on every path; the per-table
    entries and the kernel bench's shapes beside them."""
    import torch.nn.functional as tf

    from repro_torch.kernels import dot_interaction, qr_gather, ref, serve_path

    # per-table K4 on one int8 pair of the largest table; a dense f32 table,
    # where one PyTorch call (F.embedding_bag) computes the same function
    rem, quo, mask, qa, qb, w_rem = k4_inputs
    k4_args = (rem, mask, qa["q"], quo, qb["q"], qa["scale"], qa["zp"], qb["scale"], qb["zp"])
    k4_per_table = {"shape": f"per-table entry, int8 QR pair B={B} L={L} D={D}",
                    "ms": _time_ms(torch, lambda: serve_path.fused_serve_pool(*k4_args), 200),
                    "plain_ms": _time_ms(torch, lambda: ref.fused_serve_pool(*k4_args), 20),
                    "bound_ms": _bound(*_k4_bound(rem, quo, mask))[0],
                    "ms_single_f32_table": _time_ms(
                        torch, lambda: serve_path.fused_serve_pool(rem, mask, w_rem), 200),
                    "embedding_bag_ms_single_f32_table": _time_ms(
                        torch, lambda: tf.embedding_bag(rem, w_rem, mode="sum",
                                                        per_sample_weights=mask), 100)}

    # K2 as the model calls it: z and the 26 features in, the top MLP's input out
    x, z, feats = k2_inputs
    i, j = torch.tril_indices(F, F, offset=-1, device="cuda")
    pairs = F * (F - 1) // 2
    k2_bytes = (z.numel() + feats.numel() + B * (D + pairs)) * 4
    k2_ops = B * pairs * 2 * D
    k2_extra = {
        "shape": f"f32 z (B, D) and feats (B, {F - 1}, D) -> top_in (B, D + {pairs}), "
                 f"B={B} F={F} D={D}",
        "yardstick": "torch.cat + torch.bmm + triangle index + torch.cat (four calls)",
        "yardstick_ms": _time_ms(torch, lambda: torch.cat(
            [z, torch.bmm(xx := torch.cat([z[:, None], feats], 1), xx.transpose(1, 2))[:, i, j]],
            -1), 100),
        "stacked_x": {"ms": k2_fields["ms_stacked_x"],
                      "plain_ms": _time_ms(torch, lambda: ref.dot_interaction(x), 100),
                      "bmm_and_index_ms": _time_ms(
                          torch, lambda: torch.bmm(x, x.transpose(1, 2))[:, i, j], 100)},
        **{k: v for k, v in k2_fields.items() if k != "ms"}}

    # K1 and K5 per-table entries on the largest Kaggle table, N=256 Zipf ids
    _, g_rem, g_quo, gw_rem, gw_quo, quant_args = qr_inputs
    k1_args = (g_rem, g_quo, gw_rem, gw_quo)
    k1_per_table = {
        "shape": f"per-table entry, f32 QR pair of the {BIG_TABLE}-row table (c=4) D={D} "
                 f"N={B} Zipf ids",
        "ms": _time_ms(torch, lambda: qr_gather.qr_gather(*k1_args), 200),
        "plain_ms": _time_ms(torch, lambda: ref.qr_gather(*k1_args), 20),
        "bound_ms": _bound(*_gather_bound(g_rem, g_quo, D * 4, 1))[0],
        "yardstick_ms": _time_ms(torch, lambda: tf.embedding(g_rem, gw_rem)
                                 * tf.embedding(g_quo, gw_quo), 200)}
    # ... and at the reference kernel bench's shape (m=2048, q=16, D=128, N=512,
    # int32 ids as jax.random.randint draws them), and on int64 ids
    # (PyTorch's default, read in place, beside a cast to int32 and a launch
    # on those)
    bm, bq, bd = 2048, 16, 128
    b_ids = torch.randint(0, bm * bq, (512,), generator=gen, device="cuda", dtype=torch.int32)
    b_args = (b_ids % bm, b_ids // bm, torch.randn((bm, bd), generator=gen, device="cuda"),
              torch.randn((bq, bd), generator=gen, device="cuda"))
    b_long = (b_args[0].long(), b_args[1].long(), *b_args[2:])
    if not torch.equal(qr_gather.qr_gather(*b_long), qr_gather.qr_gather(*b_args)):
        _fail("K1 bench: int64 ids give other bits than int32 ids")
    b_n = b_ids.numel()
    b_bytes = 2 * b_n * 4 + (_distinct(b_args[0]) + _distinct(b_args[1])) * bd * 4 + b_n * bd * 4
    k1_bench = {"shape": "per-table entry, f32 m=2048 q=16 D=128 N=512 uniform int32 ids "
                         "(kernels_bench)",
                "ms": _time_ms(torch, lambda: qr_gather.qr_gather(*b_args), 200),
                "plain_ms": _time_ms(torch, lambda: ref.qr_gather(*b_args), 20),
                "bound_ms": _bound(b_bytes, b_n * bd)[0],
                "yardstick_ms": _time_ms(torch, lambda: tf.embedding(b_args[0], b_args[2])
                                         * tf.embedding(b_args[1], b_args[3]), 200),
                "ms_int64_ids": _time_ms(torch, lambda: qr_gather.qr_gather(*b_long), 200),
                "ms_cast_then_int32_launch": _time_ms(torch, lambda: qr_gather.qr_gather(
                    b_long[0].to(torch.int32), b_long[1].to(torch.int32), *b_args[2:]), 200)}
    print(f"  K1 per-table bench: {k1_bench['ms']:.6f} ms (plain {k1_bench['plain_ms']:.6f}, "
          f"two F.embedding + multiply {k1_bench['yardstick_ms']:.6f}); int64 ids in place "
          f"{k1_bench['ms_int64_ids']:.6f}; cast to int32 + launch "
          f"{k1_bench['ms_cast_then_int32_launch']:.6f}")

    q_rem, q_quo, q_ra, q_qa, s_ra, z_ra, s_qa, z_qa = quant_args

    def rows(ids, q, scale, zp):
        return (tf.embedding(ids, q).float() - tf.embedding(ids, zp).float()) \
            * tf.embedding(ids, scale).float()

    k5_per_table = {
        "shape": f"per-table entry, int8 QR pair of the {BIG_TABLE}-row table (c=4) D={D} "
                 f"N={B} Zipf ids",
        "ms": _time_ms(torch, lambda: qr_gather.qr_gather_quant(*quant_args), 200),
        "plain_ms": _time_ms(torch, lambda: ref.qr_gather_quant(*quant_args), 20),
        "bound_ms": _bound(*_gather_bound(q_rem, q_quo, D + 3, 5))[0],
        "yardstick_ms": _time_ms(torch, lambda: rows(q_rem, q_ra, s_ra, z_ra)
                                 * rows(q_quo, q_qa, s_qa, z_qa), 50)}

    # the grouped yardsticks: the library route per table on pre-split ids, stacked
    _, _, tables, sparse, dense = grouped_inputs
    split = [(sparse[:, t] % tab.m, sparse[:, t] // tab.m) for t, tab in enumerate(tables)]
    k1_yard = _time_ms(torch, lambda: torch.stack(
        [tf.embedding(r, tab.w_a) * tf.embedding(q, tab.w_b)
         for (r, q), tab in zip(split, dense)], dim=1), 50)
    k5_yard = _time_ms(torch, lambda: torch.stack(
        [rows(r, tab.w_a, tab.scale_a, tab.zp_a) * rows(q, tab.w_b, tab.scale_b, tab.zp_b)
         for (r, q), tab in zip(split, tables)], dim=1), 20)

    k3 = bag["serving f32 add"]

    def entry(name, source, replaces, ms, plain_ms, bound_ms, bound_by, extra):
        by_path = {path: c[name] for path, c in counts.items() if c[name]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "max_abs_err": errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "launches_by_path": by_path, **extra}

    def grouped_entry(name, replaces, yardstick, yard_ms, per_table, extra=None):
        g = grouped[name]
        return entry(name, "src/repro_torch/csrc/grouped_lookup.cu", replaces, g["ms"],
                     g["plain_ms"], g["bound_ms"], g["bound_by"],
                     {"shape": f"grouped, {g['shape']}", "yardstick": yardstick,
                      "yardstick_ms": yard_ms, "grouped": g, "per_table": per_table,
                      **(extra or {})})

    return [
        grouped_entry("fused_serve_pool", "src/repro/kernels/serve_path.py:191",
                      "no single call for an int8 pair; F.embedding_bag(mode='sum', "
                      "per_sample_weights=) on one dense f32 table, beside the per-table entry "
                      "on it (per_table)", None, k4_per_table),
        entry("dot_interaction", "src/repro_torch/csrc/dot_interaction.cu",
              "src/repro/kernels/dot_interaction.py:52", k2_fields["ms"],
              _time_ms(torch, lambda: ref.dot_interaction_concat(z, feats), 100),
              *_bound(k2_bytes, k2_ops), k2_extra),
        grouped_entry("qr_gather", "src/repro/kernels/qr_gather.py:72",
                      "no single call: per table two F.embedding calls + the multiply, stacked",
                      k1_yard, k1_per_table, {"bench_shape": k1_bench}),
        grouped_entry("qr_gather_quant", "src/repro/kernels/qr_gather.py:132",
                      "no single call: per table six F.embedding calls (q, scale, zp of each "
                      "table) + dequant + multiply, stacked", k5_yard, k5_per_table),
        entry("qr_embedding_bag", "src/repro_torch/csrc/grouped_lookup.cu",
              "src/repro/kernels/embedding_bag.py:78", k3["ms"], k3["plain_ms"], k3["bound_ms"],
              k3["bound_by"],
              {"shape": f"ops.qr_bag_lookup (raw ids, one launch), f32 QR pair of the "
                        f"{BIG_TABLE}-row table (c=4) B={B} L={L} D={D} add, fractional weights",
               "yardstick": "no single call for a pair: two F.embedding_bag(mode='sum', "
                            "per_sample_weights=) calls + an add",
               "yardstick_ms": k3["yardstick_ms"], "serving_shape": k3,
               "bench_shape": bag["bench f32 mult"], "bench_shape_add": bag["bench f32 add"],
               "bandwidth_shape": bag["bandwidth f32 add"],
               "bandwidth_shape_mult": bag["bandwidth f32 mult"],
               "by_case": {k: v for k, v in bag.items() if not k.startswith(
                   ("bench f32", "bandwidth f32", "serving f32 add"))}}),
    ]


# past this many seconds every thread's stack goes to stderr, so a smoke
# stopped at its time limit shows where it was
STACK_DUMP_S = 1100


def main() -> int:
    import faulthandler

    faulthandler.dump_traceback_later(STACK_DUMP_S)
    try:
        return _main()
    finally:
        faulthandler.cancel_dump_traceback_later()
        BACKGROUND.stop()


def _main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = _card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t0 = t = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} kernel sources in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        _print_registers(name, log)

    gen = torch.Generator(device="cuda").manual_seed(0)
    print("[K4] fused_serve_pool vs plain")
    k4_err, k4_inputs = check_serve_pool(torch, gen)
    print("[K2] dot_interaction vs plain")
    k2_err, k2_inputs = check_interaction(torch, gen)
    print("[K1/K5] qr_gather and qr_gather_quant vs plain")
    k1_err, k5_err, qr_inputs = check_qr_gather(torch, gen)
    print("[grouped] grouped K4, K5 and K1 over the 26 Kaggle tables vs plain and per-table")
    grouped_errs, grouped_inputs = check_grouped(torch, gen)
    print("[K3] qr_embedding_bag vs plain at three shapes, and the f32-accumulation audit")
    shapes = bag_shapes(torch, gen)
    k3_err = check_embedding_bag(torch, shapes)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[serve] full-width DLRM-Criteo, int8 QR tables")
    counts = {}
    counts["serve"], engine, reqs = serve_full_width(torch)
    print("[profile] where a full wave's time goes")
    profile_waves(torch, engine, reqs[:1024])
    print("[cache] the hot-row cache's paths at full width, on the reduced config, "
          "after swap_plan and for the DCN")
    counts["cache"] = cache_paths(torch, engine, reqs, card)
    print("[eval] full-width one-hot DLRM-Criteo, 12 held-out batches of 256")
    counts.update(eval_full_width(torch))
    print("[K6] qr_pairs_backward vs plain at the training cell's shape")
    k6 = check_qr_pairs_backward(torch, gen)
    counts["k6"] = k6.pop("counts")
    print("[train] full-width DLRM-Criteo, Adagrad, then the trained tables through the kernels")
    counts.update(train_full_width(torch, card))
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[bag] ops.qr_bag_lookup, K3's own entry point")
    counts["bag"], bag_ops = drive_bag_path(torch, shapes)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[plan] full-width DLRM-Criteo solved under a byte budget over widths {4, 8, 16}: "
          "served, scored, trained, swapped in")
    counts["plan"], plan_err, plan_wave, planned = plan_full_width(torch, engine, reqs, card)
    del engine
    os.makedirs(SERVE_DIST_DIR, exist_ok=True)
    planned[0].save(os.path.join(SERVE_DIST_DIR, "plan.json"))   # [serve_dist] serves it
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[online] the planned model served with observability on, through drift, the "
          "controller, migration and hot-swap; the migrated model scored and trained")
    counts["online"] = online_full_width(torch, planned, reqs, card)
    del planned
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    # started here, read where their phases print: [sweep] and [paper] in a
    # process of their own, the launchers of [dist], [serve_dist] and [lm],
    # [analysis]'s injected run and the dry run's cells
    _rows_start()
    _dist_launcher_start()
    _serve_dist_launcher_start()
    _analysis_injected_start()
    _lm_launchers_start()
    _dryrun_start()
    print("[dist] full-width data-parallel step with compressed gradient exchange: NCCL world "
          "of one, gloo world of 4 on the card, Trainer(step_wire=), the launcher")
    counts["dist"] = dist_full_width(torch, card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[fsdp] full-width FSDP step with sharded optimizer state: NCCL world of one, gloo "
          "world of 4 on the card, checkpoint restart and elastic restore")
    counts["fsdp"] = fsdp_full_width(torch, card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[serve_dist] full-width int8 and planned DLRM-Criteo served from row-sharded tables "
          "over an all-to-all row exchange: gloo world of 4 on the card, the launcher")
    counts["serve_dist"] = serve_dist_full_width(torch, card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[analysis] the port's static analyzer on the card: ten passes, ACC-002 over the "
          "five kernels, WIRE-001 in a gloo world of 4, INJ-001 on the full-width plan; "
          "JIT-002 on the full-width engine")
    counts["analysis"], counts["analysis_jit"] = analysis_full_width(torch, card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    t = time.perf_counter()
    BACKGROUND.settle(600)    # the phases from [lm] on run alone
    print(f"  (the work started with [dist] settled {time.perf_counter() - t:.1f} s after "
          f"[analysis])")
    print("[lm] full-width TinyLlama-1.1B served through ServeEngine with its QR vocabulary "
          "through K1: against the plain route and teacher forcing, an 8,192-token prompt, f32 "
          "card vs CPU, 10 Adam steps through Trainer, the launchers")
    lm_counts, lm_k1, lm_err = lm_full_width(torch, card)
    counts.update(lm_counts)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[moe] full-width DeepSeek-V2 (MLA + 160-expert MoE), 4 of 60 layers, served through "
          "ServeEngine with its QR vocabulary through K1: against the plain route and teacher "
          "forcing (routes compared), an 8,192-token prompt, f32 card vs CPU at 1 layer, 10 "
          "Adafactor steps at 2 layers; Arctic's wave at 1 layer")
    moe_counts, moe_k1, moe_err = moe_full_width(torch, card)
    counts.update(moe_counts)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[ssm] the SSM family at full width: mamba2-370m and zamba2-1.2b served through "
          "ServeEngine with their QR vocabularies through K1, against the plain route and "
          "teacher forcing, the caches, f32 card vs CPU, an 8,192-token prompt, training through "
          "Trainer, the prefill state vs token-by-token decoding, the launchers; one wave of "
          "qwen3-14b (qk_norm)")
    ssm_counts, ssm_k1, ssm_err = ssm_full_width(torch, card)
    counts.update(ssm_counts)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[encdec] full-width seamless-m4t-large-v2 (encoder-decoder, stub audio frames) served "
          "through ServeEngine with its 256,206-token QR vocabulary through K1: against the "
          "plain route and teacher forcing, f32 card vs CPU at 2 + 2 layers, 10 Adam steps "
          "through Trainer")
    mm_counts, encdec_k1, encdec_err = mm_full_width(torch, card, "encdec")
    counts.update(mm_counts)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[vlm] llava-next-34b at full width, 28 of 60 layers, 1,152 stub patches per request "
          "before the text, served through ServeEngine with the text's QR vocabulary through "
          "K1: against the plain route and teacher forcing, f32 card vs CPU at 1 layer, 10 "
          "Adafactor steps at 2 layers")
    mm_counts, vlm_k1, vlm_err = mm_full_width(torch, card, "vlm")
    counts.update(mm_counts)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[granite] full-width granite-8b served through ServeEngine with its 49,152-token QR "
          "vocabulary through K1: against the plain route and teacher forcing, f32 card vs CPU "
          f"at 2 layers, {GRANITE_TRAIN_STEPS} Adam steps through Trainer at "
          f"{GRANITE_TRAIN_LAYERS} of 36 layers")
    counts["granite"], granite_k1, granite_err = granite_full_width(torch, card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[mesh] full-width int8 DLRM-Criteo served by RecsysEngine(mesh=) on a (1, 1) NCCL "
          "mesh, against the unmeshed engine, without a cache and through each hot-row cache")
    counts["mesh"] = mesh_full_width(torch, card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[dryrun] the dry run of one cell per family at full width on pod_32x8, and its "
          "roofline at the H100 constants")
    dryrun_cells(card)
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    counts["paper"] = rows_read()
    print(f"  ({time.perf_counter() - t0:.0f} s so far)")
    print("[time] CUDA events")
    print(f"  card: {card}")
    errs = {"fused_serve_pool": max(k4_err, grouped_errs["k4"], plan_err),
            "dot_interaction": k2_err,
            "qr_gather": max(k1_err, grouped_errs["k1"], lm_err, moe_err, ssm_err, encdec_err,
                             vlm_err, granite_err),
            "qr_gather_quant": max(k5_err, grouped_errs["k5"]), "qr_embedding_bag": k3_err}
    grouped = time_grouped(torch, grouped_inputs, grouped_errs)
    k2_fields = time_interaction(torch, k2_inputs)
    bag = time_bag(torch, shapes)
    kernels = measure(torch, gen, k4_inputs, k2_inputs, k2_fields, qr_inputs, grouped_inputs,
                      bag, counts, errs, grouped)
    kernels[-1]["ops_qr_bag_lookup_device_ops_per_call"] = bag_ops
    kernels[0]["plan_wave"] = time_plan_wave(torch, plan_wave)
    lm_shapes = time_lm_k1(torch, lm_k1, "TinyLlama", "lm",
                           counts["lm"]["qr_gather"] + counts["lm_trained"]["qr_gather"])
    lm_shapes.update(time_lm_k1(torch, moe_k1, "DeepSeek-V2", "deepseek",
                                counts["moe"]["qr_gather"]))
    lm_shapes.update(time_lm_k1(torch, ssm_k1["mamba"], "Mamba2", "mamba",
                                counts["ssm_mamba"]["qr_gather"]))
    lm_shapes.update(time_lm_k1(torch, ssm_k1["qwen3"], "Qwen3", "qwen3",
                                counts["ssm_qwen3"]["qr_gather"]))
    lm_shapes.update(time_lm_k1(torch, encdec_k1, "seamless-m4t", "seamless",
                                counts["encdec"]["qr_gather"]))
    lm_shapes.update(time_lm_k1(torch, vlm_k1, "llava-next", "llava", counts["vlm"]["qr_gather"]))
    lm_shapes.update(time_lm_k1(torch, granite_k1, "granite", "granite",
                                counts["granite"]["qr_gather"]))
    next(k for k in kernels if k["name"] == "qr_gather")["lm_shapes"] = lm_shapes
    by_path = {path: c["qr_pairs_backward"] for path, c in counts.items()
               if c.get("qr_pairs_backward")}
    kernels.append({"name": "qr_pairs_backward", "route": "cuda",
                    "source": "src/repro_torch/csrc/qr_pairs_backward.cu",
                    "replaces": "none: the backward of K1's function (the TPU kernel has none)",
                    "launches": sum(by_path.values()), "library_ms": None,
                    "launches_by_path": by_path, **k6})
    for k in kernels:
        if k["launches"] == 0:
            _fail(f"{k['name']} was launched on no path")
    print(f"  card: {card}; {time.perf_counter() - t0:.0f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
