"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

What it does, in order (any failed check raises, so the exit code is
non-zero and the final result line is never printed):

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Holds each of the six kernels — ``rev_heun_phase1`` and
   ``rev_heun_phase1_gen`` (sign ±1), ``rev_heun_phase2``,
   ``rev_heun_bwd_phase1``, ``rev_heun_bwd_phase2``,
   ``brownian_increment`` — against its plain PyTorch version on the card,
   in float32 and float64, at KERNEL_SHAPES (d in {1, 3, 16, 17}, B in {1,
   64, 1024}, the training path's one-key draws, 1 row of B·17, and the
   SDE-GAN's, 1 row of B·4): bitwise (max |Δ| must be 0); and the four
   one-pass kernels, ``rev_heun_phase1`` (both signs), ``rev_heun_phase2``,
   ``rev_heun_bwd_phase1`` and ``rev_heun_bwd_phase2``, on contiguous views
   1, 2 and 3 elements into a flat buffer (off a 16-byte boundary), bitwise
   the contiguous copies' result and the plain version's.
   Times each with CUDA events beside the plain version at the shapes the
   main paths give it: the training state (B in {64, 1024}, d = 17) and
   the serving bucket (B = 1024, d = 16).  Then the card's launch floor:
   an empty kernel (``torch.cuda._sleep(0)``) timed back to back the same
   way.  Then a CUDA graph of ``fused_mlp`` → ``rev_heun_phase2`` →
   ``brownian_increment`` → ``space_time_increment`` →
   ``rev_heun_phase1_gen`` → ``rev_heun_phase1`` (sign −1) →
   ``rev_heun_bwd_phase1`` → ``rev_heun_bwd_phase2`` (the last seven
   launched as programmatic dependent launches, each reading an earlier
   stage's output) captured, replayed bitwise the eager calls, and
   its programmatic edges counted: whether capture kept the dependent
   launches.
3b. (Run right after 3.)  ``fused_mlp`` (every depth-1 SDE field: Linear
   → LipSwish → Linear) against its plain version in float32 (2e-5),
   bfloat16 (6e-2) and float64 (1e-12) at every field shape of the ELBO,
   the SDE-GAN generator and discriminator (xi 2 → 32 → 16, g 17 → 32 →
   32) and the adaptive burst, 96 → 48 → 24 and a 512-wide MLP
   (MLP_SHAPES), at 1, 300 and 1024 rows; at every width two launches
   alike and rows invariant bitwise (1 vs 1000 vs 1024); timed at
   MLP_TIMED (the training batches, the 1024-row decode bucket's 17 → 32
   → 16, nu, the SDE-GAN sigma, the discriminator's g, the burst) beside
   the plain version, the layer loop the fields ran before (1024-row
   blocks) and the bound.  Its backward kernel ``fused_mlp_bwd``
   (one thread-block cluster, products on the tensor cores) against
   ``ref.fused_mlp_bwd`` at MLP_SHAPES × rows MLP_BWD_ROWS (1 to 4096:
   several tiles a block) in the three dtypes (MLP_TOL), two launches
   bitwise, dx rows invariant, an expanded cotangent bitwise its copy, the
   library's launch plan (``fused_mlp.bwd_plan``: cluster size, tile rows
   and tiles a block printed by R) and the clusters the card can hold
   (``cudaOccupancyMaxActiveClusters``); timed at MLP_TIMED beside the
   plain VJP the node ran before, the plain version, its bound and the
   launch floor.  Then the launcher's host cost a call, piece by piece
   (``launcher_costs``).
4. Checks the in-port identities bitwise: ΔW from ``rev_heun_phase1_gen``
   = ΔW from ``brownian_increment`` = the plain ``BrownianPath.increment``,
   and the fused decode = the unfused decode.
5. Adjoint identities on the card, float64, at the training widths:
   the fused exact adjoint's ELBO gradients = the unfused ones (bitwise),
   and the exact adjoint = ``discretise`` (≤1e-12 relative).
6. Training, the slice's main path: ``train_latent_sde`` (the train CLI's
   entry point) runs 3 ELBO steps at batch 64, fused, with the launch
   counts zeroed just before and read just after — the solver kernels
   must launch exactly 161 times per step (46 forward, 115 backward: the
   reconstruction draws its ΔW in ``rev_heun_phase1_gen``, so
   ``brownian_increment`` never launches),
   ``fused_mlp`` 286 times (98 forward, 188 backward) and ``fused_mlp_bwd``
   98 times (STEP_LAUNCHES) —
   then the same 3 steps unfused: finite losses, parameters
   bitwise equal.  The fused run writes a serving bundle, which
   ``serve_sde`` restores and serves (train -> serve handshake).  Then
   the fused and the unfused step's steps/s at batch 64 and 1024, timed in
   turns, and the device idle share of one step of each under
   ``torch.profiler``; at batch 64 the device kernels of one fused step with
   the fields through ``fused_mlp`` and its backward kernel, in the
   ``PlainVJP`` node they had before (``plainvjp_mlp()``) and under
   ``plain_mlp()`` (the layer loop they ran before the kernel).
7. Memory: peak allocated bytes of one training step (the trajectory-form
   ELBO) and of one gradient of the terminal-form ELBO, at 23 and 230
   solver steps (24 observations, stride 1 and 10), exact adjoint vs
   ``discretise``: the exact adjoint's peak stays flat (within 1.5x),
   discretise's grows at least 3x as fast (and by at least 3 MiB).
8. Serves the Latent-SDE prior decode through ``serve_sde`` at the widths
   of examples/latent_sde_air_quality.py:75 (data 2, hidden 16, context 16,
   noise 8, width 32, depth 1; 23 steps on [0, 1]), fused and unfused:
   32 requests of up to 64 rows, buckets up to 1024, random weights from a
   seeded ``torch.Generator``.  The kernels' launch counts are zeroed just
   before and read just after; every serving kernel must have launched.
   Checks that the two variants agree bitwise, that a request served alone
   gets the same rows as served coalesced (padding invariance, bitwise),
   and that one bucket on the card matches the port on the CPU (float32
   tolerance below).  ``fused_mlp`` must have launched; the device kernels
   of one 1024-row decode bucket with it and under ``plain_mlp()``.
8b. ("sched serve", right after 8.)  The rest of SDE serving, float32 on
   the card at the repo's serving widths (the Latent SDE at WIDTHS with
   SEQ_LEN observations; the SDE-GAN generator at GAN_WIDTHS with 32 steps
   in 4 chunks), SCHED_SERVE's 32 requests of up to 64 rows, buckets up to
   1024, random weights from seeds: ``serve_sde`` for the posterior decode
   (fused), for ``stream_chunks=4``, and for ``scheduler="continuous"`` and
   ``"fifo"`` with ``preempt``, a ``pool_budget_mb`` and the asyncio front;
   every request's rows finite, the scheduler's rows (CUDA-graph replays)
   bitwise the stream loop's (eager chunks) in both modes; the posterior's
   rows solo == coalesced and the card against the CPU (CPU_RTOL /
   CPU_ATOL); a captured chunk and initial state bitwise the eager ones at
   buckets GRAPH_BUCKETS (1, 64, 1024), their bytes and recorded launches;
   wall, busy and idle of one 1024-row chunk replayed and eager (readings);
   an eviction under a budget that frees the evicted graph's bytes, and a
   rebuild that replays its bits; mid-flight admission and cross-lane
   preemption (with a realtime adaptive terminal batch) bitwise the solo
   runs', and the scheduler on the card against the CPU.  Counts zeroed
   before each path and read after it, graph replays counted through the
   registry: ``brownian_increment``, ``fused_mlp``, ``rev_heun_phase1_gen``,
   ``rev_heun_phase2`` and ``brownian_value`` each launched.
9. (Run right after 3b.)  ``brownian_value`` (the adaptive loop's
   Lévy-bridge point query) bitwise against its plain version: float32
   and float64, rows VALUE_ROWS × sizes VALUE_SIZES × depths VALUE_DEPTHS
   (0 to 40: one, two and more chunks of levels; row counts that leave a
   partial last block), times at t0, t1, a dyadic point and random points;
   the launcher's grid at the two path shapes (>= 128 blocks); the chain
   step's latency (depth 24 against 0 on one row); timed beside its
   throughput bound and its chain floor at the serving shape (1024 rows of
   (4,), depth 24) and the gradient shape (one key over (256, 32), depth
   10).
10. Adaptive serving: ``serve_sde("sde-gan", adaptive=True)`` at the
   SDE-GAN's serving widths (data 1, hidden 16, noise 4, initial noise 4,
   width 32, depth 1, dt0 = 1/16, atol 1e-6, budget 4096), 32 requests of
   up to 64 rows through the four deadline classes, buckets up to 1024.
   Counts zeroed before, read after: ``brownian_value`` must have launched
   exactly once per sampler call plus once per loop iteration, and
   ``fused_mlp`` at all.  Both SDE-GAN samplers must be padding-invariant
   (bucket 1 vs 1024, bitwise) and launch ``fused_mlp``.
11. The adaptive exact adjoint on the repo's adaptive workload
   (benchmarks/solver_speed.py:207: the stiffness burst plus 0.05·MLP, σ =
   0.05, batch 256, x_dim 32, rtol 2e-3, atol 1e-5, budget 2048), bridge
   depth 10 and 24: the fused gradient's launches asserted per phase
   (forward 1 + A ``brownian_value``, A of each phase; backward 2N
   ``brownian_value``, 2N ``rev_heun_phase1``, N of each other phase and
   N + 1 ``fused_mlp_bwd``, for A attempts and N accepted steps); fused ≡
   unfused bitwise; float64
   exact vs autograd through the frozen accepted grid (≤1e-12 relative);
   peak memory of both at rtol 2e-3 and 2e-4.  ``fused_mlp`` must launch;
   the device kernels of one gradient (depth 10) with it, in the
   ``PlainVJP`` node and under ``plain_mlp()``.
11b. SDE-GAN training, the main path's second half, float32 at
   ``train_sde_gan``'s widths (data 1, hidden 16, noise 4, initial noise
   4, width 32, depth 1, discriminator hidden 16 and width 32; 31 solver
   steps, 32 observations), batch 128 and 1024: 3 clip steps through
   ``train_sde_gan`` (the train CLI's entry point), one a call, each
   resuming the checkpoint the last wrote, the counts zeroed before and
   read after each: ``fused_mlp``, ``fused_mlp_bwd`` and
   ``brownian_increment`` launch GAN_STEP_LAUNCHES times (plus
   GAN_LOG_LAUNCHES for step 0's sig-MMD log), every other kernel never;
   finite metrics; every clipped layer's per-layer violation ≤ 1 after
   every step; step 3 after the resume bitwise the uninterrupted run's
   (metrics and parameters); the bundle served by ``serve_sde``.  Then the
   one-pull gradients bitwise the reference's two pulls; the gradients
   with the fields through ``fused_mlp`` against the layer loop
   (``plain_mlp()``) within MLP_TOL (atol MLP_TOL of each leaf's
   largest); the gradient penalty's create_graph gradient launching no
   ``fused_mlp_bwd``; one gp step through ``train_sde_gan``
   (GP_STEP_LAUNCHES, finite); float64 at batch 64, the exact adjoint
   against discretise for both players (≤ 1e-12 relative); the clip and
   the gp step timed in turns and one clip step profiled at both batches;
   the peak memory of a clip step at 31 and 310 solver steps (the joint
   solve keeps only its terminal state, so it should not grow with N).
11c. The paper's baselines through the train CLI's entry points, float32
   at the widths of 6 and 11b: 3 ELBO steps through ``train_latent_sde``
   (batch 64, 23 steps) for each of BASELINE_VARIANTS — midpoint with the
   continuous-adjoint backsolve, midpoint and reversible Heun with
   recursive checkpointing, and the exact adjoint fused under
   ``precision="bf16_compute"`` (the fields' ``fused_mlp`` and
   ``fused_mlp_bwd`` in bfloat16) — and 3 gp steps through
   ``train_sde_gan`` with the midpoint solver (batch 128), one a call,
   each resuming the last one's checkpoint, the counts zeroed before and
   read after each: BASELINE_STEP_LAUNCHES, STEP_LAUNCHES and
   GP_MIDPOINT_STEP_LAUNCHES (+ GP_MIDPOINT_LOG_LAUNCHES for step 0's
   log), every other kernel never; finite losses.  Then, float64 at batch
   64: checkpoint's ELBO gradients against discretise's within
   CHECKPOINT_ERR_GATE (midpoint and reversible Heun), backsolve's against
   discretise's at N = 23 and 230 (printed: the O(√h) error), and
   bf16_compute's against highest's inside BF16_SHIFT_BOUNDS (the exact
   fused adjoint and midpoint checkpointing).  The peak memory of one
   terminal-form gradient at N = 23 and 230: checkpoint within 1.5×,
   backsolve within 1.5×, discretise beside them.  One step of each
   variant timed in turns against the exact fused step (the paper's
   1.98× reads off midpoint against reversible Heun).
11d. ("levy", right after 11c.)  The srk solver and the rest of the
   Brownian layer.  The two space-time kernels — ``space_time_increment``
   (the (W, H) pair of a grid step) and ``space_time_value`` (the joint
   (W, ∫W) bridge descent) — bitwise against their plain versions at rows
   LEVY_ROWS × sizes LEVY_SIZES (and LEVY_ONE_KEY: one key over the srk
   ELBO's 64 × 17 and 1024 × 17, and over 1087),
   float32 and float64, depths LEVY_DEPTHS, at t0, t1, a dyadic and random
   times, and ``space_time_value`` at LEVY_DEEP_SIZES × LEVY_DEEP (100 and
   512 levels, past its ring of 16; a float32 descent from t0 past ~150
   levels is NaN in both, at the same places); two launches the same bits,
   a row's bits the same at 1 and 1024 rows; timed beside their bounds at the srk ELBO's and the adaptive srk
   gradient's shapes.  The srk strong-order gate of
   benchmarks/convergence.py:srk_frontier at its tiny preset (GBM μ 0.7,
   σ 0.5, 512 paths, a float64 space-time ``DenseBrownianPath`` of
   SRK_FINE 4096 cells): the slope over SRK_GRIDS in [1.4, 1.6], reversible
   Heun on the same W more accurate per NFE at the coarse end and less at
   the fine end; one ``DenseBrownianPath.sample`` at 4096 and at 256 cells
   dispatches as many aten ops with CUDA outputs (a ``TorchDispatchMode``
   count) and as many of the port's launches (``ops.launch_counts()``),
   the profiler's device kernels printed beside them as a reading.  3 srk ELBO steps through ``train_latent_sde``
   each of discretise and checkpoint (batch 64, 23 steps), counts zeroed
   before and read after each: SRK_STEP_LAUNCHES, every other kernel never;
   finite losses; one step of each in turns against the exact fused step.
   The adaptive srk gradient (checkpoint) on the burst of phase 11, float64,
   bridge depth 10 and 24: finite, its replayed value bitwise
   ``solve_adaptive``'s, the launches per phase.  The Brownian Interval
   and the host Virtual Brownian Tree on the card, float64, 100 intervals
   in the sequential, doubly sequential and random orders at size 2560:
   the card's bits are the CPU's, the cache statistics equal; then (a
   reading of the paper's Table 2, not a claim) the wall per pattern of the
   Brownian Interval and of the port's ``VirtualBrownianTree`` on the card
   at sizes 2560 and 32768.
11e. ("data parallel", right after 11d.)  Data parallelism on
   ``torch.distributed``: (a) a process group of world size 1 over NCCL on
   the card, where the flat gradient mean, the row gather and the
   broadcast are bitwise identities and ``data_parallel_mesh`` is None;
   (c) the row-windowed one-key draws of ``brownian_increment``,
   ``rev_heun_phase1_gen`` and ``space_time_increment`` bitwise their
   plain versions window by window and, concatenated, the whole launch, at
   DP_WINDOW_SHAPES in float32 and float64, and timed at rank 0's half of
   the ELBO's one key over 1024 × 17 beside the whole launch and the
   window's bound; (b) DP_RANKS gloo ranks spawned on the one card
   (``compat.launch``; they load the parent's build), global batch
   DP_BATCH: DP_STEPS SDE-GAN clip steps and DP_STEPS fused ELBO steps and
   one srk discretise ELBO step held to the one-rank card run within
   DP_REL of the largest magnitude, the ranks' parameters bitwise equal
   after every step, each of the three draws launched with a window on
   every rank (counts zeroed before the run, read after), the walls per
   step printed beside the card; (d) a ``Scheduler(shard_base=DP_RANKS)``
   drain of DP_SCHED's 32 requests on the same ranks (rank 0 drives, the
   other follows; CUDA-graph pools per rank) bitwise the one-rank drain.
12. ``flash_attention`` (the LM prefill's GQA attention) against its plain
   version on the card, the same float scale 1/sqrt(D) given to both:
   float32 (rtol = atol = 2e-5) and bfloat16 (6e-2, and ‖Δ‖/‖want‖ of
   every (b, h) slice within ATTN_REL_TOL), causal and full, at (B, Hq,
   Hkv, S, D) in ATTN_SHAPES (qwen2.5-14b's prefill, a short and a ragged
   prompt, tinyllama's group-8 D = 64, S = 1 with one KV head, S = 129,
   D = 16, dbrx-132b's and jamba-v0.1-52b's prefills, tinyllama's
   training shape); at each, two launches bitwise equal,
   the operands as (B, S, H, D) views bitwise the contiguous operands'
   result, and the output the (B, Hq, S, D) view of a (B, S, Hq, D)
   buffer.  The SASS of the built library (``cuobjdump -sass``): every
   bfloat16 attention kernel issues HGMMA, the float32 ones HMMA with TF32
   (split TF32 on mma.sync) and no HGMMA.  Timed in turns, the operands as
   (B, S, H, D) views, beside the plain version, the bound (float32: split
   TF32 on the tensor cores, and the CUDA-core bound beside it) and
   ``scaled_dot_product_attention`` (the library yardstick, called nowhere
   in the port): bfloat16 at the prefill shape, float32 (TF32 off) and
   bfloat16 at the training shape, bfloat16 at dbrx's and jamba's
   prefills.
12b. ``flash_attention`` at MLA's head dim 96 and with a key length of
   its own (the encoder-decoder's cross-attention, full), ATTN_ZOO_SHAPES
   in float32 and bfloat16, held as phase 12 (ATTN_TOL, bf16 also by
   ATTN_REL_TOL a slice, two launches bitwise, views bitwise); causal
   with Sk != S refused by name by the launcher and the plain version;
   HGMMA in the bf16 D = 96 kernel's SASS; timed in turns in both dtypes
   at ATTN_ZOO_TIMED (minicpm3-4b's and pixtral-12b's prefills,
   seamless-m4t-medium's cross-attention and encoder) beside SDPA, the
   plain version and the bound.  ptxas: the D = 96 instantiations free of
   spills and of serialised wgmma (checked after phase 28).
13. LM parity, float32, full width at two layers (qwen2.5-14b with
   ``num_layers=2``): B = 2, S = 512 prefill and 8 greedy decode steps,
   through the kernel and with every attention on the plain version: the
   prefill logits within LM_LOGIT_RTOL of the largest logit, the tokens
   equal, ``flash_attention`` launched twice per prefill and never in
   decode.
14. LM serving, bfloat16, the full qwen2.5-14b (48 layers, 14.77 B
   parameters, random weights drawn on the card): ``serve_lm`` at B = 4,
   prompt 2048, 16 tokens, then at the CLI's shapes (prompt 32), and the
   CLI itself (``--workload lm``, the smoke config).  Counts zeroed just
   before and read just after each: ``flash_attention`` must launch once
   per layer of the prefill and never in decode.  Peak memory, a profile
   of one prefill (the kernel's share), the same prefill with the
   attention as the LM called it before the kernel read the projections
   in place (contiguous copies in, a contiguous output: at least 4 more
   copy kernels a layer, each route's count the median of three profiles), and the
   full-depth prefill on the plain attention: max |Δ| of the last-position logits and first-token
   agreement (asserted finite only; phase 13 is the assertion).  A profile
   of one decode step against the 2064-slot cache (device busy and idle
   share).
15. ``ssd_chunk`` (the Mamba2 prefill's SSD scan) against its plain
   version (the sequential recurrence) on the card: float32 and bfloat16
   x, b, c (float32 a), at the SSD_SHAPES (mamba2-1.3b's prefill, the
   CLI's prompt 32 and the batch-1 prefill in the mixer's layout — x and a
   transposed views, b and c expanded over the heads with stride 0 — then
   a ragged S, S = 1, the four (N, P) pairs around the chunk's edges, a
   strong decay and jamba-v0.1-52b's prefill, H 128, N 16, P 64): y
   within SSD_TOL (rtol = atol), the terminal state within SSD_STATE_RTOL
   of its largest magnitude, both finite; two
   launches, and contiguous copies of the operands, give the same bits; at
   batch 1 the launcher's P slices give at least 128 blocks.  The SASS:
   HMMA on bf16 in the bf16 kernels, HMMA on TF32 in the f32 ones.  Timed
   in turns at the prefill, the batch-1 and jamba's prefill shapes (bf16,
   the mixer's layout) beside the plain version, the tensor-core bound and the
   earlier design's CUDA-core f32 bound, and float32 at the prefill shape
   beside its split-TF32 bound; no single PyTorch call computes it, so
   there is no library time.
16. LM parity, float32, full width at two layers (mamba2-1.3b with
   ``num_layers=2``), as phase 13: B = 2, S = 512 prefill and 8 greedy
   decode steps through the kernel and with every SSD scan on the plain
   version; ``ssd_chunk`` launched twice per prefill and never in decode.
17. LM serving, bfloat16, the full mamba2-1.3b (48 layers, 1,343,740,928
   parameters, random weights drawn on the card) through ``serve_lm`` at
   B = 4, prompt 2048, 16 tokens, then prompt 32, and the CLI (``--workload
   lm --arch mamba2-1.3b``, the smoke config), as phase 14 with
   ``ssd_chunk`` in place of ``flash_attention``: one launch per layer of
   the prefill, none in decode; profiles of one prefill and one decode
   step; the full-depth prefill on the plain scan.
17b. Gradients through the kernels: for a loss linear in the outputs,
   ``flash_attention`` and ``ssd_chunk`` (strided x and a, stride-0 b and
   c) give the plain path's gradients bitwise, ``fused_mlp`` (one launch
   of its backward kernel) within MLP_TOL of them; one backward
   of a two-layer smoke LM's next-token loss (qwen2.5-14b's and
   mamba2-1.3b's families) reaches every parameter, finite, through one
   kernel launch per layer.
18. (Run first, right after the build.)  ``fused_xent`` (the LM loss's
   per-token cross entropy) forward and backward against their plain
   versions, float32 and bfloat16, at XENT_SHAPES (tinyllama-1.1b's
   8192 × 32000 training logits, mamba2-1.3b's 1024 × 50280, the JAX
   suite's shapes, qwen2.5's vocab, R = 1, V = 1): the loss and the
   log-sum-exp within XENT_TOL, dlogits within 1e-5 (float32) or one ulp
   (bfloat16); rows invariant bitwise (1 vs 300 vs 8192 rows).  Timed at
   8192 × 32000 in both dtypes beside the plain versions, the bounds and
   ``F.cross_entropy`` (the forward's library yardstick, called nowhere in
   the port).
19. LM training parity, float32, tinyllama-1.1b at full width and two
   layers, B = 2, S = 512: one ``make_train_step`` step through
   ``fused_xent`` and ``flash_attention`` against the same step with both
   on their plain versions (``plain_xent()``, ``plain_attention()``): the
   loss within 1e-5, ``grad_norm`` within 1e-4, the parameters within
   2·lr_1; the launches asserted; the card's ``token_batches`` bitwise the
   CPU's.
20. LM training, the slice's main path: ``train("tinyllama-1.1b", 3 steps,
   B = 4, S = 2048, the full config)`` with random bf16 weights drawn on
   the card, each step's launches counted (zeroed before, read after):
   ``fused_xent`` and ``fused_xent_bwd`` once each, ``flash_attention`` 44
   (22 in the forward, 22 recomputed by the per-unit checkpoint); the
   parameters float32 after step 1 (the reference's promotion); finite
   losses; wall per step and tokens/s; the peak memory of one gradient
   with and without remat; a profile of one step (busy, idle share, the
   kernels' share); then the resume: 2 steps with a checkpoint, a rerun
   to 3 prints the resume line and reproduces step 3's loss bitwise.
21. mamba2-1.3b's training loss at full width, two layers, B = 2, S = 512,
   bf16: one gradient through ``ssd_chunk`` and ``fused_xent`` against
   the plain route: the loss within 6e-2, every leaf's gradient finite.
23. The MoE and hybrid families, float32, full width at cut depth
   (MOE_PARITY_LAYERS: dbrx-132b and grok-1-314b at two layers,
   jamba-v0.1-52b at one 8-layer unit, weights drawn on the card), as
   phase 13: B = 2, S = 512 prefill and 8 greedy decode steps through the
   kernels and with every attention and SSD scan plain, the plain run
   routed with the kernel run's top-k experts and its own choice compared
   (``route_flips``: flips and their margins printed): the prefill logits
   and the router logits within LM_LOGIT_RTOL of their largest, the tokens
   equal, ``flash_attention`` once per attention layer and ``ssd_chunk``
   once per Mamba2 layer of a prefill, neither in decode; three kernel
   prefills bitwise equal (the MoE combine adds in a fixed order, no
   atomics).
24. Their serving, bfloat16 (MOE_SERVE_LAYERS: jamba's one unit, dbrx at
   4 layers) at B = 4, prompt 2048, 16 tokens through
   ``make_prefill_step`` and ``make_serve_step``: the parameter count
   against ``param_count``, the launches per prefill and in decode, peak
   memory, the decode bound (every expert's weights are read: all E
   capacity rows run), a profile of one prefill and one decode step with
   the MoE's routing, dispatch, expert products and combine as ranges
   beside the two kernels; then the serve CLI (``--workload lm --arch``,
   smoke config) for dbrx-132b, grok-1-314b and jamba-v0.1-52b.
25. Their training: the train CLI (``--workload lm --arch``, smoke
   config, float32, B 8 × 64) 3 steps on the card each, the launches and
   metrics of every step read (``moe_aux`` > 0 and in the loss at 0.01);
   one gradient twice: the router's and the experts' finite, the leaves
   whose bits do not repeat printed.
26. The rest of the zoo, float32, full width at two layers: minicpm3-4b
   (MLA through the kernel at D = 96), pixtral-12b (a 1024-row prefix of
   patch embeddings, the reference's normal draw) and seamless-m4t-medium
   (two encoder and two decoder layers over ZOO_SRC_LEN source frames),
   B = 2, S = 512 prefill and 8 greedy decode steps through the kernel and
   with every attention plain: the logits within LM_LOGIT_RTOL of the
   largest, the tokens equal, ``flash_attention`` once per attention of a
   prefill (seamless: each encoder layer once, each decoder layer twice —
   self and cross), never in decode, three kernel prefills bitwise equal.
27. Their serving, bfloat16, full width and full depth (8.52 / 24.5 /
   1.75 GB of weights drawn on the card): the parameter count against
   ``param_count``, a prefill of B = 4 × 2048 (pixtral behind its prefix,
   seamless over 1024 frames) and 15 greedy decode steps through
   ``make_prefill_step`` / ``make_serve_step``, 62 / 40 / 36 launches a
   prefill and none in decode, peak memory, each decode step against its
   weight-read bound, profiles of a prefill (busy, idle,
   ``flash_attention``'s share) and a decode step; then the serve CLI on
   the minicpm3 and pixtral smoke configs and its refusal of seamless.
28. Their training: the train CLI (smoke configs, float32, B 8 × 64) 3
   steps each, launches and metrics of every step read; one gradient of a
   4-unit reversible tinyllama smoke stack against the plain two-track
   recursion (REV_GRAD_RTOL); the peak memory of one tinyllama gradient at
   full width (f32, B 2 × 512) at 4 and 8 layers, reversible, remat and
   neither.
Each phase's wall is printed as a ``[phase] <name>: <s> s`` line as it ends.

22. Prints a ``{"kernels": [...]}`` JSON line (``dp_launches``: each
   rank's count in phase 11e's data-parallel run; ``window``: the
   windowed launch's timing and launches per rank, for rows 5, 7 and 12;
   ``launches``: the count on
   the path each kernel was ported for (``flash_attention`` also
   ``zoo_timed``, ``ptxas_d96``, ``zoo_prefill_launches``,
   ``zoo_train_launches_per_step`` and ``reversible_gradient_launches``:
   phases 12b and 26–28's) — training (3 steps) for the solver
   kernels, ``fused_mlp`` and ``fused_mlp_bwd``, but SDE-GAN clip step 3 at
   batch 128 for ``brownian_increment``, which the ELBO step no longer
   launches; the adaptive gradient for
   ``brownian_value``, the 2048-token LM serves for ``flash_attention``
   and ``ssd_chunk``, one LM training step of phase 20 for ``fused_xent``
   and ``fused_xent_bwd``; ``moe_prefill_launches`` and
   ``moe_train_launches_per_step``: phases 23–25's; ``adaptive_launches``: the fused adaptive
   gradient's; ``gan_launches``: the counts of SDE-GAN clip step 3 at batch
   128 (no sig-MMD log); ``baseline_launches``: phase 11c's counts of step 3
   of each baseline; ``serve_launches``: the Latent-SDE service's, the adaptive
   service's for ``brownian_value``, the LM serves' for
   ``flash_attention`` and ``ssd_chunk``; ``sched_chunk_launches``: the
   launches one 1024-row scheduler chunk graph recorded;
   ``posterior_decode_launches``: one 1024-row posterior decode's; ``ptxas``: the registers,
   shared memory and spills of ``brownian_value``, the float32 attention,
   ``ssd_chunk``, ``fused_mlp_bwd``, ``fused_mlp``'s 17 → 32 → 16
   instantiations, ``space_time_value`` and the seven dependent
   launches, ``brownian_increment``, ``rev_heun_phase2``,
   ``rev_heun_phase1_gen``, ``rev_heun_phase1``, ``rev_heun_bwd_phase1``,
   ``rev_heun_bwd_phase2`` and ``space_time_increment``, compiled once
   more with ``-Xptxas -v`` in the background, the last seven checked free
   of spills; ``dependent_launch_graph`` on those seven: phase 3's graph
   check) and,
   last, the result line
   ``{"ok": true, "device":
   {...}}``.

``mlp_bwd_split(cu_path, cuts)`` and ``mlp_bwd_stamps(cu_path, marks)``
(not run by ``main``) measure where a ``fused_mlp_bwd`` launch's time
goes: throwaway builds of its source cut short at the stages of
PARENT_BWD_CUTS / BWD_CUTS, or recording clock64 at BWD_MARKS, in a
temporary directory.  ``mlp_fwd_stamps(cu_path, marks)`` and
``st_value_stamps(cu_path, marks)`` record the same stamps in
``fused_mlp`` (FWD_MARKS, or PARENT_FWD_MARKS in a parent tree's source)
and ``space_time_value`` (ST_MARKS, PARENT_ST_MARKS);
``kernels_in_turns(parent_root)`` (not run by ``main``) times those two
kernels, ``space_time_increment`` and the rev_heun kernels through the
port's launchers with the parent tree's build of the kernels and with this
one's, in turns, their outputs bitwise alike: ``space_time_increment`` at
ST_INCREMENT_TIMED and the six rev_heun kernels alone, the rev_heun ones
also in path order (``brownian_increment`` and ``rev_heun_phase2`` behind
``fused_mlp``, ``rev_heun_phase1_gen`` (both signs) behind
``rev_heun_phase2``, ``rev_heun_phase1`` behind ``rev_heun_phase2`` at
sign −1, ``rev_heun_bwd_phase1`` behind ``rev_heun_phase1`` and
``rev_heun_bwd_phase2`` behind an add, as the main path orders them), and
each one alone by its device span on an idle card (``span_us``: what a
launch of the eager training step costs); ``path_predecessors`` (neither) reads that
order from a profiled ELBO step; ``source_variants`` (neither) times
text edits of a kernel's source (FWD_VARIANTS, ST_VARIANTS,
GEN_VARIANTS) back to back and by their spans;
``rev_heun_launcher_costs`` (neither) two launchers' host cost, piece by
piece;
``chunk_in_turns(parent_root)`` (neither) phase 8b's 1024-row chunk graph
(busy, idle, wall of a replay) there and here, in turns.
``drain_in_turns(parent_root)`` (neither) times phase 10's
adaptive serving drain in another tree and this one, in turns;
``ssd_in_turns(parent_root)`` (neither) times ``ssd_chunk`` and
mamba2-1.3b's prefill there and here, in turns; ``elbo_in_turns``
(neither) the fused ELBO step at batch 64 and 1024, the depth-10 adaptive
gradient (walls, launches, device kernels, busy as the sum and as the
union of the device spans) and the ``fused_mlp``
launcher's host cost there and here, in turns; ``srk_in_turns`` (neither)
one srk discretise ELBO step at batch 64 (wall, launches, device kernels,
busy, idle) there and here, in turns; ``smoke_in_turns``
(neither) the whole script there and here, one after the other.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet):
# HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s.  Integer ops
# are counted at the float32 rate; float64 outside the tensor cores 34 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12,
                  torch.bfloat16: 989e12}  # bf16: dense tensor cores
PEAK_TF32_OPS_PER_S = 495e12  # TF32 dense tensor cores (the f32 attention's split TF32)
# Operation counts the bound assumes (minimal work, see bound()).
HASH_OPS = 120          # one Threefry-2x32 hash: 20 rounds of add/rotate/xor + keys
NORMAL_OPS = {torch.float32: 50, torch.float64: 75}  # bits->uniform->erf_inv->scale

# GPU clock cycles per millisecond at the H100 SXM's 1.98 GHz boost clock
# (sizes the hold in time_ms; a lower clock only lengthens the hold).
CYCLES_PER_MS = 1_980_000

# Trajectories on the card vs the port on the CPU, float32: the GEMMs sum in
# another order (cuBLAS vs the CPU BLAS) and sigmoid/tanh/log1p differ by an
# ulp or so; the same bound as the port against the JAX package.
CPU_RTOL, CPU_ATOL = 2e-5, 2e-6

# Exact adjoint vs discretise, float64 (the paper's "to floating-point error").
ADJOINT_RTOL = 1e-12

CSRC = "src/repro_torch/kernels/csrc/rev_heun.cu"
KERNEL_SOURCES = {
    "brownian_value": (CSRC, "src/repro/kernels/brownian.py:101"),
    "rev_heun_phase1": (CSRC, "src/repro/kernels/reversible_heun_step.py:152"),
    "rev_heun_phase2": (CSRC, "src/repro/kernels/reversible_heun_step.py:161"),
    "rev_heun_bwd_phase1": (CSRC, "src/repro/kernels/reversible_heun_step.py:170"),
    "rev_heun_bwd_phase2": (CSRC, "src/repro/kernels/reversible_heun_step.py:180"),
    "brownian_increment": (CSRC, "src/repro/kernels/brownian.py:71"),
    "rev_heun_phase1_gen": (CSRC, "src/repro/kernels/brownian.py:132"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:59"),
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:43"),
    # no TPU kernel: XLA differentiates the plain definition of the kernel above
    "fused_mlp_bwd": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp.py:43"),
    "fused_xent": ("src/repro_torch/kernels/csrc/fused_xent.cu",
                   "src/repro/kernels/xent.py:56"),
    "fused_xent_bwd": ("src/repro_torch/kernels/csrc/fused_xent.cu",
                       "src/repro/kernels/xent.py:56"),
    # no TPU kernel: the reference draws the srk solver's (W, H) pairs with
    # jax.random ops
    "space_time_increment": (CSRC, "src/repro/core/brownian.py:175"),
    "space_time_value": (CSRC, "src/repro/core/brownian.py:238"),
}
# fused_mlp checks, (Din, H, Dout): every depth-1 field of the ELBO (mu and
# sigma 1 + 16 -> 32 -> 16, nu 1 + 16 + 16, qz0 16 -> 2·8, zeta 8), of the
# SDE-GAN generator (zeta 4, sigma 1 + 16 -> 16·4), of its discriminator
# (xi 1 + 1 -> 32 -> 16, g 1 + 16 -> 32 -> 16·2; f is mu's shape) and the
# adaptive burst (32 -> 64 -> 32), the JAX suite's 96 -> 48 -> 24, and a
# 512-wide MLP.
MLP_SHAPES = [(17, 32, 16), (33, 32, 16), (16, 32, 16), (8, 32, 16), (4, 32, 16),
              (17, 32, 64), (2, 32, 16), (17, 32, 32), (32, 64, 32), (96, 48, 24),
              (512, 512, 512)]
# the JAX suite's fused_mlp tolerances (tests/test_kernels.py:18-21) and
# 1e-12 in float64: the kernel sums each row in its own fixed order, the
# plain version in cuBLAS's.
MLP_TOL = {torch.float32: 2e-5, torch.bfloat16: 6e-2, torch.float64: 1e-12}
# The backward's dW1, db1, dW2 and db2 are sums over the R rows.  In float32
# the kernel's order and cuBLAS's each round by ~sqrt(R)·eps times the
# partial sums (~sqrt(R) times a term), ~1e-5 at R = 300 and width 512,
# which 2e-5 absolute misses where a sum cancels to near zero: they are
# held within MLP_TOL of their own largest magnitude as well (atol = 2e-5 ×
# max |want|, as the SSD state is held), which grows with sqrt(R).  dx sums
# over H per row and keeps MLP_TOL; bfloat16 and float64 keep MLP_TOL.
LIPSWISH_OPS = 6  # neg, exp, add, div, mul, mul per hidden unit
# the backward per hidden unit: pre's bias add, LipSwish and a (6), then
# 1 − s, pre·s·(1 − s), s + ..., 0.909·(...), da·(...) (5), db1's add (1)
LIPSWISH_BWD_OPS = 13
# rows of the backward kernel's checks: one block, the ELBO batch, a ragged
# count, the 1024-row bucket, and several tiles a block
MLP_BWD_ROWS = (1, 64, 300, 1024, 4096)
# (tag, rows, Din, H, Dout), float32: the ELBO's training batches and, at
# 1024 rows, the 1024-row decode bucket's prior mu and sigma (the same
# 17 -> 32 -> 16); the posterior nu, the SDE-GAN sigma, the
# discriminator's g at the GAN's 1024 batch, and the burst.
MLP_TIMED = [("train B64", 64, 17, 32, 16), ("train/serve B1024", 1024, 17, 32, 16),
             ("nu B1024", 1024, 33, 32, 16), ("gan sigma B1024", 1024, 17, 32, 64),
             ("disc g B1024", 1024, 17, 32, 32), ("burst B256", 256, 32, 64, 32)]
# flash_attention checks, (B, Hq, Hkv, S, D): qwen2.5-14b's prefill and a
# short prompt, a ragged S, tinyllama's group 8 at D = 64, S = 1 with MQA,
# a ragged S just past one 128-row tile, head dim 16 (the 32-byte swizzle),
# dbrx-132b's and jamba-v0.1-52b's prefills (Hq 48 and 32 over Hkv 8, B 4 ×
# 2048), and tinyllama's training shape (B 4 × 2048, the f32 and bf16
# training timing rows).
ATTN_SHAPES = [(4, 40, 8, 2048, 128), (4, 40, 8, 32, 128), (1, 40, 8, 1000, 128),
               (2, 32, 4, 777, 64), (1, 4, 1, 1, 128), (1, 40, 8, 129, 128),
               (2, 8, 4, 300, 16), (4, 48, 8, 2048, 128), (4, 32, 8, 2048, 128),
               (4, 32, 4, 2048, 64)]
ATTN_PREFILL = ATTN_SHAPES[0]
ATTN_MOE_PREFILLS = {"dbrx-132b": ATTN_SHAPES[7], "jamba-v0.1-52b": ATTN_SHAPES[8]}
ATTN_TRAIN = ATTN_SHAPES[-1]
# flash_attention launches in one tinyllama-1.1b training step (phase 20):
# 22 layers in the forward and 22 recomputed by the per-unit checkpoint.
ATTN_TRAIN_LAUNCHES = 44
# the JAX package's kernel-suite tolerances (tests/test_kernels.py:18-21):
# the kernel's online softmax sums in another order than the plain softmax.
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 6e-2}
# bf16 is held too by the largest ‖Δ‖ / ‖want‖ over the (b, h) slices:
# a typical |o| at S 2048 (~0.03) is below ATTN_TOL's 6e-2, so that alone
# would pass a kernel that drops a KV tile.  Sound kernels read 0.0037 to
# 0.0056 at ATTN_SHAPES (PERF.md); the 16 keys at 16j dropped from every
# row after them move a causal S = 2048 slice by ~sqrt(1/(8j)), above 0.035
# for every j ≤ 100.
ATTN_REL_TOL = 1e-2
# Phase 12b: flash_attention at MLA's head dim 96 (minicpm3-4b's 64 + 32)
# and with a key length of its own (the encoder-decoder's cross-attention,
# never causal), (B, Hq, Hkv, S, Sk, D, causal): minicpm3's heads at S 512
# and at its serving prefill, a ragged S, D 96 full, seamless's cross at
# its serving shape (2048 decoder rows against 1024 frames), a ragged
# cross (300 rows against 1000 keys) at D 64 and D 96, and the smoke
# configs' D 16.
ATTN_ZOO_SHAPES = [(2, 40, 40, 512, 512, 96, True), (4, 40, 40, 2048, 2048, 96, True),
                   (1, 40, 40, 1000, 1000, 96, True), (2, 40, 40, 300, 300, 96, False),
                   (4, 16, 16, 2048, 1024, 64, False), (2, 16, 16, 300, 1000, 64, False),
                   (2, 40, 40, 300, 1000, 96, False), (2, 4, 4, 12, 10, 16, False)]
# the shapes the new serving paths give the kernel, timed in turns beside
# SDPA: minicpm3-4b's and pixtral-12b's prefills (B 4, pixtral's 1024-row
# prefix ahead of 2048 tokens), seamless-m4t-medium's cross-attention and
# its encoder (B 4 x 1024 frames)
ATTN_ZOO_TIMED = {"minicpm3-4b prefill": (4, 40, 40, 2048, 2048, 96, True),
                  "pixtral-12b prefill": (4, 32, 8, 3072, 3072, 128, True),
                  "seamless-m4t-medium cross": (4, 16, 16, 2048, 1024, 64, False),
                  "seamless-m4t-medium encoder": (4, 16, 16, 1024, 1024, 64, False)}
LM_ARCH = "qwen2.5-14b"
# LM parity (f32, two layers): the attention outputs agree to ~1e-6 relative
# (f32 sums in two orders); the GEMMs and the 152064-wide head after it keep
# that relative size, so the logits may differ by a small multiple of 1e-6
# of the largest logit; 1e-4 leaves room for the card's GEMM order.
LM_LOGIT_RTOL = 1e-4
LM_PARITY = dict(batch=2, prompt_len=512, gen=8)
SSM_ARCH = "mamba2-1.3b"
# ssd_chunk checks, ((B, H, S, P, N), the mixer's layout, a's scale):
# mamba2-1.3b's prefill (B 4, prompt 2048), the CLI's prompt 32 (S < the
# chunk, 64), the batch-1 prefill (the launcher cuts P into slices), a
# ragged S, S = 1, the smoke config's heads (N 16, P 16), jamba's (N 16,
# P 64) one past a chunk boundary, (N 128, P 16) at S = the chunk, a
# strong decay (a = −5|N(0, 1)|), and jamba-v0.1-52b's prefill (B 4 × 2048,
# H 128, N 16, P 64: d_model 4096 at ssm_expand 2).
SSD_SHAPES = [((4, 64, 2048, 64, 128), True, 0.1), ((4, 64, 32, 64, 128), True, 0.1),
              ((1, 64, 2048, 64, 128), True, 0.1), ((1, 64, 2000, 64, 128), False, 0.1),
              ((1, 64, 1, 64, 128), False, 0.1), ((2, 8, 100, 16, 16), False, 0.1),
              ((2, 4, 65, 64, 16), True, 0.1), ((2, 4, 64, 16, 128), False, 0.1),
              ((1, 8, 500, 64, 128), True, 5.0), ((4, 128, 2048, 64, 16), True, 0.1)]
SSD_PREFILL = SSD_SHAPES[0][0]
SSD_BATCH1 = SSD_SHAPES[2][0]
SSD_JAMBA = SSD_SHAPES[-1][0]
# the chunk of the earlier CUDA-core f32 design, whose bound stays on
# record beside the tensor-core one
SSD_CUDA_CORE_CHUNK = 32
# the JAX package's SSD tolerances (tests/test_kernels.py:96 for y in f32,
# :21 for bf16 outputs; the state within 2e-4 of its largest magnitude, as
# :120-122 hold ssd_chunked_dense's): a chunked matrix form against the
# sequential recurrence, both in f32 from the same inputs.
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
SSD_STATE_RTOL = 2e-4
LM_SERVE = dict(batch=4, prompt_len=2048, gen=16)
# fused_xent checks, (R, V): tinyllama-1.1b's training logits (B 4 × 2048
# tokens), mamba2-1.3b's (B 2 × 512), the JAX suite's shapes
# (tests/test_kernels.py:153-157), qwen2.5's vocab, one row, one class.
XENT_SHAPES = [(8192, 32000), (1024, 50280), (64, 1024), (128, 512), (32, 1000),
               (256, 152064), (1, 32000), (64, 1)]
XENT_TIMED = XENT_SHAPES[0]
# the JAX suite's tolerances (tests/test_kernels.py:167-168) for the loss
# and the log-sum-exp; dlogits: float32 1e-5, bfloat16 one ulp of the
# output (both round the same float32 value, which differs by ulps).
XENT_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
XENT_FWD_OPS, XENT_BWD_OPS = 6, 5  # per logit: max/compare, sub, exp, add (+ rescale)
TRAIN_ARCH = "tinyllama-1.1b"
# LM training parity (phase 19): full width at two layers, float32.  The
# loss sums the same values in other orders (cuBLAS's and the kernels'), so
# 1e-5; grad_norm sums ~2e8 squares, 1e-4; Adam's first update is
# ±lr·sign(m), so a gradient at the noise floor may flip: 2·lr_1 absolute.
TRAIN_PARITY = dict(batch=2, seq=512)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-5, 1e-4
TRAIN_FULL = dict(batch=4, seq=2048, steps=3)
# mamba2-1.3b's step at full width, two layers, bf16 (phase 21): kernel vs
# plain route, the loss within bf16's relative 6e-2.
SSM_TRAIN = dict(batch=2, seq=512)
SSM_LOSS_RTOL = 6e-2
SERVE_KERNELS = ("rev_heun_phase1_gen", "rev_heun_phase2", "brownian_increment")
# Launches of one fused ELBO step at 23 solver steps: forward 23 x (phase1_gen,
# phase2); backward 23 x (phase1_gen at sign -1, which draws the step's ΔW
# inside the reconstruction, phase1, phase2, bwd_phase1, bwd_phase2) — 46 +
# 115 = 161; brownian_increment 0.
# The fields, each a depth-1 LipSwish MLP (one fused_mlp launch): the
# posterior drift runs nu, mu and sigma, the diffusion sigma, so 4 per
# evaluation.  Forward: qz0 and zeta, then the solve's 24 evaluations (t0
# and one per step) = 2 + 96; backward: per step the reconstruction's and
# the local VJP's evaluations (8), then the initial VJP's (4) = 188.
# The backward kernel runs for every field launch whose output carries a
# gradient: qz0 and zeta (2), 4 in each local VJP (92) and 4 in the initial
# VJP (4) = 98; the solve's forward and the reconstruction run no_grad.
STEP_LAUNCHES = {"rev_heun_phase1_gen": 46, "rev_heun_phase2": 46,
                 "brownian_increment": 0, "rev_heun_phase1": 23,
                 "rev_heun_bwd_phase1": 23, "rev_heun_bwd_phase2": 23,
                 "fused_mlp": 286, "fused_mlp_bwd": 98}
# Launches of one SDE-GAN step at train_sde_gan's widths, 31 solver steps and
# 32 observations (tests/test_torch_gan_train.py holds the formula on the CPU
# with counted plain launches).  A general-noise solve runs unfused: N + 1
# field evaluations forward; backward per step the reconstruction's and the
# local VJP's, then the initial VJP's (2N + 1), a backward launch for each
# of the local and initial VJPs' (N + 1).  An evaluation is 5 fields in the
# joint solve (mu, sigma, f, g in the drift and g again in the diffusion), 2
# in the real path's CDE solve (f, g); zeta and the two xi are one each.
# Clip (one backward of both players): fused_mlp (2 + 160) + (1 + 64) + 315
# + 126 = 668; fused_mlp_bwd 3 + 160 + 64 = 227; brownian_increment 31 + 31.
GAN_STEP_LAUNCHES = {"fused_mlp": 668, "fused_mlp_bwd": 227, "brownian_increment": 62}
# GP: the discriminator's loss (zeta carries no gradient: 2 + 160 + 64
# backward launches), the penalty's discretise CDE solve (1 + 64 launches,
# each one backward launch in the outer backward, none under create_graph),
# then the fake score again for the generator (162 + 315; 2 + 160).
GP_STEP_LAUNCHES = {"fused_mlp": 1210, "fused_mlp_bwd": 453, "brownian_increment": 124}
# the sig-MMD log of train_sde_gan: generator_sample at 256 rows, 1 + 2·32
# field launches and 31 draws, no gradient
GAN_LOG_LAUNCHES = {"fused_mlp": 65, "fused_mlp_bwd": 0, "brownian_increment": 31}
# The paper's baselines at the ELBO's widths, one terminal-form step each at 23
# solver steps (tests/test_torch_gradients.py:elbo_launches holds the formula
# on the CPU with counted plain launches).  qz0 and zeta are one fused_mlp
# launch each, both differentiated; an evaluation of the posterior is 4 field
# launches (nu, mu, sigma in the drift, sigma in the diffusion).  Backsolve:
# N x 2 evaluations forward without a graph, then per step 2 stages, each a
# pull of the drift's 3 fields and the diffusion's 1 (a launch and a backward
# launch each) — 2 + 184 + 184 and 2 + 184; N draws forward, N re-drawn back.
# Checkpoint: the halving schedule over 2^5 = 32 padded steps recomputes
# 5 x 32 = 160 (checkpoint_schedule), so 192 step evaluations, each a draw;
# the backward differentiates the 32 padded steps once; reversible Heun adds
# its carry's evaluation at t0 (4 launches, differentiated).
BASELINE_STEP_LAUNCHES = {
    "midpoint/backsolve": {"fused_mlp": 370, "fused_mlp_bwd": 186,
                           "brownian_increment": 46},
    "midpoint/checkpoint": {"fused_mlp": 1538, "fused_mlp_bwd": 258,
                            "brownian_increment": 192},
    "reversible_heun/checkpoint": {"fused_mlp": 774, "fused_mlp_bwd": 134,
                                   "brownian_increment": 192}}
# train_latent_sde's keyword arguments of each variant of phase 11c; the bf16
# step launches what the float32 fused step does (STEP_LAUNCHES).
BASELINE_VARIANTS = {
    "midpoint/backsolve": dict(solver="midpoint", adjoint="backsolve"),
    "midpoint/checkpoint": dict(solver="midpoint", adjoint="checkpoint"),
    "reversible_heun/checkpoint": dict(solver="reversible_heun", adjoint="checkpoint"),
    "exact fused/bf16_compute": dict(use_pallas=True, precision="bf16_compute")}
# One WGAN-GP step with the midpoint solver (discretise, general noise) at
# train_sde_gan's widths, 31 steps, 32 observations (tests/test_torch_gradients.py:
# gp_launches): an evaluation is 5 fields in the joint solve, 2 in the CDE's;
# every field launch of a recorded solve is differentiated once.  The
# discriminator's loss (2 + 310 fake, zeta without a gradient; 1 + 124 real),
# the penalty's CDE solve (1 + 124), the generator's fake score (2 + 310).
GP_MIDPOINT_STEP_LAUNCHES = {"fused_mlp": 874, "fused_mlp_bwd": 873, "brownian_increment": 62}
# the sig-MMD log: generator_sample at 256 rows, 1 + 31 x 2 x 2 launches
GP_MIDPOINT_LOG_LAUNCHES = {"fused_mlp": 125, "fused_mlp_bwd": 0, "brownian_increment": 31}
# The srk ELBO step (phase 11d): an srk step evaluates the drift 3 times and
# the diffusion 5 times, the posterior's drift being 3 field launches (nu,
# mu, sigma) and its diffusion 1, so 14 a step; qz0 and zeta 2 more.
# Discretise (the trajectory form): 23 steps forward, every launch
# differentiated once, one (W, H) draw a step.  Checkpoint: the halving
# schedule's 32 + 160 step evaluations, each a draw, and the 32 padded
# steps differentiated once (tests/test_torch_srk.py derives both).
SRK_STEP_LAUNCHES = {
    "srk/discretise": {"fused_mlp": 324, "fused_mlp_bwd": 324, "space_time_increment": 23},
    "srk/checkpoint": {"fused_mlp": 2690, "fused_mlp_bwd": 450,
                       "space_time_increment": 192}}
SRK_VARIANTS = {"srk/discretise": dict(solver="srk"),
                "srk/checkpoint": dict(solver="srk", adjoint="checkpoint")}
# space-time kernel checks (phase 11d): rows x per-row sizes x depths
LEVY_ROWS = (1, 64, 1000, 1024)
LEVY_SIZES = (1, 8, 17)
# one key over the srk ELBO's draws at B 64 and 1024, and over an odd width
# (the last counter pair's zero pad)
LEVY_ONE_KEY = [(1, (64, 17)), (1, (1024, 17)), (1, (1087,))]
LEVY_DEPTHS = (0, 1, 10, 24)
# space_time_value past its ring of levels (csrc/rev_heun.cu kStRing = 16: the
# walker waits for the combiner to free a slot)
LEVY_DEEP = (100, 512)
LEVY_DEEP_SIZES = [(1, (256, 32)), (1024, (32,))]
# benchmarks/convergence.py:srk_frontier, its tiny preset
SRK_MU, SRK_SIGMA = 0.7, 0.5
SRK_FINE = 4096
SRK_GRIDS = (8, 16, 32, 64, 128)
SRK_HEUN_GRIDS = (32, 64, 128, 256, 512, 1024)
SRK_PATHS = 512
SRK_SLOPE = (1.4, 1.6)
# Table 2's access patterns (benchmarks/brownian.py): 100 intervals of [0, 1]
BI_INTERVALS = 100
BI_SIZES = (2560, 32768)
CHECKPOINT_ERR_GATE = 1e-10        # benchmarks/gradient_error.py:189
BF16_SHIFT_BOUNDS = (1e-6, 0.2)    # benchmarks/gradient_error.py:194
# The Latent SDE at the widths the repo trains it at (examples/
# latent_sde_air_quality.py:75, src/repro/launch/train.py:318).
WIDTHS = dict(data_dim=2, hidden_dim=16, context_dim=16, initial_noise_dim=8,
              width=32, depth=1, num_steps=23, t1=1.0)
SEQ_LEN = 24
# The SDE-GAN generator at the widths the repo trains and serves it at
# (src/repro/launch/train.py:255, examples/sde_gan_ou.py:41,
# src/repro/serving/service.py:51): dt0 = t1 / num_steps = 1/16.
GAN_WIDTHS = dict(data_dim=1, hidden_dim=16, noise_dim=4, initial_noise_dim=4, width=32,
                  depth=1, num_steps=16, t1=1.0)
# The adaptive workload (benchmarks/solver_speed.py:207, benchmarks/convergence.py:96).
BURST = dict(batch=256, x_dim=32, rtol=2e-3, atol=1e-5, max_steps=2048)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def time_ms(fn, reps: int = 20, trials: int = 7) -> tuple:
    """``(device_ms, host_ms)`` per call, medians over trials, by CUDA events.

    host: ``reps`` calls issued back to back, i.e. what a caller pays per
    call when the host is the limit.  device: the stream is first held busy
    (``torch.cuda._sleep``, for twice the host time of the ``reps`` calls)
    while the host enqueues them, so the events bracket the card's own time
    for the calls, back to back."""
    fn()
    torch.cuda.synchronize()

    def run(hold_cycles: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    host = statistics.median(run(0) for _ in range(trials))
    hold = int(2 * host * reps * CYCLES_PER_MS) + 1_000_000
    device = statistics.median(run(hold) for _ in range(trials))
    return device, host


def span_us(fn, n: int = 100) -> float:
    """The device span of a one-launch call on an idle card, µs: ``n``
    calls, each followed by a synchronise (so no launch queues behind
    another, as in the eager training step, whose host issues slower than
    the card runs), under torch.profiler; the mean span of the device
    events it recorded (it may drop a few, and a whole profile now and
    then: up to three profiles are taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
        if events:
            break
    check(bool(events), "span_us: the profiler recorded no device events")
    return sum(_device_us(e) for e in events) / sum(e.count for e in events)


def bound(name: str, B: int, d: int, dtype) -> tuple:
    """Least time for the work: bytes each read and written once over HBM
    bandwidth vs operations over the peak rate; -> (ms, 'bytes'|'operations').

    Minimal work: one fold_in hash per row, one hash per counter pair (two
    float32 draws share a pair; a float64 draw uses a whole pair)."""
    s = torch.finfo(dtype).bits // 8
    n = B * d
    hashes = B + (-(-d // 2) * B if dtype == torch.float32 else n)
    draw_ops = hashes * HASH_OPS + n * (NORMAL_OPS[dtype] + 1)
    if name == "rev_heun_phase2":  # 6 in, 1 out
        nbytes, ops = 7 * n * s, 7 * n
    elif name == "rev_heun_phase1":  # z, zh, mu, sigma, dw in; zh1 out
        nbytes, ops = 6 * n * s, 6 * n
    elif name == "rev_heun_bwd_phase1":  # g_z1, g_mu1, g_sig1, dw in; 2 out
        nbytes, ops = 6 * n * s, 6 * n
    elif name == "rev_heun_bwd_phase2":  # g_z1, ghat, dw in; 4 out
        nbytes, ops = 7 * n * s, 10 * n
    elif name == "brownian_increment":
        nbytes, ops = B * 16 + n * s, draw_ops
    else:  # rev_heun_phase1_gen: z, zh, mu, sigma, keys in; zh1, dw out
        nbytes, ops = B * 16 + 6 * n * s, draw_ops + 6 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_calls(ops, keys, st, d, dtype):
    """name -> call(use_kernel) of every kernel on one set of operands."""
    z, zh, mu, sg, mu1, sg1, dw = st
    dt = 1.0 / 23
    return {
        "rev_heun_phase1": lambda uk: (ops.rev_heun_phase1(z, zh, mu, sg, dw, dt, 1.0,
                                                           use_kernel=uk),
                                       ops.rev_heun_phase1(z, zh, mu, sg, dw, dt, -1.0,
                                                           use_kernel=uk)),
        "rev_heun_phase2": lambda uk: ops.rev_heun_phase2(
            z, mu, mu1, sg, sg1, dw, dt, use_kernel=uk),
        "rev_heun_bwd_phase1": lambda uk: ops.rev_heun_bwd_phase1(
            z, mu, sg, dw, dt, use_kernel=uk),
        "rev_heun_bwd_phase2": lambda uk: ops.rev_heun_bwd_phase2(
            z, zh, dw, dt, use_kernel=uk),
        "brownian_increment": lambda uk: ops.brownian_increment(
            keys, 5, (d,), dtype, dt, use_kernel=uk),
        "rev_heun_phase1_gen": lambda uk: (
            *ops.rev_heun_phase1_gen(z, zh, mu, sg, keys, 5, dt, dt, 1.0, use_kernel=uk),
            *ops.rev_heun_phase1_gen(z, zh, mu, sg, keys, 5, dt, dt, -1.0, use_kernel=uk)),
    }


# The kernels' checked shapes, (rows, d): one element and odd sizes (the last
# counter pair's zero pad), the serving bucket and the training state, the
# training path's one-key draws (one row of B·17: a BrownianPath with a
# single key over the (B, 17) state) and the SDE-GAN's (one row of B·4).
KERNEL_SHAPES = [(1, 1), (1, 3), (1, 16), (1, 17), (64, 17), (1024, 16), (1024, 17),
                 (1, 64 * 17), (1, 1024 * 17), (1, 128 * 4), (1, 1024 * 4)]
# The one-pass kernels on contiguous views this many elements into a flat
# buffer (off a 16-byte boundary: rev_heun_phase2's and rev_heun_bwd_phase1's
# element-a-thread path)
VIEW_OFFSETS = (1, 2, 3)


def _view_checks(ops, g, dev, dtype, rows, d):
    """The four one-pass kernels (rev_heun_phase1 at both signs,
    rev_heun_phase2, rev_heun_bwd_phase1, rev_heun_bwd_phase2) on views at
    VIEW_OFFSETS of flat buffers against the same values as contiguous
    copies and the plain version: bitwise, or raise."""
    n = rows * d
    dt = 1.0 / 23
    calls = {"rev_heun_phase1": (5, lambda uk, *v: tuple(ops.rev_heun_phase1(
                 *v, dt, sign, use_kernel=uk) for sign in (1.0, -1.0))),
             "rev_heun_phase2": (6, lambda uk, *v: (ops.rev_heun_phase2(
                 *v, dt, -1.0, use_kernel=uk),)),
             "rev_heun_bwd_phase1": (4, lambda uk, *v: ops.rev_heun_bwd_phase1(
                 *v, dt, use_kernel=uk)),
             "rev_heun_bwd_phase2": (3, lambda uk, *v: ops.rev_heun_bwd_phase2(
                 *v, dt, use_kernel=uk))}
    for name, (k, call) in calls.items():
        for off in VIEW_OFFSETS:
            flat = [torch.randn(n + off, generator=g, dtype=dtype).to(dev) for _ in range(k)]
            views = [f[off:].view(rows, d) for f in flat]
            got = call(None, *views)
            want = call(None, *(v.clone() for v in views))
            plain = call(False, *views)
            check(views[0].data_ptr() % 16 != 0 or dtype == torch.float64,
                  f"{name} view at offset {off} sits on a 16-byte boundary")
            check(all(torch.equal(a, b) and torch.equal(a, c)
                      for a, b, c in zip(got, want, plain)),
                  f"{name} {dtype} ({rows}, {d}) view at offset {off}: kernel != "
                  f"contiguous copies / plain")


def _operands(g, dev, dtype, rows, d):
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(dev)
    st = [torch.randn(rows, d, generator=g, dtype=dtype).to(dev) for _ in range(7)]
    return keys, st


def kernel_checks(ops, dev) -> tuple:
    """Phase 3: every kernel bitwise against its plain version; timed at the
    main paths' shapes.  Returns ``{(name, dtype, B, d): row}`` timings and
    ``{name: max |Δ|}``."""
    g = torch.Generator().manual_seed(1234)
    errs = {name: 0.0 for name, (src, _) in KERNEL_SOURCES.items()
            if src == CSRC and name not in ("brownian_value", "space_time_increment",
                                            "space_time_value")}
    shapes = KERNEL_SHAPES
    for dtype in (torch.float32, torch.float64):
        for rows, d in shapes:
            _view_checks(ops, g, dev, dtype, rows, d)
            keys, st = _operands(g, dev, dtype, rows, d)
            for name, call in _kernel_calls(ops, keys, st, d, dtype).items():
                got, want = call(True), call(False)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                check(same and err == 0.0,
                      f"{name} {dtype} rows={rows} d={d}: kernel != plain (max |Δ| {err})")
                errs[name] = max(errs[name], err)
    print("bitwise: 6 kernels x {float32, float64} x (rows, d) in "
          f"{shapes}: kernel == plain; rev_heun_phase1 (both signs), rev_heun_phase2, "
          f"rev_heun_bwd_phase1 and rev_heun_bwd_phase2 on views at offsets "
          f"{VIEW_OFFSETS}: == the contiguous copies' result", flush=True)

    rows = {}
    print("kernel                dtype    B     d   kernel_ms (host)     "
          "plain_ms (host)      bound_ms (by)", flush=True)
    timed = [(dt, B, 17) for dt in (torch.float32, torch.float64) for B in (64, 1024)]
    timed.append((torch.float32, 1024, 16))  # the serving bucket
    for dtype, B, d in timed:
        for name in errs:
            if d == 16 and name not in SERVE_KERNELS:
                continue
            # training draws come from one key over the whole (B, 17) state
            one_key = name in ("brownian_increment", "rev_heun_phase1_gen") and d == 17
            r, dd = (1, B * d) if one_key else (B, d)
            keys, st = _operands(g, dev, dtype, r, dd)
            call = _kernel_calls(ops, keys, st, dd, dtype)[name]
            # the call runs sign +1 and -1
            per = 2 if name in ("rev_heun_phase1", "rev_heun_phase1_gen") else 1
            k_ms, k_host = (x / per for x in time_ms(lambda: call(True)))
            p_ms, p_host = (x / per for x in time_ms(lambda: call(False)))
            b_ms, b_by = bound(name, r, dd, dtype)
            print(f"{name:21s} {str(dtype)[6:]:8s} {B:<5d} {d:<3d} "
                  f"{k_ms:.5f} ({k_host:.5f})  {p_ms:.5f} ({p_host:.5f})  "
                  f"{b_ms:.6f} ({b_by})", flush=True)
            rows[(name, dtype, B, d)] = dict(ms=k_ms, plain_ms=p_ms, host_ms=k_host,
                                             plain_host_ms=p_host, bound_ms=b_ms,
                                             bound_by=b_by)
    return rows, errs


# The rev_heun kernels launched as programmatic dependent launches, and
# their device functions (as ptxas names them).
DEPENDENT_KERNELS = {"brownian_increment": "brownian_increment_kernel",
                     "rev_heun_phase2": "rev_heun_phase2_kernel",
                     "rev_heun_phase1_gen": "phase1_gen_kernel",
                     "rev_heun_phase1": "phase1_kernel",
                     "rev_heun_bwd_phase1": "bwd_phase1_kernel",
                     "rev_heun_bwd_phase2": "bwd_phase2_kernel",
                     "space_time_increment": "space_time_increment_kernel"}
# The stages of _pdl_chain, in launch order; every one after fused_mlp is a
# programmatic dependent launch that reads an earlier stage's output.
PDL_CHAIN = ("fused_mlp", "rev_heun_phase2", "brownian_increment", "space_time_increment",
             "rev_heun_phase1_gen", "rev_heun_phase1", "rev_heun_bwd_phase1",
             "rev_heun_bwd_phase2")


def _mangled(func: str) -> str:
    """The piece of a mangled name that names the device function ``func``
    and no other (``phase1_kernel`` is a suffix of ``bwd_phase1_kernel``)."""
    return f"{len(func)}{func}I"


def _pdl_chain(ops, dev, rows: int = 1024):
    """``chain()``: the diffusion field (``fused_mlp``, rows × 17 -> 32 ->
    16), ``rev_heun_phase2`` on a rows × 16 state consuming its σ′, the
    next step's ``brownian_increment`` (per-row keys), the srk step's
    ``space_time_increment`` (the same keys), then ``rev_heun_phase1_gen``
    on phase 2's z₁ with that increment as its σ and the space-time W as
    its μ, ``rev_heun_phase1`` at sign -1 on that z₁ and phase1_gen's ẑ₁ and ΔW,
    ``rev_heun_bwd_phase1`` seeded with its output, and
    ``rev_heun_bwd_phase2`` taking bwd_phase1's first output as its ĝ,
    float32 — the serving step's order, then the forward's and the
    backward's, each launch after ``fused_mlp`` a programmatic dependent
    launch behind the kernel before it (PDL_CHAIN)."""
    g = torch.Generator().manual_seed(28)
    x, *w = _mlp_operands(g, dev, torch.float32, rows, 17, 32, 16)
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(dev)
    z, zh, mu, mu1, sigma, dw = (torch.randn(rows, 16, generator=g).to(dev) for _ in range(6))
    dt = 1.0 / 32

    def chain():
        sigma1 = ops.fused_mlp(x, *w)
        z1 = ops.rev_heun_phase2(z, mu, mu1, sigma, sigma1, dw, dt)
        inc = ops.brownian_increment(keys, 3, (16,), torch.float32, dt)
        w_st, h_st = ops.space_time_increment(keys, 3, (16,), torch.float32, dt)
        zh1, dw1 = ops.rev_heun_phase1_gen(z1, zh, w_st, inc, keys, 4, dt, dt)
        zr = ops.rev_heun_phase1(z1, zh1, mu, sigma, dw1, dt, -1.0)
        seeds = ops.rev_heun_bwd_phase1(zr, mu1, sigma1, dw1, dt)
        return (sigma1, z1, inc, w_st, h_st, zh1, dw1, zr, *seeds,
                *ops.rev_heun_bwd_phase2(zr, seeds[0], dw1, dt))
    return chain


def pdl_graph_checks(ops, dev) -> dict:
    """Phase 3's graph check: ``_pdl_chain`` captured as one CUDA graph
    (``keep_graph``, so its edges can be read) and replayed, bitwise the
    eager calls; its programmatic-dependency edges counted, which says
    whether stream capture kept the dependent launches (one edge a stage
    after ``fused_mlp``: all kept)."""
    from repro_torch.kernels import brownian as bk

    chain = _pdl_chain(ops, dev)
    want = chain()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        chain()  # first-use work outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        outs = chain()
    edges = bk.graph_programmatic_edges(graph)
    graph.instantiate()
    what = " -> ".join(PDL_CHAIN)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(outs, want)),
              f"the captured {what} graph's replay != the eager calls")
    expected = len(PDL_CHAIN) - 1
    kept = edges >= expected
    print(f"dependent launch under stream capture: {edges} programmatic edges (of "
          f"{expected}) in the graph of {what} ("
          f"{'kept' if kept else 'not all kept' if edges >= 0 else 'runtime cannot tell'}); "
          f"two replays bitwise the eager calls", flush=True)
    return {"programmatic_edges": edges, "expected_edges": expected, "kept_under_capture": kept}


def mlp_bound(rows: int, din: int, h: int, dout: int, dtype) -> tuple:
    """Least time for one fused_mlp call: x, the weights and biases read and
    the output written once, against 2·rows·(Din·H + H·Dout) product flops,
    LIPSWISH_OPS per hidden unit and the bias adds, over the dtype's peak
    (float32 outside the tensor cores); -> (ms, 'bytes'|'operations')."""
    s = torch.finfo(dtype).bits // 8
    nbytes = (rows * din + din * h + h + h * dout + dout + rows * dout) * s
    ops = 2 * rows * (din * h + h * dout) + rows * h * LIPSWISH_OPS + rows * (h + dout)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mlp_operands(g, dev, dtype, rows, din, h, dout):
    """x ~ N(0, 1), W ~ N(0, 1/fan_in), b ~ 0.1·N(0, 1): the JAX suite's
    draws (W ~ 0.3·N(0, 1) at its widths ≤ 96) with the weight scale of
    ``nn.mlp_init`` (1/sqrt(fan_in)), so the 512-wide MLP's sums stay O(1)
    as a trained field's do; at 0.3·N a 512-wide layer's terms reach |7|
    and its outputs cancel below the float32 tolerance's absolute part."""
    def randn(*shape, f=1.0):
        return (f * torch.randn(*shape, generator=g, dtype=torch.float64)).to(dev, dtype)

    return (randn(rows, din), randn(din, h, f=din ** -0.5), randn(h, f=0.1),
            randn(h, dout, f=h ** -0.5), randn(dout, f=0.1))


def mlp_checks(ops, dev) -> tuple:
    """Phase 3b: fused_mlp against its plain version at every field shape in
    float32, bfloat16 and float64, row invariance bitwise, then timed at
    MLP_TIMED beside the plain version, the route the fields took before
    (the layer loop) and the bound.  Returns ({tag: row}, {dtype: max |Δ|})."""
    from repro_torch import nn
    from repro_torch.nn import core as nn_core

    g = torch.Generator().manual_seed(16)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for din, h, dout in MLP_SHAPES:
            for rows in (1, 300, 1024):
                x, *w = _mlp_operands(g, dev, dtype, rows, din, h, dout)
                got = ops.fused_mlp(x, *w)
                want = ops.fused_mlp(x, *w, use_kernel=False)
                torch.cuda.synchronize()
                tol = MLP_TOL[dtype]
                d = (got.double() - want.double()).abs().max().item()
                check(got.dtype == dtype and got.shape == (rows, dout)
                      and torch.isfinite(got).all().item()
                      and torch.allclose(got, want, rtol=tol, atol=tol),
                      f"fused_mlp {dtype} rows={rows} {(din, h, dout)}: kernel != plain "
                      f"(max |Δ| {d}, tolerance {tol})")
                errs[dtype] = max(errs.get(dtype, 0.0), d)
        for din, h, dout in MLP_SHAPES:
            x, *w = _mlp_operands(g, dev, dtype, 1024, din, h, dout)
            full = ops.fused_mlp(x, *w)
            check(torch.equal(ops.fused_mlp(x, *w), full),
                  f"fused_mlp {dtype} {(din, h, dout)}: two launches differ")
            check(torch.equal(ops.fused_mlp(x[:1000].contiguous(), *w), full[:1000])
                  and all(torch.equal(ops.fused_mlp(x[r:r + 1].contiguous(), *w)[0], full[r])
                          for r in (0, 511, 999, 1023)),
                  f"fused_mlp {dtype} {(din, h, dout)}: rows differ between 1, 1000 and "
                  f"1024-row launches")
        print(f"fused_mlp {str(dtype)[6:]}: kernel vs plain max |Δ| {errs[dtype]:.3g} (tol "
              f"{MLP_TOL[dtype]}) over (Din, H, Dout) in {MLP_SHAPES} x rows {{1, 300, "
              f"1024}}; at every width two launches alike and rows invariant bitwise (1 vs "
              f"1000 vs 1024)", flush=True)

    rows_out = {}
    for tag, rows, din, h, dout in MLP_TIMED:
        x, *w = _mlp_operands(g, dev, torch.float32, rows, din, h, dout)
        layers = [{"w": w[0], "b": w[1]}, {"w": w[2], "b": w[3]}]
        k_ms, k_host = time_ms(lambda: ops.fused_mlp(x, *w))
        p_ms, p_host = time_ms(lambda: ops.fused_mlp(x, *w, use_kernel=False))
        l_ms, l_host = time_ms(lambda: nn_core._mlp_layers(layers, x, nn.lipswish))
        b_ms, b_by = mlp_bound(rows, din, h, dout, torch.float32)
        print(f"fused_mlp float32 {tag} {(rows, din, h, dout)}: kernel {k_ms:.5f} ms (host "
              f"{k_host:.5f}), plain {p_ms:.5f} ms (host {p_host:.5f}), the layer loop "
              f"(1024-row blocks) {l_ms:.5f} ms (host {l_host:.5f}), bound {b_ms:.7f} ms "
              f"({b_by})", flush=True)
        rows_out[tag] = dict(ms=k_ms, host_ms=k_host, plain_ms=p_ms, plain_host_ms=p_host,
                             layers_ms=l_ms, layers_host_ms=l_host, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
    return rows_out, errs


def mlp_bwd_bound(rows: int, din: int, h: int, dout: int, dtype) -> tuple:
    """Least time for one backward call: x, the weights, b1 and g read and
    dx, dW1, db1, dW2, db2 written once, against the products (pre
    recomputed, da = g·W2ᵀ, dW2, dW1, dx: 2·rows·(3·Din·H + 2·H·Dout)
    flops), LIPSWISH_BWD_OPS per hidden unit and db2's adds, over the
    dtype's peak (float32 outside the tensor cores for bfloat16's float32
    arithmetic); -> (ms, 'bytes'|'operations')."""
    s = torch.finfo(dtype).bits // 8
    weights = din * h + h + h * dout
    nbytes = (rows * din + weights + rows * dout + rows * din + weights + dout) * s
    ops = (2 * rows * (3 * din * h + 2 * h * dout) + rows * h * LIPSWISH_BWD_OPS
           + rows * dout)
    peak = PEAK_OPS_PER_S[torch.float32 if dtype == torch.bfloat16 else dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_bwd_atol(name: str, want: torch.Tensor) -> float:
    """The absolute tolerance of one backward output against its plain
    version: MLP_TOL, and for float32 sums over rows (dW, db) at least
    MLP_TOL of the largest |want| (see MLP_TOL)."""
    tol = MLP_TOL[want.dtype]
    if want.dtype == torch.float32 and name != "dx":
        return max(tol, tol * want.abs().max().item())
    return tol


def _plain_vjp_mlp(x, w, g):
    """The backward fused_mlp had before its kernel: the plain version's VJP
    at the saved inputs (kernels/vjp.py), as autograd runs it (no grad)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.vjp import plain_vjp

    with torch.no_grad():
        return plain_vjp(ref.fused_mlp, (x, *w), (g,), (True,) * 5, {})


def mlp_bwd_checks(ops, dev, floor_ms: float) -> tuple:
    """Phase 3b, the backward: fused_mlp_bwd against ref.fused_mlp_bwd at
    MLP_SHAPES × MLP_BWD_ROWS in the three dtypes (MLP_TOL, finite, the
    inputs' shapes and dtypes), two launches bitwise, dx rows invariant (1
    vs 1000 vs 1024), an expanded cotangent bitwise its contiguous copy,
    the launch plan (``fused_mlp.bwd_plan``) printed by R; then timed at
    MLP_TIMED beside the plain VJP the node ran before, the plain version,
    the bound and the launch floor ``floor_ms``.  Returns ({tag: row}, {dtype: max |Δ|})."""
    from repro_torch.kernels import build, fused_mlp as fm, ref

    lib = build.load()
    g0 = torch.Generator().manual_seed(161)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        code = fm.DTYPE_CODES[dtype]
        for din, h, dout in MLP_SHAPES:
            for rows in MLP_BWD_ROWS:
                x, *w = _mlp_operands(g0, dev, dtype, rows, din, h, dout)
                g = torch.randn(rows, dout, generator=g0, dtype=torch.float64).to(dev, dtype)
                ops.reset_launch_counts()
                got = fm._launch_bwd(x, *w, g)
                check(ops.launch_counts()["fused_mlp_bwd"] == 1, "fused_mlp_bwd: not one launch")
                again = fm._launch_bwd(x, *w, g)
                want = ref.fused_mlp_bwd(x, *w, g)
                torch.cuda.synchronize()
                tol = MLP_TOL[dtype]
                where = f"fused_mlp_bwd {str(dtype)[6:]} rows={rows} {(din, h, dout)}"
                for name, a, b, t in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want,
                                         (x, *w)):
                    d = (a.double() - b.double()).abs().max().item()
                    atol = mlp_bwd_atol(name, b)
                    check(a.dtype == dtype and a.shape == t.shape
                          and torch.isfinite(a).all().item()
                          and torch.allclose(a, b, rtol=tol, atol=atol),
                          f"{where}: {name} kernel != plain (max |Δ| {d}, rtol {tol}, atol "
                          f"{atol})")
                    errs[dtype] = max(errs.get(dtype, 0.0), d)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{where}: two launches differ")
            x, *w = _mlp_operands(g0, dev, dtype, 1024, din, h, dout)
            g = torch.randn(1024, dout, generator=g0, dtype=torch.float64).to(dev, dtype)
            full = fm._launch_bwd(x, *w, g)[0]
            check(torch.equal(fm._launch_bwd(x[:1000].contiguous(), *w,
                                             g[:1000].contiguous())[0], full[:1000])
                  and all(torch.equal(fm._launch_bwd(x[r:r + 1].contiguous(), *w,
                                                     g[r:r + 1].contiguous())[0][0], full[r])
                          for r in (0, 511, 999, 1023)),
                  f"fused_mlp_bwd {dtype} {(din, h, dout)}: dx rows differ between 1, 1000 "
                  f"and 1024-row launches")
            ge = g[:1].expand(1024, dout)
            check(all(torch.equal(a, b) for a, b in zip(fm._launch_bwd(x, *w, ge),
                                                         fm._launch_bwd(x, *w, ge.contiguous()))),
                  f"fused_mlp_bwd {dtype} {(din, h, dout)}: an expanded g != its copy")
        plans = {r: fm.bwd_plan(code, r, 17, 32, 16) for r in MLP_BWD_ROWS}
        clusters = lib.rt_fused_mlp_bwd_clusters(code, 1024, 17, 32, 16)
        check(clusters >= 1, f"fused_mlp_bwd {dtype}: its cluster cannot be scheduled "
                             f"({clusters})")
        print(f"fused_mlp_bwd {str(dtype)[6:]}: kernel vs ref.fused_mlp_bwd max |Δ| "
              f"{errs[dtype]:.3g} (rtol = atol = {MLP_TOL[dtype]}; float32 dW, db: atol "
              f"{MLP_TOL[dtype]} of their largest) over (Din, H, Dout) in MLP_SHAPES x "
              f"rows {MLP_BWD_ROWS}; two launches bitwise; dx rows invariant (1 vs 1000 vs "
              f"1024); at 17 -> 32 -> 16 by rows, cluster "
              f"x tile rows x tiles a block: "
              f"{ {r: (p['blocks'], p['tile'], p['tiles_per_block']) for r, p in plans.items()} }"
              f"; partials at 512 -> 512 -> 512: "
              f"{fm.bwd_plan(code, 300, 512, 512, 512)['partial_bytes']} bytes; "
              f"{clusters} clusters of the launch fit the card at once", flush=True)

    rows_out = {}
    for tag, rows, din, h, dout in MLP_TIMED:
        x, *w = _mlp_operands(g0, dev, torch.float32, rows, din, h, dout)
        g = torch.randn(rows, dout, generator=g0).to(dev)
        k_ms, k_host = time_ms(lambda: fm._launch_bwd(x, *w, g))
        v_ms, v_host = time_ms(lambda: _plain_vjp_mlp(x, w, g))
        p_ms, p_host = time_ms(lambda: ref.fused_mlp_bwd(x, *w, g))
        b_ms, b_by = mlp_bwd_bound(rows, din, h, dout, torch.float32)
        plan = fm.bwd_plan(0, rows, din, h, dout)
        print(f"fused_mlp_bwd float32 {tag} {(rows, din, h, dout)} (cluster of "
              f"{plan['blocks']}, tiles of {plan['tile']} rows, {plan['tiles_per_block']} a "
              f"block): kernel {k_ms:.5f} ms (host {k_host:.5f}), {k_ms / floor_ms:.2f}x the "
              f"launch floor {floor_ms:.5f} ms; the plain VJP {v_ms:.5f} ms (host "
              f"{v_host:.5f}), ref.fused_mlp_bwd {p_ms:.5f} ms (host {p_host:.5f}), bound "
              f"{b_ms:.7f} ms ({b_by})", flush=True)
        rows_out[tag] = dict(ms=k_ms, host_ms=k_host, plain_ms=v_ms, plain_host_ms=v_host,
                             ref_ms=p_ms, ref_host_ms=p_host, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, launch_floor_ms=floor_ms,
                             plan={k: plan[k] for k in ("blocks", "tile", "tiles_per_block")})
    return rows_out, errs


def host_us(fn, n: int = 2000, trials: int = 5) -> float:
    """Host microseconds per call: ``n`` calls back to back by the host
    clock (median of trials), the card synchronised after each trial."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def launcher_costs(dev) -> dict:
    """The host cost of a fused_mlp call at 1024 × 17 -> 32 -> 16 (float32),
    piece by piece: the launcher's pieces, the pieces of the launcher before
    them that still exist to call (its output allocation, stream lookup and
    PlainVJP node), and the whole calls.  µs per call."""
    from repro_torch import nn
    from repro_torch.kernels import build, fused_mlp as fm, ops, ref
    from repro_torch.kernels.vjp import PlainVJP

    g0 = torch.Generator().manual_seed(5)
    x, *w = _mlp_operands(g0, dev, torch.float32, 1024, 17, 32, 16)
    g = torch.randn(1024, 16, generator=g0).to(dev)
    xg, *wg = (t.detach().requires_grad_() for t in (x, *w))
    params = {"layers": [{"w": w[0], "b": w[1]}, {"w": w[2], "b": w[3]}]}
    lib = build.load()
    idx = dev.index or 0
    stream = fm._stream(idx)
    out = torch.empty(1024, 16, device=dev)
    args = (0, x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
            w[3].data_ptr(), out.data_ptr(), 1024, 17, 32, 16, stream)
    pieces = {
        "checks (check_operands)": lambda: fm.check_operands(x, *w),
        "output: x.new_empty": lambda: x.new_empty((1024, 16)),
        "output: torch.empty(shape, dtype, device) (parent)":
            lambda: torch.empty((1024, 16), dtype=torch.float32, device=x.device),
        "stream: raw handle": lambda: fm._stream(idx),
        "stream: torch.cuda.current_stream(dev).cuda_stream (parent)":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "device guard": lambda: build.device_guard(idx).__enter__(),
        "ctypes: the twelve-argument call (+ kernel enqueue)": lambda: lib.rt_fused_mlp(*args),
        "x.data_ptr() x6": lambda: (x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                   x.data_ptr(), x.data_ptr()),
        "x.contiguous() (nn/core.py)": lambda: x.contiguous(),
        "_launch (no checks, no node)": lambda: fm._launch(x, *w),
        "fused_mlp, no node (no input requires grad)": lambda: fm.fused_mlp(x, *w),
        "fused_mlp, MLPFunction node (inputs require grad)": lambda: fm.fused_mlp(xg, *wg),
        "PlainVJP node around _launch (parent's node)":
            lambda: PlainVJP.apply(fm._launch, ref.fused_mlp, {}, xg, *wg),
        "ops.fused_mlp (dispatch), no node": lambda: ops.fused_mlp(x, *w),
        "nn.mlp (a field's whole call), no node": lambda: nn.mlp(params, x),
        "backward: its five outputs, torch.empty_like each":
            lambda: [torch.empty_like(t) for t in (x, *w)],
        "backward: _launch_bwd": lambda: fm._launch_bwd(x, *w, g),
        "backward: the plain VJP (parent)": lambda: _plain_vjp_mlp(x, w, g),
    }
    costs = {name: host_us(fn) for name, fn in pieces.items()}
    for name, us in costs.items():
        print(f"launcher host cost: {name}: {us:.2f} us", flush=True)
    return costs


def identity_checks(ops, dev) -> None:
    """Phase 4: ΔW and fused/unfused identities inside the port, bitwise."""
    from repro_torch.core.brownian import BrownianPath
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init, latent_sde_sample_paths
    from repro_torch.kernels import prng

    g = torch.Generator().manual_seed(99)
    for dtype in (torch.float32, torch.float64):
        keys = torch.randint(0, 2 ** 32, (1024, 2), generator=g, dtype=torch.int64).to(dev)
        z = torch.randn(1024, 16, generator=g, dtype=dtype).to(dev)
        bm = BrownianPath(keys, 0.0, 1.0, (16,), dtype)
        for n in (0, 7, 22):
            _, w_gen = ops.rev_heun_phase1_gen(z, z, z, z, keys, n, 1.0 / 23, 1.0 / 23)
            w_inc = bm.increment(n, 23)
            w_plain = bm.increment(n, 23, use_kernel=False)
            check(torch.equal(w_gen, w_inc) and torch.equal(w_inc, w_plain),
                  f"ΔW identity broken ({dtype}, n={n})")
        base = dict(data_dim=2, hidden_dim=16, context_dim=16, initial_noise_dim=8,
                    width=32, depth=1, num_steps=23, t1=1.0, dtype=dtype)
        params = latent_sde_init(torch.Generator().manual_seed(5),
                                 LatentSDEConfig(**base), device=dev)
        k = torch.stack(prng.fold_in(7, 11, torch.arange(1024)), -1).to(dev)
        fused = latent_sde_sample_paths(params, LatentSDEConfig(**base, use_pallas_kernels=True), k)
        unfused = latent_sde_sample_paths(params, LatentSDEConfig(**base), k)
        check(torch.equal(fused, unfused), f"fused decode != unfused decode ({dtype})")
    print("identities: ΔW(phase1_gen) == ΔW(brownian_increment) == plain "
          "BrownianPath.increment; fused decode == unfused decode "
          "(float32, float64, bitwise)", flush=True)


def _grads(loss_fn, params, cfg, key, ys):
    """ELBO gradients w.r.t. every parameter leaf."""
    from repro_torch import tree

    leaves, spec = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = loss_fn(tree.unflatten(spec, leaves), cfg, key, ys)
    return torch.autograd.grad(loss, leaves)


def adjoint_checks(dev) -> None:
    """Phase 5: fused exact adjoint == unfused (bitwise) and exact adjoint ==
    discretise (<= ADJOINT_RTOL relative), float64, training widths, B = 64."""
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init, latent_sde_loss
    from repro_torch.data import air_quality_like
    from repro_torch.kernels import prng

    cfg = LatentSDEConfig(**WIDTHS, kl_weight=0.1, dtype=torch.float64)
    params = latent_sde_init(torch.Generator().manual_seed(7), cfg, device=dev)
    key = prng.PRNGKey(8, device=dev)
    ys, _ = air_quality_like(prng.fold_in_key(key, 0), 64, SEQ_LEN, dtype=torch.float64)
    k = prng.fold_in_key(key, 1)
    unfused = _grads(latent_sde_loss, params, cfg, k, ys)
    fused = _grads(latent_sde_loss, params,
                   dataclasses.replace(cfg, use_pallas_kernels=True), k, ys)
    dto = _grads(latent_sde_loss, params,
                 dataclasses.replace(cfg, gradient_mode="discretise"), k, ys)
    torch.cuda.synchronize()
    diff = max((a - b).abs().max().item() for a, b in zip(fused, unfused))
    check(all(torch.equal(a, b) for a, b in zip(fused, unfused)),
          f"fused exact adjoint != unfused (max |Δ| {diff})")
    rel = (sum((a - b).abs().sum().item() for a, b in zip(unfused, dto))
           / sum(b.abs().sum().item() for b in dto))
    check(rel <= ADJOINT_RTOL, f"exact adjoint vs discretise: relative error {rel}")
    print(f"adjoint (float64, B=64, 23 steps): fused == unfused bitwise; exact vs "
          f"discretise relative error {rel:.3g} (<= {ADJOINT_RTOL})", flush=True)


def train_checks(ops, dev, label: str) -> dict:
    """Phase 6: the training main path through train_latent_sde, fused and
    unfused; the train -> serve handshake; steps/s and the device profile.
    Returns the fused run's launch counts and the device kernels of one
    step (with the backward kernel, the PlainVJP node, the layer loop)."""
    from repro_torch import tree
    from repro_torch.launch.train import train_latent_sde
    from repro_torch.serving import serve_sde

    runs, launches = {}, None
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        for variant, fused in (("fused", True), ("unfused", False)):
            if fused:
                ops.reset_launch_counts()
            params, losses = train_latent_sde(3, 64, tmp if fused else None, seed=11,
                                              log_every=1, use_pallas=fused)
            torch.cuda.synchronize()
            if fused:
                launches = ops.launch_counts()
            runs[variant] = (params, losses)
            print(f"[{label}] train {variant}: -ELBO {losses}", flush=True)
        served = serve_sde("latent-sde", tmp, max_batch=64, requests=4, request_max=16,
                           seed=12, collect=True)
    print(f"[{label}] training-path launches (3 fused steps): {launches}", flush=True)
    for name, per_step in STEP_LAUNCHES.items():
        check(launches[name] == 3 * per_step,
              f"{name}: {launches[name]} launches in 3 fused steps, expected {3 * per_step}")
    for variant, (_, losses) in runs.items():
        check(all(map(math.isfinite, losses)), f"train {variant}: non-finite -ELBO {losses}")
    check(runs["fused"][1] == runs["unfused"][1], "fused and unfused -ELBO differ")
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(runs["fused"][0]),
                                                   tree.leaves(runs["unfused"][0])))
    check(same, "fused and unfused parameters differ after 3 steps")
    for rid, ys in served["samples"].items():
        check(ys.shape[0] == 24 and ys.shape[2] == 2 and torch.isfinite(ys).all().item(),
              f"trained bundle, request {rid}: bad trajectory {tuple(ys.shape)}")
    print(f"train -> serve: the fused run's bundle served {served['trajectories']} "
          f"trajectories (finite, (24, n, 2)); fused == unfused parameters bitwise",
          flush=True)
    kernels = [step_rate(dev, batch, label) for batch in (64, 1024)][0]
    return dict(launches, device_kernels=kernels)


def _train_step(dev, batch: int, fused: bool = True, num_steps: int = 23,
                gradient_mode=None, solver: str = "reversible_heun", adjoint: str = "exact",
                precision: str = "highest"):
    """``run()`` takes one ELBO step at the training widths (float32) from
    fresh parameters, ``adjoint``, ``solver`` and ``precision`` as
    train_latent_sde takes them."""
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init
    from repro_torch.kernels import prng
    from repro_torch.launch.steps import make_latent_sde_optimizer, make_latent_sde_step

    cfg = LatentSDEConfig(**{**WIDTHS, "num_steps": num_steps}, kl_weight=0.1,
                          use_pallas_kernels=fused, gradient_mode=gradient_mode, solver=solver,
                          exact_adjoint=adjoint == "exact" and solver == "reversible_heun",
                          precision=precision)
    params = latent_sde_init(torch.Generator().manual_seed(13), cfg, device=dev)
    init, update = make_latent_sde_optimizer()
    step = make_latent_sde_step(cfg, update, batch, SEQ_LEN, adjoint=adjoint, device=dev)
    key = prng.PRNGKey(14, device=dev)
    state = init(params)
    return lambda: step(params, state, key)


def step_rate(dev, batch: int, label: str):
    """Steps/s of the fused and the unfused step, taken in turns (fused,
    unfused, unfused, fused, ...; host clock around synchronised steps), and
    one step of each under the profiler."""
    runs = {"fused": _train_step(dev, batch), "unfused": _train_step(dev, batch, fused=False)}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    walls = {variant: [] for variant in runs}
    for i in range(6):
        for variant in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
            t0 = time.perf_counter()
            runs[variant]()
            torch.cuda.synchronize()
            walls[variant].append(time.perf_counter() - t0)
    for variant, w in walls.items():
        wall = statistics.median(w)
        print(f"[{label}] train step B={batch} ({variant}, float32, 23 steps): "
              f"{1 / wall:.2f} steps/s (median of 6 in turns: {wall * 1e3:.1f} ms; "
              f"all {', '.join(f'{x * 1e3:.1f}' for x in w)} ms)", flush=True)
    for variant, run in runs.items():
        profile_call(run, f"{label}] [train {variant} B={batch}")
    if batch == 64:
        return compare_kernels(runs["fused"], label, "ELBO step (fused, B=64)")
    return None


def _terminal_grad(dev, num_steps: int, gradient_mode: str, solver: str = "reversible_heun",
                   dtype=torch.float32, precision: str = "highest"):
    """``run()`` takes the gradient of the terminal-form ELBO at the training
    widths, batch 64 (the exact adjoint fused), from the same parameters
    and data at every call."""
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init, latent_sde_loss_terminal
    from repro_torch.data import air_quality_like
    from repro_torch.kernels import prng

    cfg = LatentSDEConfig(**{**WIDTHS, "num_steps": num_steps}, kl_weight=0.1,
                          use_pallas_kernels=gradient_mode == "reversible_adjoint",
                          gradient_mode=gradient_mode, solver=solver, precision=precision,
                          dtype=dtype)
    params = latent_sde_init(torch.Generator().manual_seed(13), cfg, device=dev)
    key = prng.PRNGKey(14, device=dev)
    ys, _ = air_quality_like(prng.fold_in_key(key, 0), 64, SEQ_LEN, dtype=dtype)
    return lambda: _grads(latent_sde_loss_terminal, params, cfg, prng.fold_in_key(key, 1), ys)


def memory_checks(dev, label: str) -> None:
    """Phase 7: peak allocated memory of one training step (trajectory form)
    and of one terminal-form gradient, exact adjoint vs discretise, at 23 and
    230 solver steps (24 observations)."""
    forms = {"step": lambda mode, n: _train_step(dev, 64, fused=mode == "reversible_adjoint",
                                                 num_steps=n, gradient_mode=mode),
             "terminal": lambda mode, n: _terminal_grad(dev, n, mode)}
    for form, make in forms.items():
        peaks = {}
        for mode in ("reversible_adjoint", "discretise"):
            for n in (23, 230):
                run = make(mode, n)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run()
                torch.cuda.synchronize()
                peaks[(mode, n)] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                print(f"[{label}] memory ({form}): {mode} N={n}: peak "
                      f"{peaks[(mode, n)]:.2f} MiB above the {base / 2 ** 20:.2f} MiB "
                      f"held before", flush=True)
        exact, dto = [peaks[("reversible_adjoint", n)] for n in (23, 230)], \
            [peaks[("discretise", n)] for n in (23, 230)]
        check(exact[1] <= 1.5 * exact[0], f"{form}: exact adjoint's peak grew with N: "
                                           f"{exact} MiB")
        # discretise keeps every step's residuals, so its peak grows with N
        # at least 3x as fast as the exact adjoint's (whose growth in the
        # trajectory form is the O(N) trajectory and its cotangent), and by
        # at least 3 MiB from N = 23 to 230 (~73 KB a step at batch 64).
        grown = dto[1] - dto[0]
        check(grown >= 3 * max(exact[1] - exact[0], 1.0),
              f"{form}: discretise's peak grew {grown:.2f} MiB with N ({dto} MiB), not 3x "
              f"the exact adjoint's growth ({exact} MiB) and at least 3 MiB")


def baseline_checks(ops, dev, label: str) -> dict:
    """Phase 11c: the paper's baselines through the train CLI's entry points
    (launch counts, finite losses), their float64 gradients against
    discretise, the bf16 policy's shift, peak memory at N = 23 and 230, and
    one step of each timed in turns against the exact fused step.  Returns
    the launches of step 3 of each variant and the timings."""
    from repro_torch.launch.train import train_latent_sde, train_sde_gan

    never = 10 ** 9  # log_every: the sig-MMD log at step 0 only
    launches = {}
    for tag, kw in BASELINE_VARIANTS.items():
        want = BASELINE_STEP_LAUNCHES.get(tag, STEP_LAUNCHES)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-baseline-") as tmp:
            for k in (1, 2, 3):  # one step a call, each resuming the last
                ops.reset_launch_counts()
                _, losses = train_latent_sde(k, 64, tmp, ckpt_every=1, seed=11,
                                             log_every=never, device=dev, **kw)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                _check_gan_launches(counts, want, f"{tag} ELBO step {k}")
                check(len(losses) == 1 and math.isfinite(losses[0]),
                      f"{tag} ELBO step {k}: -ELBO {losses}")
                print(f"[{label}] baseline {tag} step {k} (train_latent_sde resuming from "
                      f"step {k - 1}): -ELBO {losses[0]:.6f}", flush=True)
        launches[tag] = counts
    with tempfile.TemporaryDirectory(prefix="chip-smoke-baseline-gan-") as tmp:
        for k in (1, 2, 3):
            ops.reset_launch_counts()
            _, hist = train_sde_gan(k, GAN_BATCHES[0], tmp, ckpt_every=1, seed=GAN_SEED,
                                    log_every=never, constraint="gp", solver="midpoint",
                                    device=dev)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            want = dict(GP_MIDPOINT_STEP_LAUNCHES)
            if k == 1:  # the sig-MMD log of step 0
                want = {n: want[n] + GP_MIDPOINT_LOG_LAUNCHES[n] for n in want}
            _check_gan_launches(counts, want, f"sde-gan gp/midpoint step {k}")
            rec = hist[0]
            check(all(math.isfinite(v) for n, v in rec.items() if n != "step"),
                  f"sde-gan gp/midpoint step {k}: not finite {rec}")
            print(f"[{label}] baseline sde-gan gp/midpoint step {k} (B={GAN_BATCHES[0]}): "
                  f"{rec}", flush=True)
    launches["sde-gan gp/midpoint"] = counts
    print(f"[{label}] baseline launches per step: {launches}; every other kernel 0",
          flush=True)

    # float64, batch 64: checkpoint == discretise, backsolve's O(√h) error, bf16
    readings = {}
    f64 = torch.float64
    for solver in ("midpoint", "reversible_heun"):
        ck = _terminal_grad(dev, 23, "checkpoint", solver, f64)()
        dto = _terminal_grad(dev, 23, "discretise", solver, f64)()
        rel = _rel_err(ck, dto)
        readings[f"checkpoint vs discretise, {solver}"] = rel
        check(rel <= CHECKPOINT_ERR_GATE,
              f"{solver}: checkpoint vs discretise relative error {rel} > "
              f"{CHECKPOINT_ERR_GATE}")
    for n in (23, 230):
        otd = _terminal_grad(dev, n, "continuous_adjoint", "midpoint", f64)()
        dto = _terminal_grad(dev, n, "discretise", "midpoint", f64)()
        readings[f"backsolve vs discretise, midpoint N={n}"] = _rel_err(otd, dto)
    for solver, mode in (("reversible_heun", "reversible_adjoint"), ("midpoint", "checkpoint")):
        hi = _terminal_grad(dev, 23, mode, solver, f64)()
        lo = _terminal_grad(dev, 23, mode, solver, f64, precision="bf16_compute")()
        shift = _rel_err(lo, hi)
        readings[f"bf16_compute vs highest, {solver} {mode}"] = shift
        check(all(g.dtype == torch.float64 and torch.isfinite(g).all().item() for g in lo)
              and BF16_SHIFT_BOUNDS[0] < shift < BF16_SHIFT_BOUNDS[1],
              f"bf16_compute ({solver} {mode}): shift {shift} outside {BF16_SHIFT_BOUNDS}")
    torch.cuda.synchronize()
    print(f"[{label}] baselines float64 B=64, relative L1 of the ELBO gradients: "
          f"{readings} (checkpoint gate {CHECKPOINT_ERR_GATE}, bf16 bounds "
          f"{BF16_SHIFT_BOUNDS}; backsolve's is a reading)", flush=True)

    # peak memory of one terminal-form gradient, float32, batch 64
    peaks = {}
    for solver, mode in (("midpoint", "checkpoint"), ("reversible_heun", "checkpoint"),
                         ("midpoint", "continuous_adjoint"), ("midpoint", "discretise")):
        for n in (23, 230):
            run = _terminal_grad(dev, n, mode, solver)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            peaks[f"{solver}/{mode} N={n}"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"[{label}] baselines memory (one terminal-form gradient, B=64): peak "
          f"{ {k: round(v, 3) for k, v in peaks.items()} } MiB above what was held before",
          flush=True)
    for what in ("midpoint/checkpoint", "reversible_heun/checkpoint",
                 "midpoint/continuous_adjoint"):
        lo, hi = peaks[f"{what} N=23"], peaks[f"{what} N=230"]
        check(hi <= 1.5 * lo, f"{what}: peak grew {lo:.3f} -> {hi:.3f} MiB from N=23 to 230")

    # one step of each, in turns against the exact fused step
    runs = {"exact fused": _train_step(dev, 64)}
    for tag, kw in BASELINE_VARIANTS.items():
        kw = dict(kw)
        runs[tag] = _train_step(dev, 64, fused=kw.pop("use_pallas", False), **kw)
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    walls = {v: [] for v in runs}
    for i in range(4):
        for v in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[v]()
            torch.cuda.synchronize()
            walls[v].append(time.perf_counter() - t0)
    med = {v: statistics.median(w) * 1e3 for v, w in walls.items()}
    timing = {v: dict(ms=med[v], over_exact=med[v] / med["exact fused"],
                      walls_ms=[w * 1e3 for w in walls[v]]) for v in runs}
    print(f"[{label}] baseline ELBO steps (B=64, float32, 23 steps; medians of 4 in turns): "
          + ", ".join(f"{v} {t['ms']:.1f} ms ({t['over_exact']:.3f}x exact)"
                      for v, t in timing.items()), flush=True)
    return dict(launches=launches, timing=timing, peak_mib=peaks, readings=readings)


def st_increment_bound(rows: int, d: int, dtype) -> tuple:
    """Least time for ``space_time_increment``: a row's fold_in and split
    (3 hashes), a hash per counter pair of each of the two draws (float32
    pairs two elements), two normals and two scalings an element; bytes:
    keys in, W and H out."""
    s = torch.finfo(dtype).bits // 8
    n = rows * d
    per_pair = 0.5 if dtype == torch.float32 else 1.0
    ops_ = rows * 3 * HASH_OPS + n * 2 * (per_pair * HASH_OPS + NORMAL_OPS[dtype] + 1)
    t_bytes = (rows * 16 + 2 * n * s) / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def st_value_bound(rows: int, d: int, depth: int, dtype) -> tuple:
    """Least time for ``space_time_value`` by throughput: a row's root
    fold_in and split and, a level, the chain fold_in, the midpoint key's
    fold_in and its split (3 + 4·depth hashes); an element's 2·(depth + 1)
    normals (float32 pairs share a hash), ~16 operations a level and ~20
    for the tail; bytes: keys and times in, W and I out.  The chain of
    depth + 1 dependent hashes a row is a latency floor beside it, as for
    ``brownian_value``."""
    s = torch.finfo(dtype).bits // 8
    n = rows * d
    per_pair = 0.5 if dtype == torch.float32 else 1.0
    ops_ = (rows * (3 + 4 * depth) * HASH_OPS
            + n * 2 * (depth + 1) * (per_pair * HASH_OPS + NORMAL_OPS[dtype])
            + n * (16 * depth + 20))
    t_bytes = (rows * (16 + s) + 2 * n * s) / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _st_times(g, rows: int, dtype, dev):
    """The rows' query times: t0, t1 and a dyadic point first, the rest
    random (one row: each of those in turn)."""
    rand = torch.rand(max(rows, 2), generator=g, dtype=torch.float64).tolist()
    if rows == 1:
        return [torch.tensor([v], dtype=dtype, device=dev) for v in (0.0, 1.0, 0.375, rand[0])]
    tl = [[0.0, 1.0, 0.375][r] if r < 3 else rand[r] for r in range(rows)]
    return [torch.tensor(tl, dtype=dtype, device=dev)]


def _same(got, want) -> tuple:
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    return all(torch.equal(a, b) for a, b in zip(got, want)) and err == 0.0, err


def _same_nan(got, want) -> tuple:
    """``_same`` where NaN equals NaN: ``(alike, max |Δ| off the NaNs, NaNs)``.
    A float32 descent past ~150 levels from t0 underflows the interval's
    length to 0 and divides by it, in the plain version as in the kernel."""
    nan = [a.isnan() for a in want]
    alike = all(torch.equal(a.isnan(), m) and torch.equal(a[~m], b[~m])
                for a, b, m in zip(got, want, nan))
    err = max(((a - b)[~m].abs().max().item() if (~m).any() else 0.0)
              for a, b, m in zip(got, want, nan))
    return alike, err, sum(int(m.sum()) for m in nan)


def st_kernel_checks(ops, dev) -> tuple:
    """The two space-time kernels bitwise against their plain versions, two
    launches alike, a row's bits independent of the rows beside it; timed
    at the srk ELBO's draws (one key over 64 x 17, float32) and the adaptive
    srk gradient's queries (one key over 256 x 32, float64, depth 10).
    Returns ``({name: row}, {name: max |Δ|})``."""
    g = torch.Generator().manual_seed(2525)
    errs = {"space_time_increment": 0.0, "space_time_value": 0.0}
    n_calls = 0
    sizes = [(rows, (d,)) for rows in LEVY_ROWS for d in LEVY_SIZES] + LEVY_ONE_KEY
    for dtype in (torch.float32, torch.float64):
        for rows, shape in sizes:
            keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g,
                                 dtype=torch.int64).to(dev)
            inc = lambda uk: ops.space_time_increment(keys, 7, shape, dtype, 1.0 / 23,
                                                      use_kernel=uk)
            got, again, want = inc(True), inc(True), inc(False)
            torch.cuda.synchronize()
            same, e = _same(got, want)
            check(same and _same(got, again)[0],
                  f"space_time_increment {dtype} rows={rows} {shape}: kernel != plain "
                  f"(max |Δ| {e}) or two launches differ")
            errs["space_time_increment"] = max(errs["space_time_increment"], e)
            if rows == 1024:  # row 5 alone, against its row of the 1024
                one = ops.space_time_increment(keys[5:6].contiguous(), 7, shape, dtype,
                                               1.0 / 23)
                check(all(torch.equal(a[0], b[5]) for a, b in zip(one, got)),
                      f"space_time_increment {dtype} {shape}: row 5 differs at 1 vs 1024 rows")
            n_calls += 1
            for depth in LEVY_DEPTHS:
                for t in _st_times(g, rows, dtype, dev):
                    val = lambda uk: ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype,
                                                          depth, use_kernel=uk)
                    got, again, want = val(True), val(True), val(False)
                    torch.cuda.synchronize()
                    same, e = _same(got, want)
                    check(same and _same(got, again)[0],
                          f"space_time_value {dtype} rows={rows} {shape} depth={depth}: "
                          f"kernel != plain (max |Δ| {e}) or two launches differ")
                    errs["space_time_value"] = max(errs["space_time_value"], e)
                    if rows == 1024:
                        one = ops.space_time_value(keys[5:6].contiguous(), t[5:6].contiguous(),
                                                   0.0, 1.0, shape, dtype, depth)
                        check(all(torch.equal(a[0], b[5]) for a, b in zip(one, got)),
                              f"space_time_value {dtype} {shape} depth={depth}: row 5 "
                              f"differs at 1 vs 1024 rows")
                    n_calls += 1
            torch.cuda.empty_cache()
    # past the ring of levels: the adaptive srk gradient's key over (256, 32)
    # and 1024 rows of 32, at depths 100 and 512 (NaN where the plain version
    # has NaN, at the same places)
    deep_nans = 0
    for dtype in (torch.float32, torch.float64):
        for rows, shape in LEVY_DEEP_SIZES:
            keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g,
                                 dtype=torch.int64).to(dev)
            for depth in LEVY_DEEP:
                for t in _st_times(g, rows, dtype, dev):
                    val = lambda uk: ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype,
                                                          depth, use_kernel=uk)
                    got, again, want = val(True), val(True), val(False)
                    torch.cuda.synchronize()
                    same, e, nans = _same_nan(got, want)
                    check(same and _same_nan(got, again)[0],
                          f"space_time_value {dtype} rows={rows} {shape} depth={depth}: "
                          f"kernel != plain (max |Δ| {e}, {nans} NaN in the plain version) "
                          f"or two launches differ")
                    errs["space_time_value"] = max(errs["space_time_value"], e)
                    deep_nans += nans
                    if rows == 1024:
                        one = ops.space_time_value(keys[5:6].contiguous(), t[5:6].contiguous(),
                                                   0.0, 1.0, shape, dtype, depth)
                        check(_same_nan([a[0] for a in one], [b[5] for b in got])[0],
                              f"space_time_value {dtype} {shape} depth={depth}: row 5 "
                              f"differs at 1 vs 1024 rows")
                    n_calls += 1
                torch.cuda.empty_cache()
    print(f"bitwise: space_time_increment and space_time_value x {{float32, float64}} x "
          f"(rows, shape) in {sizes} x depth {LEVY_DEPTHS}, and space_time_value at "
          f"{LEVY_DEEP_SIZES} x depth {LEVY_DEEP} ({n_calls} cases, t0/t1/dyadic/random "
          f"times): kernel == plain, two launches alike, rows independent ({deep_nans} "
          f"elements NaN in both at the deep depths)", flush=True)
    timed = {}
    keys1 = torch.randint(0, 2 ** 32, (1, 2), generator=g, dtype=torch.int64).to(dev)
    key0 = keys1[0].contiguous()
    shape, dtype = (64, 17), torch.float32
    call = lambda uk: ops.space_time_increment(key0, 7, shape, dtype, 1.0 / 23, use_kernel=uk)
    k_ms, k_host = time_ms(lambda: call(True))
    p_ms, p_host = time_ms(lambda: call(False), reps=5, trials=3)
    b_ms, b_by = st_increment_bound(1, math.prod(shape), dtype)
    timed["space_time_increment"] = dict(ms=k_ms, host_ms=k_host, plain_ms=p_ms,
                                         plain_host_ms=p_host, bound_ms=b_ms, bound_by=b_by,
                                         span_us=span_us(lambda: call(True)),
                                         shape=[1, *shape], dtype="float32")
    shape, dtype, depth = (256, 32), torch.float64, 10
    t = torch.tensor([0.4375], dtype=dtype, device=dev)
    call = lambda uk: ops.space_time_value(keys1, t, 0.0, 1.0, shape, dtype, depth,
                                           use_kernel=uk)
    k_ms, k_host = time_ms(lambda: call(True))
    p_ms, p_host = time_ms(lambda: call(False), reps=5, trials=3)
    b_ms, b_by = st_value_bound(1, math.prod(shape), depth, dtype)
    d24_ms = time_ms(lambda: ops.space_time_value(keys1, t, 0.0, 1.0, shape, dtype, 24))[0]
    timed["space_time_value"] = dict(
        ms=k_ms, host_ms=k_host, plain_ms=p_ms, plain_host_ms=p_host, bound_ms=b_ms,
        bound_by=b_by, shape=[1, *shape], dtype="float64", depth=depth, depth24_ms=d24_ms,
        depth24_bound_ms=st_value_bound(1, math.prod(shape), 24, dtype)[0])
    for name, r in timed.items():
        print(f"{name} {r['dtype']} {r['shape']}: kernel {r['ms']:.5f} ms "
              f"({r['host_ms']:.5f} host), plain {r['plain_ms']:.5f} ms "
              f"({r['plain_host_ms']:.5f}), bound {r['bound_ms']:.7f} ms ({r['bound_by']})"
              + (f"; span {r['span_us']:.3f} us" if "span_us" in r else "")
              + (f"; depth 24: {r['depth24_ms']:.5f} ms, bound {r['depth24_bound_ms']:.7f}"
                 if "depth24_ms" in r else ""), flush=True)
    return timed, errs


def _dispatched(fn) -> tuple:
    """What one call of ``fn`` (after a first, warming call) dispatches:
    ``(aten ops with a CUDA output, the port's kernel launches by name)`` —
    counts of the code alone, unlike the profiler's device events, which
    moved between processes on unchanged code (1046 / 1050 / 1065 for one
    Dense-path sample)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.kernels import ops

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_flatten(out)[0]):
                _Count.n += 1
            return out

    fn()
    torch.cuda.synchronize()
    before = ops.launch_counts()
    with _Count():
        fn()
    after = ops.launch_counts()
    return _Count.n, {k: n - before[k] for k, n in after.items() if n != before[k]}


def _device_kernels(fn) -> int:
    """Device kernels and copies of one call of ``fn`` under torch.profiler
    (None if the profiler recorded no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return n or None


def srk_order_checks(dev, label: str) -> dict:
    """benchmarks/convergence.py:srk_frontier at its tiny preset, on the
    card: srk on a float64 space-time Dense path against the pathwise-exact
    GBM terminal value, reversible Heun on the path's own W (the
    Stratonovich drift); the slope gate and the per-NFE crossing asserts are
    the reference's."""
    from repro_torch.core import DenseBrownianPath, sde_solve, solve
    from repro_torch.kernels import prng

    f64 = torch.float64
    key = prng.PRNGKey(11, device=dev)
    sample = lambda fine: DenseBrownianPath.sample(key, 0.0, 1.0, fine, (SRK_PATHS, 1), f64,
                                                   levy_area="space-time")
    dispatched = {fine: _dispatched(lambda: sample(fine)) for fine in (256, SRK_FINE)}
    kernels = {fine: _device_kernels(lambda: sample(fine)) for fine in (256, SRK_FINE)}
    bm_st = sample(SRK_FINE)
    bm = DenseBrownianPath(bm_st.w, 0.0, 1.0)  # the same W, bitwise, no H
    w_t, _ = bm_st.value(1.0)
    exact = torch.exp((SRK_MU - 0.5 * SRK_SIGMA ** 2) + SRK_SIGMA * w_t)[..., 0]
    y0 = torch.ones((SRK_PATHS, 1), dtype=f64, device=dev)
    ito = lambda p, t, z: SRK_MU * z
    strat = lambda p, t, z: (SRK_MU - 0.5 * SRK_SIGMA ** 2) * z
    diffusion = lambda p, t, z: SRK_SIGMA * z
    err = lambda zT: (zT[..., 0] - exact).abs().mean().item()
    srk_err = [err(solve(ito, diffusion, None, y0, bm_st, 0.0, 1.0, n, solver="srk",
                         save_trajectory=False)) for n in SRK_GRIDS]
    heun_err = [err(sde_solve(strat, diffusion, None, y0, bm, 0.0, 1.0, n,
                              solver="reversible_heun", save_trajectory=False))
                for n in SRK_HEUN_GRIDS]
    x = [math.log(n) for n in SRK_GRIDS]
    y = [math.log(e) for e in srk_err]
    mx, my = statistics.fmean(x), statistics.fmean(y)
    slope = -sum((a - mx) * (b - my) for a, b in zip(x, y)) / sum((a - mx) ** 2 for a in x)
    srk_nfe = [5 * n for n in SRK_GRIDS]
    heun_nfe = list(SRK_HEUN_GRIDS)
    lo, hi = max(srk_nfe[0], heun_nfe[0]), min(srk_nfe[-1], heun_nfe[-1])

    def at(nfe, nfes, errs_):  # log-log interpolation
        lx = [math.log(v) for v in nfes]
        ly = [math.log(v) for v in errs_]
        q = math.log(nfe)
        for i in range(len(lx) - 1):
            if lx[i] <= q <= lx[i + 1]:
                f = (q - lx[i]) / (lx[i + 1] - lx[i])
                return ly[i] + f * (ly[i + 1] - ly[i])
        return ly[0] if q < lx[0] else ly[-1]

    coarse = at(lo, srk_nfe, srk_err) - at(lo, heun_nfe, heun_err)
    fine = at(hi, srk_nfe, srk_err) - at(hi, heun_nfe, heun_err)
    print(f"[{label}] srk strong order (GBM, {SRK_PATHS} paths, Dense {SRK_FINE} cells, "
          f"float64): slope {slope:.4f} over n {SRK_GRIDS} (gate {SRK_SLOPE}); srk errors "
          f"{[f'{e:.3e}' for e in srk_err]} at NFE {srk_nfe}; reversible Heun "
          f"{[f'{e:.3e}' for e in heun_err]} at NFE {heun_nfe}; log(srk/heun) at NFE {lo} "
          f"{coarse:+.3f}, at {hi} {fine:+.3f}; one DenseBrownianPath.sample (space-time) "
          f"dispatches (aten ops with CUDA outputs, the port's launches) {dispatched}; "
          f"device kernels under the profiler (a reading) {kernels}", flush=True)
    check(SRK_SLOPE[0] <= slope <= SRK_SLOPE[1],
          f"srk strong order {slope:.4f} outside {SRK_SLOPE}")
    check(coarse > 0, f"reversible Heun must be more accurate per NFE at NFE {lo}")
    check(fine < 0, f"srk must be more accurate per NFE at NFE {hi}")
    check(dispatched[256] == dispatched[SRK_FINE],
          f"DenseBrownianPath.sample's dispatched ops or launches grow with the cells: "
          f"{dispatched}")
    return dict(slope=slope, srk_err=srk_err, heun_err=heun_err, sample_kernels=kernels,
                sample_dispatched=dispatched)


def _srk_adaptive(dev, depth: int):
    """The burst of phase 11 under srk, float64, on a space-time path at
    bridge depth ``depth``: ``(forward z_T, stats, run())``, ``run()`` the
    checkpointed gradient ``(z_T, grads)`` of mean(z_T²)."""
    from repro_torch.core import solve, solve_adaptive
    from repro_torch import tree

    f64 = torch.float64
    drift, diffusion, params, z0 = _burst(dev, f64)
    bm = dataclasses.replace(_burst_path(dev, f64), levy_area="space-time")
    kw = dict(solver="srk", rtol=BURST["rtol"], atol=BURST["atol"],
              max_steps=BURST["max_steps"], bridge_depth=depth)
    z, stats = solve_adaptive(drift, diffusion, params, z0, bm, 0.0, 1.0, dt0=1 / 16, **kw)

    def run():
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        zT = solve(drift, diffusion, tree.unflatten(spec, leaves), z0, bm, 0.0, 1.0, 16,
                   gradient_mode="checkpoint", save_trajectory=False, adaptive=True, **kw)
        return zT.detach(), torch.autograd.grad((zT * zT).mean(), leaves)

    return z, stats, bm, run


def levy_checks(ops, dev, label: str) -> dict:
    """Phase 11d: the space-time kernels, the srk strong-order gate, the srk
    ELBO step through ``train_latent_sde``, the adaptive srk gradient and
    the Brownian Interval on the card.  Returns the kernels' timings and
    errors and each srk path's launches."""
    from repro_torch.core import BrownianInterval, VirtualBrownianTree
    from repro_torch.kernels import prng
    from repro_torch.launch.train import train_latent_sde

    timed, errs = st_kernel_checks(ops, dev)
    order = srk_order_checks(dev, label)

    never = 10 ** 9
    launches = {}
    for tag, kw in SRK_VARIANTS.items():
        with tempfile.TemporaryDirectory(prefix="chip-smoke-srk-") as tmp:
            for k in (1, 2, 3):  # one step a call, each resuming the last
                ops.reset_launch_counts()
                _, losses = train_latent_sde(k, 64, tmp, ckpt_every=1, seed=11,
                                             log_every=never, device=dev, **kw)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                _check_gan_launches(counts, SRK_STEP_LAUNCHES[tag], f"{tag} ELBO step {k}")
                check(len(losses) == 1 and math.isfinite(losses[0]),
                      f"{tag} ELBO step {k}: -ELBO {losses}")
                print(f"[{label}] {tag} step {k} (train_latent_sde resuming from step "
                      f"{k - 1}): -ELBO {losses[0]:.6f}", flush=True)
        launches[tag] = counts
    runs = {"exact fused": _train_step(dev, 64)}
    for tag, kw in SRK_VARIANTS.items():
        runs[tag] = _train_step(dev, 64, fused=False, **kw)
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    walls = {v: [] for v in runs}
    for i in range(4):
        for v in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[v]()
            torch.cuda.synchronize()
            walls[v].append(time.perf_counter() - t0)
    med = {v: statistics.median(w) * 1e3 for v, w in walls.items()}
    timing = {v: dict(ms=med[v], over_exact=med[v] / med["exact fused"]) for v in runs}
    print(f"[{label}] srk ELBO steps (B=64, float32, 23 steps; medians of 4 in turns, a "
          f"reading): " + ", ".join(f"{v} {t['ms']:.1f} ms ({t['over_exact']:.3f}x exact)"
                                      for v, t in timing.items()), flush=True)

    adaptive = {}
    for depth in (10, 24):
        z, stats, bm, run = _srk_adaptive(dev, depth)
        check(bool(stats.converged), f"adaptive srk depth {depth}: not converged")
        attempts = int(stats.num_accepted) + int(stats.num_rejected)
        ops.reset_launch_counts()
        zT, grads = run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(all(torch.isfinite(g).all().item() for g in grads),
              f"adaptive srk depth {depth}: gradient not finite")
        check(torch.equal(zT, z), f"adaptive srk depth {depth}: the checkpoint replay's "
                                  f"z_T differs from solve_adaptive's")
        n = int(stats.num_accepted)
        for i in range(min(n, 3)):  # the interval pairs the loop and the replay form
            s_, t_ = stats.ts[i], stats.ts[i] + stats.dts[i]
            pair = bm.evaluate(s_, t_, depth)
            check(torch.equal(pair[0], bm.value(t_, depth)[0] - bm.value(s_, depth)[0]),
                  f"adaptive srk depth {depth}: evaluate's W is not value(t) - value(s)")
        check(counts["space_time_value"] > 0 and counts["brownian_value"] == 0
              and counts["brownian_increment"] == 0 and counts["space_time_increment"] == 0,
              f"adaptive srk depth {depth}: launches {counts}")
        adaptive[depth] = dict(accepted=n, attempts=attempts, launches=counts)
        print(f"[{label}] adaptive srk, burst, float64, bridge depth {depth}: {n} accepted of "
              f"{attempts} attempts; checkpointed gradient finite, replayed z_T bitwise "
              f"solve_adaptive's; launches of the gradient {counts}", flush=True)

    f64 = torch.float64
    intervals = [(i / BI_INTERVALS, (i + 1) / BI_INTERVALS) for i in range(BI_INTERVALS)]
    perm = torch.randperm(BI_INTERVALS, generator=torch.Generator().manual_seed(0)).tolist()
    patterns = {"sequential": intervals, "doubly": intervals + intervals[::-1],
                "random": [intervals[i] for i in perm]}
    for mode in (None, "space-time"):
        for pattern, order_ in patterns.items():
            on = {d: BrownianInterval(0.0, 1.0, (2560,), seed=2, dtype=f64, levy_area=mode,
                                      device=d) for d in (dev, "cpu")}
            for s, t in order_:
                a, b = on[dev](s, t), on["cpu"](s, t)
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)),
                      f"BrownianInterval {mode} {pattern} [{s}, {t}]: card != CPU")
            check(on[dev].cache_stats == on["cpu"].cache_stats,
                  f"BrownianInterval {mode} {pattern}: cache stats differ")
    print(f"[{label}] BrownianInterval float64 size 2560, levy_area None and space-time, "
          f"{BI_INTERVALS} intervals sequential / doubly / random: card bits == CPU bits, "
          f"cache stats equal", flush=True)
    table2 = {}
    for size in BI_SIZES:
        for pattern, order_ in patterns.items():
            for name in ("BrownianInterval", "VirtualBrownianTree"):
                if name == "BrownianInterval":
                    src = BrownianInterval(0.0, 1.0, (size,), seed=2, dtype=f64, device=dev)
                    query = src
                else:
                    src = VirtualBrownianTree(prng.PRNGKey(2, device=dev), 0.0, 1.0, (size,),
                                              dtype=f64)
                    query = src.evaluate
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for s, t in order_:
                    query(s, t)
                torch.cuda.synchronize()
                table2[f"{name} {pattern} size={size}"] = (time.perf_counter() - t0) * 1e3
    print(f"[{label}] Table 2 reading (float64, on the card, {BI_INTERVALS} intervals, wall "
          f"ms of the pattern): " + ", ".join(f"{k} {v:.2f}" for k, v in table2.items()),
          flush=True)
    return dict(timed=timed, errs=errs, order=order, launches=launches, timing=timing,
                adaptive=adaptive, table2=table2)


def serve_checks(ops, dev, label: str) -> dict:
    """Phase 5: the main path through serve_sde, fused and unfused."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init
    from repro_torch.launch.steps import make_sample_step
    from repro_torch.serving import restore_for_serving, serve_buckets, serve_sde
    from repro_torch.serving.service import _request_keys
    from repro_torch.serving.types import synthetic_requests

    widths = WIDTHS
    params = latent_sde_init(torch.Generator().manual_seed(0), LatentSDEConfig(**widths))
    serve = dict(max_batch=1024, requests=32, request_max=64, seed=3, collect=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        for variant, fused in (("fused", True), ("unfused", False)):
            cfg = LatentSDEConfig(**widths, use_pallas_kernels=fused)
            ckpt.save_serving_bundle(os.path.join(tmp, variant), 0, params,
                                     "latent-sde", cfg)
        ops.reset_launch_counts()
        for variant in ("fused", "unfused", "unfused", "fused"):  # in turns
            stats = serve_sde("latent-sde", os.path.join(tmp, variant),
                              latent_mode="prior", **serve)
            results.setdefault(variant, stats)
            print(f"[{label}] serve {variant}: {stats['traj_per_s']:.1f} traj/s, "
                  f"p50 {stats['p50_s'] * 1e3:.2f} ms, p99 {stats['p99_s'] * 1e3:.2f} ms "
                  f"({stats['trajectories']} trajectories, {stats['batches']} batches)",
                  flush=True)
        launches = ops.launch_counts()
        print(f"[{label}] serving-path launches: {launches}", flush=True)
        restored, cfg_f, _ = restore_for_serving("latent-sde", os.path.join(tmp, "fused"), dev)
    for name in SERVE_KERNELS + ("fused_mlp",):
        check(launches.get(name, 0) > 0, f"{name} was not launched on the serving path")

    fused, unfused = results["fused"]["samples"], results["unfused"]["samples"]
    check(sorted(fused) == sorted(unfused) and len(fused) == serve["requests"],
          "variants answered different requests")
    for rid in fused:
        ys = fused[rid]
        check(ys.shape == (24, ys.shape[1], 2) and torch.isfinite(ys).all().item(),
              f"request {rid}: bad trajectory shape {tuple(ys.shape)} or non-finite")
        check(torch.equal(ys, unfused[rid]), f"request {rid}: fused != unfused")

    sampler = make_sample_step("latent-sde", cfg_f)
    buckets = serve_buckets(serve["max_batch"])
    reqs = list(synthetic_requests(serve["requests"], serve["request_max"], serve["seed"]))
    for r in reqs[:6]:
        bucket = next(b for b in buckets if b >= r.size)
        solo = sampler(restored, _request_keys([r], bucket, dev))[:, :r.size].cpu()
        check(torch.equal(solo, fused[r.rid]),
              f"request {r.rid} (size {r.size}): solo rows != coalesced rows")
    print("padding invariance: 6 requests served solo == coalesced (bitwise)", flush=True)

    keys = _request_keys(reqs[:3], 64, dev)
    on_card = sampler(restored, keys).cpu()
    cpu_params = _to_device(restored, "cpu")
    on_cpu = make_sample_step("latent-sde", cfg_f, device="cpu")(cpu_params, keys.cpu())
    err = (on_card - on_cpu).abs().max().item()
    check(torch.allclose(on_card, on_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
          f"card vs CPU: max |Δ| {err} beyond rtol={CPU_RTOL}, atol={CPU_ATOL}")
    print(f"card vs CPU (bucket 64, float32): max |Δ| {err:.3g} within rtol={CPU_RTOL}, "
          f"atol={CPU_ATOL}", flush=True)
    decodes = {v: 2 * (len(buckets) + results[v]["batches"]) for v in results}
    keys = _request_keys(reqs, 1024, dev)
    for variant, fuse in (("fused", True), ("unfused", False)):
        profile_decode(make_sample_step("latent-sde", dataclasses.replace(
            cfg_f, use_pallas_kernels=fuse)), restored, keys, f"{label}] [{variant}")
    compare_kernels(lambda: sampler(restored, keys), label, "1024-row decode bucket (fused)")
    return dict(launches=launches, results=results, decodes=decodes)


#: The rest of SDE serving (phase 8b): the buckets' widest, the requests
#: of phase 8, the SDE-GAN at GAN_WIDTHS with 32 steps in 4 chunks, the
#: posterior at WIDTHS with SEQ_LEN observations.
SCHED_SERVE = dict(max_batch=1024, requests=32, request_max=64, seed=9, collect=True)
SCHED_STEPS, SCHED_CHUNKS = 32, 4
GRAPH_BUCKETS = (1, 64, 1024)
SCHED_BUDGET_MB = 16  # below the 22 warmed entries' 46 MiB
SCHED_PATH_KERNELS = ("brownian_increment", "fused_mlp", "rev_heun_phase1_gen",
                      "rev_heun_phase2", "brownian_value")


def _sched_model(dev, seed: int):
    from repro_torch.core.sde import NeuralSDEConfig, generator_init

    cfg = NeuralSDEConfig(**dict(GAN_WIDTHS, num_steps=SCHED_STEPS))
    return cfg, generator_init(torch.Generator().manual_seed(seed), cfg, device=dev)


def _chunk_inputs(cfg, params, bucket: int, dev, seed: int = 12):
    """A chunk batch of ``bucket`` rows at mixed chunk positions."""
    from repro_torch.core.sde import generator_initial_state
    from repro_torch.serving.scheduler import _keys

    keys = _keys([seed] * bucket, range(bucket), dev,
                 chunks=[i % SCHED_CHUNKS for i in range(bucket)])
    span = cfg.t1 / SCHED_CHUNKS
    ts = torch.tensor([(i % SCHED_CHUNKS) * span for i in range(bucket)],
                      dtype=cfg.dtype).to(dev)
    with torch.no_grad():
        return keys, generator_initial_state(params, cfg, keys), ts


def _chunk_step(cfg, params):
    from repro_torch.core.sde import generator_rollout_chunk

    def step(keys, x0, ts):
        with torch.no_grad():
            return generator_rollout_chunk(params, cfg, keys, x0, ts, cfg.t1 / SCHED_CHUNKS,
                                           cfg.num_steps // SCHED_CHUNKS)
    return step


def sched_serve_checks(ops, dev, label: str) -> dict:
    """Phase 8b: the rest of SDE serving — the posterior decode, streaming,
    the continuous-batching scheduler (continuous and fifo, preemption, a
    pool budget, the asyncio front) with its CUDA-graph pools."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.sde import LatentSDEConfig, generator_initial_state, latent_sde_init
    from repro_torch.launch.steps import make_sample_step
    from repro_torch.serving import (LoadedModel, ModelRegistry, Request, Scheduler,
                                     restore_for_serving, serve_sde, synthetic_requests)
    from repro_torch.serving.registry import CapturedGraph
    from repro_torch.serving.service import _request_keys

    # launches on this phase's paths: the eager calls' (ops.launch_counts, which
    # a capture leaves unchanged) plus the graphs' replays
    used = collections.Counter()

    def count(extra=None):
        used.update({k: v for k, v in ops.launch_counts().items() if v})
        if extra:
            used.update(extra)

    # -- the posterior decode through serve_sde (fused), buckets up to 1024
    reqs = list(synthetic_requests(SCHED_SERVE["requests"], SCHED_SERVE["request_max"],
                                   SCHED_SERVE["seed"]))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        lcfg = LatentSDEConfig(**WIDTHS, use_pallas_kernels=True)
        ckpt.save_serving_bundle(tmp, 0, latent_sde_init(torch.Generator().manual_seed(8), lcfg),
                                 "latent-sde", lcfg)
        ops.reset_launch_counts()
        post = serve_sde("latent-sde", tmp, latent_mode="posterior", obs_len=SEQ_LEN,
                         **SCHED_SERVE)
        torch.cuda.synchronize()
        post_launches = ops.launch_counts()
        count()
        lparams, lcfg, _ = restore_for_serving("latent-sde", tmp, dev)
    print(f"[{label}] posterior serve: {post['traj_per_s']:.1f} traj/s, p50 "
          f"{post['p50_s'] * 1e3:.2f} ms, p99 {post['p99_s'] * 1e3:.2f} ms "
          f"({post['trajectories']} trajectories, {post['batches']} batches); launches "
          f"{ {k: v for k, v in post_launches.items() if v} }", flush=True)
    for name in ("rev_heun_phase1_gen", "rev_heun_phase2", "fused_mlp"):
        check(post_launches[name] > 0, f"{name} was not launched by the posterior decode")
    for r in reqs:
        ys = post["samples"][r.rid]
        check(ys.shape == (WIDTHS["num_steps"] + 1, r.size, 2) and torch.isfinite(ys).all().item(),
              f"posterior request {r.rid}: bad trajectory {tuple(ys.shape)}")
    sampler = make_sample_step("latent-sde", lcfg, latent_mode="posterior", obs_len=SEQ_LEN)
    keys = _request_keys(reqs, 1024, dev)
    sampler(lparams, keys)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    full = sampler(lparams, keys).cpu()
    per_decode = {k: v for k, v in ops.launch_counts().items() if v}
    row = 0
    for r in reqs[:6]:
        bucket = next(b for b in post["buckets"] if b >= r.size)
        solo = sampler(lparams, _request_keys([r], bucket, dev))[:, :r.size].cpu()
        check(torch.equal(solo, post["samples"][r.rid]) and
              torch.equal(solo, full[:, row:row + r.size]),
              f"posterior request {r.rid}: solo rows != coalesced rows")
        row += r.size
    keys64 = _request_keys(reqs[:3], 64, dev)
    on_card = sampler(lparams, keys64).cpu()
    on_cpu = make_sample_step("latent-sde", lcfg, latent_mode="posterior", obs_len=SEQ_LEN,
                              device="cpu")(_to_device(lparams, "cpu"), keys64.cpu())
    err_post = (on_card - on_cpu).abs().max().item()
    check(torch.allclose(on_card, on_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
          f"posterior card vs CPU: max |Δ| {err_post}")
    print(f"[{label}] posterior decode at bucket 1024: launches {per_decode}; 6 requests "
          f"solo == coalesced (bitwise); card vs CPU (bucket 64) max |Δ| {err_post:.3g} within "
          f"rtol={CPU_RTOL}, atol={CPU_ATOL}", flush=True)

    # -- streaming and the scheduler through serve_sde
    gan = dict(sde_steps=SCHED_STEPS, **SCHED_SERVE)
    ops.reset_launch_counts()
    stream = serve_sde("sde-gan", stream_chunks=SCHED_CHUNKS, **gan)
    torch.cuda.synchronize()
    count()
    check(ops.launch_counts()["brownian_increment"] > 0 and ops.launch_counts()["fused_mlp"] > 0,
          "streaming did not launch brownian_increment and fused_mlp")
    served = {"stream": stream}
    # Alternating order, so a cost that only the first drain pays shows as
    # order, not as mode.  At this traffic (every request at once, one
    # model, no deadline) both modes run the same chunk batches and
    # preemption never engages; the budget is below the warmed pool, so the
    # warm-up evicts and the drain serves from what stayed.
    for run, mode in enumerate(("continuous", "fifo", "fifo", "continuous")):
        ops.reset_launch_counts()
        st = serve_sde("sde-gan", scheduler=mode, preempt=True, pool_budget_mb=SCHED_BUDGET_MB,
                       async_front=True, **gan)
        torch.cuda.synchronize()
        count(st["replay_launches"])
        served[f"{mode} {run}"] = st
        check(st["replay_launches"].get("brownian_increment", 0) > 0
              and st["replay_launches"].get("fused_mlp", 0) > 0,
              f"scheduler ({mode}): no kernel launched by a graph replay")
        check(st["pool_evictions"] > 0 and st["pool_bytes"] <= st["pool_budget_bytes"],
              f"scheduler ({mode}): pool {st['pool_bytes']} B after {st['pool_evictions']} "
              f"evictions under a {st['pool_budget_bytes']} B budget")
        print(f"[{label}] scheduler {mode} drain {run} (preempt, {SCHED_BUDGET_MB} MB budget, "
              f"asyncio front): {st['traj_per_s']:.1f} traj/s, p50 {st['p50_s'] * 1e3:.2f} ms, "
              f"p99 {st['p99_s'] * 1e3:.2f} ms, {st['counters']['chunk_batches']} chunk "
              f"batches, {st['counters']['preempted_rows']} rows preempted, pool "
              f"{st['pool_bytes']} B over {len(st['pool_keys'])} entries, "
              f"{st['pool_evictions']} evictions, {st['pool_builds']} builds; replays "
              f"launched {st['replay_launches']}", flush=True)
    print(f"[{label}] stream x{SCHED_CHUNKS}: {stream['traj_per_s']:.1f} traj/s, first chunk "
          f"{stream['first_chunk_ms']:.2f} ms", flush=True)
    for r in reqs:
        ys = served["stream"]["samples"][r.rid]
        check(ys.shape == (SCHED_STEPS + 1, r.size, 1) and torch.isfinite(ys).all().item(),
              f"stream request {r.rid}: bad trajectory {tuple(ys.shape)}")
        for mode in (m for m in served if m != "stream"):
            check(torch.equal(served[mode]["samples"][r.rid], ys),
                  f"request {r.rid}: scheduler {mode} rows != streamed rows")
    print(f"[{label}] {len(reqs)} requests: scheduler continuous == fifo == stream loop "
          f"(graph replays against eager chunks, bitwise)", flush=True)

    # -- graph replay == the eager chunk, bitwise, at buckets 1, 64, 1024
    cfg, params = _sched_model(dev, 10)
    step = _chunk_step(cfg, params)
    init = lambda k: generator_initial_state(params, cfg, k)
    graphs = {}
    for b in GRAPH_BUCKETS:
        args = _chunk_inputs(cfg, params, b, dev)
        want = step(*args)
        with torch.no_grad():
            want_x0 = init(args[0])
        graph = CapturedGraph(step, args)
        init_graph = CapturedGraph(init, args[:1])
        got = graph(*args)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"bucket {b}: the replayed chunk != the eager chunk")
        check(torch.equal(init_graph(args[0]), want_x0),
              f"bucket {b}: the replayed initial state != the eager one")
        print(f"[{label}] bucket {b}: chunk graph {graph.nbytes} B, launches {graph.launches}; "
              f"init graph {init_graph.nbytes} B; replay == eager (bitwise)", flush=True)
        graphs[b] = (graph, args)
        init_graph.release()
    graph, args = graphs[GRAPH_BUCKETS[-1]]
    readings = {"replay": profile_call(lambda: graph(*args),
                                       f"{label}] [scheduler chunk B=1024 replayed"),
                "eager": profile_call(lambda: step(*args),
                                      f"{label}] [scheduler chunk B=1024 eager")}
    chunk_launches = dict(graph.launches)

    # -- eviction frees the entry's bytes; a rebuild gives its bits
    reg = ModelRegistry()
    reg.register(LoadedModel("default", "sde-gan", cfg, params))
    a = reg.compiled("default", "chunk", 1024, lambda: CapturedGraph(step, args))
    want = a(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reg.pool_budget_bytes = a.nbytes
    small = _chunk_inputs(cfg, params, 64, dev)
    b64 = reg.compiled("default", "chunk", 64, lambda: CapturedGraph(step, small))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the evicted pool's segments go back here
    freed = before + b64.nbytes - torch.cuda.memory_reserved()
    check(reg.evictions == 1 and reg.pool_keys() == (("default", "chunk", 64),),
          f"eviction: {reg.evictions} evictions, pool {reg.pool_keys()}")
    check(freed >= a.nbytes, f"eviction freed {freed} B of the entry's {a.nbytes} B")
    rebuilt = reg.compiled("default", "chunk", 1024, lambda: CapturedGraph(step, args))
    check(all(torch.equal(g, w) for g, w in zip(rebuilt(*args), want)),
          "the rebuilt chunk graph != the evicted one")
    print(f"[{label}] eviction: the 1024-row chunk graph's {a.nbytes} B freed ({freed} B "
          f"returned); the rebuild replays its bits", flush=True)
    for g, _ in graphs.values():
        g.release()
    del reg, a, b64, rebuilt, graphs, graph

    # -- mid-flight admission and preemption on the card, bitwise invisible
    reg = ModelRegistry()
    for i, mid in enumerate(("bulk", "rt")):
        reg.register(LoadedModel(mid, "sde-gan", cfg, _sched_model(dev, 20 + i)[1]))

    def solo(req):
        sched = Scheduler(reg, max_batch=64, chunks=SCHED_CHUNKS, collect=True)
        sched.submit(req)
        (res,) = sched.run()
        return res.samples

    ops.reset_launch_counts()
    sched = Scheduler(reg, max_batch=64, chunks=SCHED_CHUNKS, collect=True, preempt=True)
    first = Request(rid=0, size=5, seed=31, model_id="bulk")
    sched.submit(first)
    sched.step()
    late = Request(rid=1, size=3, seed=32, model_id="bulk")
    sched.submit(late)
    sched.step()
    sched.submit(Request(rid=2, size=2, seed=33, model_id="rt", kind="terminal",
                         deadline_ms=40.0))
    sched.submit(Request(rid=3, size=4, seed=34, model_id="rt"))
    results = sched.run()
    count(reg.replay_launches)
    by_rid = {r.rid: r for r in results}
    check(sched.counters["preempted_rows"] > 0 and sched.counters["resumed_rows"] > 0,
          f"preemption did not engage: {sched.counters}")
    for req in (first, late, Request(rid=3, size=4, seed=34, model_id="rt")):
        check(torch.equal(by_rid[req.rid].samples, solo(req)),
              f"request {req.rid}: admitted mid-flight / preempted rows != solo rows")
    check(by_rid[2].num_converged == 2 and by_rid[2].rtol == 1e-2,
          f"the realtime terminal batch: {by_rid[2]}")
    print(f"[{label}] mid-flight admission and preemption ({sched.counters}): rows bitwise "
          f"the solo runs'", flush=True)

    # -- the card against the CPU (the scheduler on both)
    cpu_reg = ModelRegistry()
    cpu_reg.register(LoadedModel("bulk", "sde-gan", cfg, _to_device(reg.get("bulk").params,
                                                                     "cpu")))
    cpu = Scheduler(cpu_reg, max_batch=64, chunks=SCHED_CHUNKS, collect=True)
    cpu.submit(first)
    on_cpu = cpu.run()[0].samples
    err = (on_cpu - by_rid[0].samples).abs().max().item()
    check(torch.allclose(by_rid[0].samples, on_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
          f"scheduler card vs CPU: max |Δ| {err}")
    print(f"[{label}] scheduler card vs CPU: max |Δ| {err:.3g} within rtol={CPU_RTOL}, "
          f"atol={CPU_ATOL}", flush=True)
    for name in SCHED_PATH_KERNELS:
        check(used.get(name, 0) > 0, f"{name} was not launched on the serving paths")
    print(f"[{label}] serving-path launches (eager and replayed): {dict(used)}", flush=True)
    return dict(posterior=post, served=served, posterior_decode=per_decode,
                chunk_launches=chunk_launches, readings=readings, launches=dict(used))


def value_bound(rows: int, n_per_row: int, depth: int, dtype) -> tuple:
    """Least time for ``brownian_value`` by throughput: each row's key walk
    once (a root fold_in, then a child and a midpoint fold_in per level),
    each element's ``depth + 1`` normals (float32 draws share a hash by
    twos), the combine and the tail; bytes: keys and times in, values out.

    Beside it stands the chain floor (:func:`chain_floor`): a row's key
    chain is ``depth + 1`` dependent Threefry hashes (the root fold_in, then
    one child fold_in a level), each waiting on the last, so no launch ends
    before ``(depth + 1)`` chain steps at the measured step latency (on an
    NVIDIA H100 80GB HBM3 at 700 W, ~166 ns a step: 4.1 µs at depth 24,
    1.8 µs at depth 10; PERF.md).  At the serving shape (1024 rows × 4,
    depth 24) the throughput bound is ~15x shorter than that chain: the
    rows' chains run side by side, so more rows add operations but not
    length, and 1024 rows cannot reach the throughput bound."""
    s = torch.finfo(dtype).bits // 8
    n = rows * n_per_row
    hash_per_normal = 0.5 if dtype == torch.float32 else 1.0
    ops = (rows * (1 + 2 * depth) * HASH_OPS
           + n * (depth + 1) * (hash_per_normal * HASH_OPS + NORMAL_OPS[dtype])
           + n * (6 * depth + 6))
    nbytes = rows * (16 + s) + n * s
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_step_ms(ops, dev, dtype=torch.float32) -> float:
    """The measured latency of one step of a row's key chain: the kernel on
    one row of one element at depth 24 against depth 0 (both one chunk of
    levels, one block), the difference over 24 levels.  Each level adds one
    dependent child fold_in (the midpoint fold_in issues beside it), the
    level's scalar walk and one combine step; the launch's fixed costs
    cancel."""
    keys = torch.tensor([[7, 11]], dtype=torch.int64, device=dev)
    t = torch.tensor([0.3], dtype=dtype, device=dev)
    ms = {depth: time_ms(lambda: ops.brownian_value(keys, t, 0.0, 1.0, (1,), dtype, depth),
                         reps=50, trials=9)[0] for depth in (0, 24)}
    return (ms[24] - ms[0]) / 24


def chain_floor(depth: int, step_ms: float) -> float:
    """The chain floor of ``brownian_value``: ``depth + 1`` dependent chain
    steps (the root fold_in and one a level) at ``step_ms`` each."""
    return (depth + 1) * step_ms


# brownian_value checks: rows × per-row sizes × depths (phase 9).  1000,
# 1001 and 1024 rows take 4 rows a block (1001 leaves a last block of one
# row); depth 40 runs two chunks of levels (four in float64); depth 0 draws
# the root alone.
VALUE_ROWS = (1, 3, 64, 1000, 1001, 1024)
VALUE_SIZES = ((1,), (4,), (17,), (256, 32))
VALUE_DEPTHS = (0, 1, 10, 24, 40)


def value_checks(ops, dev) -> tuple:
    """Phase 9: ``brownian_value`` bitwise against its plain version at every
    VALUE_ROWS × VALUE_SIZES × VALUE_DEPTHS case, float32 and float64; the
    launcher's grid at the two path shapes (>= 128 blocks); timed at the
    serving and the gradient shapes beside the throughput bound and the
    chain floor.  Returns ``({shape: row}, max |Δ|)``."""
    from repro_torch.kernels.brownian import brownian_value_blocks

    g = torch.Generator().manual_seed(4321)
    err, n_checked = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        for rows in VALUE_ROWS:
            for shape in VALUE_SIZES:
                keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g,
                                     dtype=torch.int64).to(dev)
                rand = torch.rand(max(rows, 4), generator=g, dtype=torch.float64).tolist()
                if rows == 1:  # one key: each time in turn
                    times = [[0.0], [1.0], [0.375], [rand[0]], [rand[1]]]
                else:  # many keys: t0, t1, a dyadic point and random times mixed
                    times = [[[0.0, 1.0, 0.375][r % 3] if r < 3 else rand[r]
                              for r in range(rows)]]
                for depth in VALUE_DEPTHS:
                    for tl in times:
                        t = torch.tensor(tl, dtype=dtype, device=dev)
                        got = ops.brownian_value(keys, t, 0.0, 1.0, shape, dtype, depth)
                        want = ops.brownian_value(keys, t, 0.0, 1.0, shape, dtype, depth,
                                                  use_kernel=False)
                        torch.cuda.synchronize()
                        e = (got - want).abs().max().item()
                        check(torch.equal(got, want) and e == 0.0,
                              f"brownian_value {dtype} rows={rows} {shape} depth={depth}: "
                              f"kernel != plain (max |Δ| {e})")
                        err = max(err, e)
                        n_checked += 1
                    del got, want
                torch.cuda.empty_cache()
    print(f"bitwise: brownian_value x {{float32, float64}} x rows {VALUE_ROWS} x sizes "
          f"{VALUE_SIZES} x depth {VALUE_DEPTHS} ({n_checked} calls, t0/t1/dyadic/random "
          f"times): kernel == plain", flush=True)
    step = chain_step_ms(ops, dev)
    print(f"brownian_value chain step (float32, one row, depth 24 vs 0): {step * 1e6:.1f} ns",
          flush=True)
    rows_out = {}
    for tag, rows, shape, depth in (("serve", 1024, (4,), 24), ("grad", 1, (256, 32), 10)):
        blocks = brownian_value_blocks(torch.float32, rows, math.prod(shape))
        check(blocks >= 128, f"brownian_value {tag}: {blocks} blocks, fewer than 128 SMs busy")
        keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(dev)
        t = torch.rand(rows, generator=g, dtype=torch.float64).float().to(dev)
        k_ms, k_host = time_ms(lambda: ops.brownian_value(keys, t, 0.0, 1.0, shape,
                                                          torch.float32, depth))
        p_ms, p_host = time_ms(lambda: ops.brownian_value(keys, t, 0.0, 1.0, shape,
                                                          torch.float32, depth,
                                                          use_kernel=False), reps=5, trials=3)
        b_ms, b_by = value_bound(rows, math.prod(shape), depth, torch.float32)
        floor = chain_floor(depth, step)
        print(f"brownian_value float32 {tag}: rows {rows} x {shape}, depth {depth}, {blocks} "
              f"blocks: kernel {k_ms:.5f} ms ({k_host:.5f} host), plain {p_ms:.5f} ms "
              f"({p_host:.5f}), bound {b_ms:.7f} ms ({b_by}), chain floor {floor:.5f} ms "
              f"({depth + 1} steps)", flush=True)
        rows_out[tag] = dict(ms=k_ms, host_ms=k_host, plain_ms=p_ms, plain_host_ms=p_host,
                             bound_ms=b_ms, bound_by=b_by, chain_floor_ms=floor,
                             chain_step_ms=step, blocks=blocks)
    return rows_out, err


# One adaptive serving drain in a fresh process of one tree (run from that
# tree's root): phase 10's serve_sde call timed by the host clock, then the
# same drain under torch.profiler (device activity only, which about halves
# the profiled drain's time) for the card's busy time and the
# brownian_value kernel's share.  Prints one JSON line.
_DRAIN_CHILD = r"""
import json, sys, time
sys.path.insert(0, "src")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import build
from repro_torch.serving import serve_sde
build.load()
kw = dict(adaptive=True, atol=1e-6, sde_steps=16, max_batch=1024, requests=32,
          request_max=64, seed=5)
t0 = time.perf_counter()
stats = serve_sde("sde-gan", **kw)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
with profile(activities=[ProfilerActivity.CUDA]) as prof:  # host ops unrecorded: fast
    serve_sde("sde-gan", **kw)
    torch.cuda.synchronize()
dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev(e) > 0]
bv = [e for e in events if "brownian_value" in e.key]
print(json.dumps({"wall_s": wall, "traj_per_s": stats["traj_per_s"],
                  "busy_ms": sum(dev(e) for e in events) / 1e3,
                  "brownian_value_ms": sum(dev(e) for e in bv) / 1e3,
                  "brownian_value_launches": sum(e.count for e in bv)}))
"""


def _children_in_turns(parent_root: str, child: str, what: str, timeout: int) -> dict:
    """Run ``child`` (a script that prints one JSON line last) as a fresh
    process from the root of the tree at ``parent_root`` and of this one,
    in turns (parent, this, this, parent): ``{tree: [runs]}``, printed."""
    runs = {"parent": [], "this": []}
    for tree in ("parent", "this", "this", "parent"):
        cwd = os.path.abspath(parent_root) if tree == "parent" else ROOT
        out = subprocess.run([sys.executable, "-c", child], cwd=cwd, check=True,
                             capture_output=True, text=True, timeout=timeout).stdout
        runs[tree].append(json.loads(out.strip().splitlines()[-1]))
        print(f"{what} [{tree}]: {json.dumps(runs[tree][-1])}", flush=True)
    print(f"card: {gpu_label()}", flush=True)
    return runs


def drain_in_turns(parent_root: str) -> dict:
    """The adaptive serving drain (phase 10's) in the tree at
    ``parent_root`` and in this one, in turns (parent, this, this, parent),
    each a fresh process that builds its own kernels: ``{tree: [runs]}``
    with each run's wall, traj/s, device busy time and the brownian_value
    kernel's device time and launches.  A run takes ~4 minutes on an H100
    (the profiled drain records ~100k kernels), the four ~16.  Run it as
    ``python3 -c "import
    chip_smoke as C; C.drain_in_turns('build/parent')"`` after unpacking
    the parent commit there (``git archive``)."""
    return _children_in_turns(parent_root, _DRAIN_CHILD, "adaptive drain", 900)


# One process of one tree (run from its root): the fused ELBO step at batch
# 64 and 1024 and the depth-10 adaptive gradient (walls of synchronised
# calls by the host clock, medians), their launches and device kernels (one
# profiled call), their busy as the sum of the device spans and as their
# union (another profiled call: a dependent kernel's span may overlap its
# predecessor's, which the sum counts twice), the rev_heun kernels' device
# time and launches in the profiled call, and the fused_mlp launcher's
# host cost per call at 1024 ×
# 17 -> 32 -> 16 (float32): the whole call, the launch without checks, the
# checks, the ctypes call as that tree makes it, and the backward's launch
# (``_launch_bwd``, the same widths and rows).  Only functions both
# trees' chip_smoke.py have are used.  Prints one JSON line.
_ELBO_CHILD = r"""
import json, statistics, sys, time
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as C
from repro_torch import nn
from repro_torch.kernels import build, fused_mlp as fm, ops
lib = build.load()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
def walls(run, n):
    run()
    torch.cuda.synchronize()
    ws = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ws.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ws), ws
def busy_spans(run):
    # one profiled call's device spans: their sum and their union (a
    # dependent kernel's span may overlap its predecessor's), in ms
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    union, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            union += b - max(a, end)
            end = b
    return [sum(b - a for a, b in iv) / 1e3, union / 1e3, len(iv)]
runs = {"elbo B64": C._train_step(dev, 64), "elbo B1024": C._train_step(dev, 1024),
        "adaptive grad depth 10": C._adaptive_grad(dev, torch.float32, True, 10)}
for tag, run in runs.items():
    out[tag + " ms"], out[tag + " all ms"] = walls(run, 9)
    ops.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    out[tag + " launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    prof = C.profile_call(run, tag)
    out[tag + " device kernels"] = prof["kernels"]
    out[tag + " busy ms"] = prof["busy_ms"]
    out[tag + " idle"] = prof["idle"]
    out[tag + " busy ms sum, union, spans"] = busy_spans(run)
    out[tag + " rev_heun ms, launches"] = {
        k: [sum(v for n, v in prof["by_name"].items() if "::" + k + "<" in n),
            sum(c for n, c in prof["counts"].items() if "::" + k + "<" in n)]
        for k in ("phase1_gen_kernel", "rev_heun_phase2_kernel", "phase1_kernel",
                  "bwd_phase1_kernel", "bwd_phase2_kernel")}
g = torch.Generator().manual_seed(5)
x, *w = C._mlp_operands(g, dev, torch.float32, 1024, 17, 32, 16)
ct = torch.randn(1024, 16, generator=g).to(dev)
params = {"layers": [{"w": w[0], "b": w[1]}, {"w": w[2], "b": w[3]}]}
o = torch.empty(1024, 16, device=dev)
ptrs = [t.data_ptr() for t in (x, *w, o)]
stream = torch.cuda.current_stream(dev).cuda_stream
call = lambda: lib.rt_fused_mlp(0, *ptrs, 1024, 17, 32, 16, stream)
def host_us(fn, n=2000):
    fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(res)
out["host us"] = {"ops.fused_mlp": host_us(lambda: ops.fused_mlp(x, *w)),
                  "nn.mlp": host_us(lambda: nn.mlp(params, x)),
                  "fm._launch": host_us(lambda: fm._launch(x, *w)),
                  "fm.check_operands": host_us(lambda: fm.check_operands(x, *w)),
                  "ctypes launch": host_us(call),
                  "fm._launch_bwd": host_us(lambda: fm._launch_bwd(x, *w, ct))}
out["time_ms host ms"] = C.time_ms(lambda: ops.fused_mlp(x, *w))[1]
print(json.dumps(out))
"""


def elbo_in_turns(parent_root: str) -> dict:
    """The fused ELBO step (batch 64 and 1024) and the depth-10 adaptive
    gradient, their launches and device kernels, their busy as the sum and
    as the union of the device spans, and the fused_mlp launcher's host
    cost, in the tree at ``parent_root`` and in this one, in
    turns (parent, this, this, parent), each a fresh process that builds
    its own kernels (~1–2 minutes each): ``{tree: [runs]}``.  Run it as
    ``python3 -c "import chip_smoke as C; C.elbo_in_turns('build/parent')"``
    after unpacking the parent commit there (``git archive``)."""
    return _children_in_turns(parent_root, _ELBO_CHILD, "ELBO in turns", 900)


# One process of one tree (run from its root): phase 8b's 1024-row chunk
# graph (the SDE-GAN generator, 8 reversible-Heun steps) replayed and the
# same chunk eager: wall, busy, idle and device kernels of one call
# (profile_call) and its device and host ms (time_ms).  Only functions both
# trees' chip_smoke.py have are used.  Prints one JSON line.
_CHUNK_CHILD = r"""
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as C
from repro_torch.kernels import build
from repro_torch.serving.registry import CapturedGraph
build.load()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
cfg, params = C._sched_model(dev, 10)
step = C._chunk_step(cfg, params)
args = C._chunk_inputs(cfg, params, 1024, dev)
graph = CapturedGraph(step, args)
out = {}
for tag, fn in (("replay", lambda: graph(*args)), ("eager", lambda: step(*args))):
    prof = C.profile_call(fn, "chunk B=1024 " + tag)
    out[tag] = {k: prof[k] for k in ("wall_ms", "busy_ms", "idle", "kernels")}
    out[tag]["device_ms"], out[tag]["host_ms"] = C.time_ms(fn, reps=5)
print(json.dumps(out))
"""


# One process of one tree (run from its root): one srk discretise ELBO step
# at batch 64 (SRK_VARIANTS, the training widths, float32): walls of
# synchronised steps by the host clock (median of 9), its launches, and one
# profiled step's device kernels, busy, idle and space_time_increment's
# device time and count.  Prints one JSON line.
_SRK_CHILD = r"""
import json, statistics, sys, time
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as C
from repro_torch.kernels import build, ops
build.load()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
run = C._train_step(dev, 64, fused=False, **C.SRK_VARIANTS["srk/discretise"])
run()
torch.cuda.synchronize()
ws = []
for _ in range(9):
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ws.append((time.perf_counter() - t0) * 1e3)
ops.reset_launch_counts()
run()
torch.cuda.synchronize()
launches = {k: v for k, v in ops.launch_counts().items() if v}
prof = C.profile_call(run, "srk discretise B64")
st = [n for n in prof["by_name"] if "space_time_increment_kernel" in n]
print(json.dumps({"wall ms": statistics.median(ws), "walls": ws, "launches": launches,
                  "device kernels": prof["kernels"], "busy ms": prof["busy_ms"],
                  "idle": prof["idle"],
                  "space_time_increment ms, count": [sum(prof["by_name"][n] for n in st),
                                                     sum(prof["counts"][n] for n in st)]}))
"""


def srk_in_turns(parent_root: str) -> dict:
    """One srk discretise ELBO step (``_SRK_CHILD``) in the tree at
    ``parent_root`` and in this one, in turns (parent, this, this, parent),
    each a fresh process that builds its own kernels: ``{tree: [runs]}``.
    Run it as ``python3 -c "import chip_smoke as C;
    C.srk_in_turns('build/parent')"`` after unpacking the parent commit
    there (``git archive``)."""
    return _children_in_turns(parent_root, _SRK_CHILD, "srk in turns", 900)


def chunk_in_turns(parent_root: str) -> dict:
    """Phase 8b's 1024-row chunk graph and eager chunk (``_CHUNK_CHILD``) in
    the tree at ``parent_root`` and in this one, in turns (parent, this,
    this, parent), each a fresh process that builds its own kernels:
    ``{tree: [runs]}``.  Run it as ``python3 -c "import chip_smoke as C;
    C.chunk_in_turns('build/parent')"`` after unpacking the parent commit
    there (``git archive``)."""
    return _children_in_turns(parent_root, _CHUNK_CHILD, "chunk in turns", 600)


def smoke_in_turns(parent_root: str, log_dir: str) -> dict:
    """The whole ``chip_smoke.py`` of the tree at ``parent_root`` and of this
    one, each run as the driver runs it (``python3 chip_smoke.py``, no
    arguments, from its tree's root; a fresh process that builds its own
    kernels), parent first: ``{tree: {"wall_s", "rc", "ok"}}``, each
    run's output in ``log_dir/smoke_<tree>.log`` and this tree's phase
    walls (its ``[phase]`` lines) printed.  Run it as ``python3 -c "import
    chip_smoke as C; C.smoke_in_turns('build/parent', 'chiprun_out')"``
    after unpacking the parent commit there (``git archive``)."""
    runs = {}
    os.makedirs(log_dir, exist_ok=True)
    for tree in ("parent", "this"):
        cwd = os.path.abspath(parent_root) if tree == "parent" else ROOT
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, timeout=1500,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        wall = time.perf_counter() - t0
        with open(os.path.join(log_dir, f"smoke_{tree}.log"), "w") as f:
            f.write(proc.stdout)
        lines = proc.stdout.strip().splitlines()
        runs[tree] = {"wall_s": wall, "rc": proc.returncode,
                      "ok": bool(lines) and lines[-1].startswith('{"ok": true')}
        if tree == "this":
            print("\n".join(ln for ln in lines if ln.startswith("[phase]")), flush=True)
        print(f"chip_smoke.py [{tree}]: {runs[tree]}", flush=True)
    print(f"card: {gpu_label()}", flush=True)
    return runs


# space_time_value's in-turns shapes: row 13's, the adaptive srk gradient's
# one key over (256, 32) in float64, at bridge depths 10 and 24
ST_TIMED = [(f"space_time_value 1x(256, 32) f64 depth {depth}", depth) for depth in (10, 24)]
# space_time_increment's in-turns cases, (tag, dtype, rows, shape): one key
# over the srk ELBO's draws at B 64 and 1024, and a key a row at 1024 rows
ST_INCREMENT_TIMED = [(f"space_time_increment {tag} {str(dtype)[6:]}", dtype, rows, shape)
                      for dtype in (torch.float32, torch.float64)
                      for tag, rows, shape in (("1x(64, 17)", 1, (64, 17)),
                                               ("1x(1024, 17)", 1, (1024, 17)),
                                               ("1024x(17,)", 1024, (17,)))]


@contextlib.contextmanager
def _library(lib):
    """Route the port's launchers through ``lib`` (a loaded library with the
    same entry points) for the ``with`` body."""
    from repro_torch.kernels import build

    saved = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = saved


def _parent_library(parent_root: str, tmp: str, entries):
    """The kernels' library built from the sources of the tree at
    ``parent_root`` (one nvcc a source, started together, then the link),
    loaded with this tree's signatures for ``entries``."""
    import ctypes

    from repro_torch.kernels import build

    csrc = os.path.join(os.path.abspath(parent_root), "src", "repro_torch", "kernels", "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    objs = [os.path.join(tmp, f[:-3] + ".o") for f in sources]
    build._run_all([[build._nvcc(), *build.NVCC_FLAGS, *_LOCAL_STATICS, "-I", csrc, "-c",
                     "-o", o, os.path.join(csrc, f)] for f, o in zip(sources, objs)])
    so = os.path.join(tmp, "parent.so")
    build._run_all([[build._nvcc(), build.ARCH_FLAG, "-shared", "-o", so, *objs]])
    lib = ctypes.CDLL(so)
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = list(build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


# The rev_heun kernels' in-turns cases, (tag, dtype, B, d): the training
# state at batch 64 and 1024 (draws: one key over the (B, 17) state) and the
# serving bucket (draws: a key a row).
REV_TIMED = [("train B64", torch.float32, 64, 17), ("train B1024", torch.float32, 1024, 17),
             ("train B64", torch.float64, 64, 17), ("train B1024", torch.float64, 1024, 17),
             ("serve B1024", torch.float32, 1024, 16)]


def _rev_cases(ops, g, dev) -> tuple:
    """``(alone, path, before)`` for REV_TIMED: ``{case: call}`` of each
    kernel alone; ``{case: call}`` of the redesigned ones behind the launch
    that precedes them on the main path; and ``{path case: that predecessor
    alone}``.  ``brownian_increment`` and ``rev_heun_phase2`` follow the
    diffusion field's ``fused_mlp`` launch (B × 17 -> 32 -> 16, float32:
    where the forward and the reconstruction put ``rev_heun_phase2`` and
    the GAN solve its draws); ``rev_heun_phase1_gen`` follows
    ``rev_heun_phase2`` (the forward's order; sign +1 and, at the training
    shapes, -1, the reconstruction's draw); ``rev_heun_bwd_phase1`` follows
    ``rev_heun_phase1`` (the backward's ``_fused_local_vjp``), and, at the
    training shapes, ``rev_heun_phase1`` follows ``rev_heun_phase2`` at sign
    -1 (the reconstruction) and ``rev_heun_bwd_phase2`` the field VJP's last
    kernel, autograd's sum of ẑ₁'s gradients (a ``CUDAFunctor_add``, as
    ``path_predecessors`` reads the ELBO step)."""
    alone, path, before = {}, {}, {}
    for tag, dtype, B, d in REV_TIMED:
        for name, (call, pred, pred_name) in _rev_kernels(ops, g, dev, dtype, B, d).items():
            case = f"{name} {tag} {str(dtype)[6:]}"
            alone[case] = call
            if pred is not None:
                pcase = f"{case} after {pred_name}"
                path[pcase] = lambda call=call, pred=pred: (pred(), call())
                before[pcase] = pred
    return alone, path, before


def _rev_kernels(ops, g, dev, dtype, B: int, d: int) -> dict:
    """One REV_TIMED case of ``_rev_cases``: ``{name: (call, predecessor
    call or None, predecessor's name)}`` on fresh operands."""
    dt = 1.0 / 23
    train = d == 17
    keys = torch.randint(0, 2 ** 32, (1 if train else B, 2), generator=g,
                         dtype=torch.int64).to(dev)
    gen_keys = keys[0] if train else keys  # one key over the (B, 17) state
    st = [torch.randn(B, d, generator=g, dtype=dtype).to(dev) for _ in range(7)]
    z, zh, mu, sg, mu1, sg1, dw = st
    x, *w = _mlp_operands(g, dev, torch.float32, B, 17, 32, 16)
    shape = (B * d,) if train else (d,)

    def field():
        return ops.fused_mlp(x, *w)

    def phase2():
        return ops.rev_heun_phase2(*st[:6], dt)

    def phase1():
        return ops.rev_heun_phase1(z, zh, mu, sg, dw, dt)

    def reconstruction():  # the backward's rev_heun_phase2 at sign -1
        return ops.rev_heun_phase2(*st[:6], dt, -1.0)

    kernels = {
        "rev_heun_phase2": (phase2, field, "fused_mlp"),
        "brownian_increment": (lambda: ops.brownian_increment(keys, 7, shape, dtype, dt),
                               field, "fused_mlp"),
        "rev_heun_bwd_phase1": (lambda: ops.rev_heun_bwd_phase1(z, mu1, sg1, dw, dt),
                                phase1, "rev_heun_phase1")}
    for sign in ((1.0, -1.0) if train else (1.0,)):
        kernels[f"rev_heun_phase1_gen sign {sign:+.0f}"] = (
            lambda sign=sign: ops.rev_heun_phase1_gen(z, zh, mu, sg, gen_keys, 7, dt, dt, sign),
            phase2, "rev_heun_phase2")
    if train:
        kernels["rev_heun_phase1"] = (phase1, reconstruction, "rev_heun_phase2 sign -1")
        # the field VJP's last kernel: autograd's sum of ẑ₁'s gradients
        kernels["rev_heun_bwd_phase2"] = (lambda: ops.rev_heun_bwd_phase2(z, zh, dw, dt),
                                          lambda: torch.add(mu1, sg1), "add (CUDAFunctor_add)")
    return kernels


def path_predecessors(dev, batch: int = 64, funcs=("phase1_kernel", "bwd_phase2_kernel"),
                      before: int = 3) -> dict:
    """Which device kernels run just before each of ``funcs`` on the main
    path: one fused ELBO step at ``batch`` (``_train_step``) under
    torch.profiler, its device events in start order; for each launch of a
    function, the names of the ``before`` kernels before it, counted.
    ``{func: {"k-th before": {name: count}}}``, printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = _train_step(dev, batch)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in sorted((e for e in prof.events()
                                     if e.device_type == DeviceType.CUDA),
                                    key=lambda e: e.time_range.start)]
    out = {}
    for func in funcs:
        at = [i for i, n in enumerate(names) if "::" + func + "<" in n]
        out[func] = {f"{k}-th before": dict(collections.Counter(
            names[i - k] for i in at if i >= k)) for k in range(1, before + 1)}
        out[func]["launches"] = len(at)
        print(f"path predecessors of {func} (ELBO step B {batch}): "
              f"{json.dumps(out[func])}", flush=True)
    print(f"card: {gpu_label()}", flush=True)
    return out


def _flat(out) -> list:
    """The tensors of a (nested) tuple of outputs, in order."""
    return [t for o in out for t in _flat(o)] if isinstance(out, tuple) else [out]


def kernels_in_turns(parent_root: str) -> dict:
    """The kernels this tree or the ones before it redesigned against the
    parent's build of them, through the port's launchers on one card:
    ``fused_mlp`` float32 at MLP_TIMED, ``space_time_value`` at ST_TIMED,
    ``space_time_increment`` at ST_INCREMENT_TIMED and the rev_heun kernels
    at REV_TIMED, alone and the redesigned ones in path order
    (``_rev_cases``), with the library built from the tree at
    ``parent_root`` and with this tree's, in turns (parent, this, this,
    parent), device and host ms a call by time_ms; the rev_heun and
    space_time_increment cases alone also by their device span on an idle
    card (span_us), which is what each launch of the eager training step
    costs.  A path-order case's kernel
    time is the pair's time less its predecessor's alone in the same
    turn.  Each output of this tree's kernels must be bitwise the parent's
    (every redesign keeps each element's op order).
    ``{case: {tree: [[device ms, host ms], ...]}}`` and ``{case + " [isolated
    span us]": {tree: [µs, ...]}}``, printed with the launch floor and the
    card.  Run it as ``python3 -c "import chip_smoke as
    C; C.kernels_in_turns('build/parent')"`` after unpacking the parent
    commit there (``git archive``)."""
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="parent_lib_")
    try:
        libs = {"parent": _parent_library(parent_root, tmp,
                                          ("rt_fused_mlp", "rt_space_time_value",
                                           "rt_space_time_increment", "rt_brownian_increment", "rt_rev_heun_phase2",
                                           "rt_rev_heun_phase1_gen", "rt_rev_heun_bwd_phase1",
                                           "rt_rev_heun_phase1", "rt_rev_heun_bwd_phase2")),
                "this": build.load()}
        g = torch.Generator().manual_seed(26)
        calls = {}
        for tag, rows, din, h, dout in MLP_TIMED:
            x, *w = _mlp_operands(g, dev, torch.float32, rows, din, h, dout)
            calls[f"fused_mlp {tag} f32 {(rows, din, h, dout)}"] = (
                lambda x=x, w=w: ops.fused_mlp(x, *w))
        keys = torch.randint(0, 2 ** 32, (1, 2), generator=g, dtype=torch.int64).to(dev)
        t = torch.tensor([0.4375], dtype=torch.float64, device=dev)
        for tag, depth in ST_TIMED:
            calls[tag] = lambda depth=depth: ops.space_time_value(
                keys, t, 0.0, 1.0, (256, 32), torch.float64, depth)
        alone, path, before = _rev_cases(ops, g, dev)
        for tag, dtype, rows, shape in ST_INCREMENT_TIMED:
            st_keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g,
                                    dtype=torch.int64).to(dev)
            alone[tag] = lambda st_keys=st_keys, dtype=dtype, shape=shape: (
                ops.space_time_increment(st_keys, 7, shape, dtype, 1.0 / 23))
        calls.update(alone)
        outs = {}
        for tree in ("parent", "this"):
            with _library(libs[tree]):
                outs[tree] = {case: fn() for case, fn in {**calls, **path}.items()}
        torch.cuda.synchronize()
        for case in outs["this"]:
            a, b = _flat(outs["parent"][case]), _flat(outs["this"][case])
            check(len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b)),
                  f"kernels_in_turns {case}: this tree's kernel differs from the parent's")
        timed_calls = {**calls, **path, **{c + " [predecessor alone]": f
                                           for c, f in before.items()}}
        runs = {case: {"parent": [], "this": []} for case in timed_calls}
        for tree in ("parent", "this", "this", "parent"):
            with _library(libs[tree]):
                for case, fn in timed_calls.items():
                    runs[case][tree].append(list(time_ms(fn)))
        spans = {case: {"parent": [], "this": []} for case in alone}
        for tree in ("parent", "this", "this", "parent"):
            with _library(libs[tree]):
                for case, fn in alone.items():
                    spans[case][tree].append(span_us(fn))
        for case, r in spans.items():
            print(f"isolated span {case}: parent {statistics.median(r['parent']):.3f} us, "
                  f"this {statistics.median(r['this']):.3f} us; runs {r}", flush=True)
        for tag, dtype, rows, shape in ST_INCREMENT_TIMED:
            b_ms, b_by = st_increment_bound(rows, math.prod(shape), dtype)
            print(f"bound {tag}: {b_ms:.7f} ms ({b_by})", flush=True)
        for case in path:  # the kernel's share of the pair, turn by turn
            pred = runs.pop(case + " [predecessor alone]")
            runs[case] = {tree: [[p[0] - f[0], p[1] - f[1]] for p, f in zip(r, pred[tree])]
                          for tree, r in runs[case].items()}
        floor = launch_floor()
        for case, r in runs.items():
            med = {tree: [statistics.median(v[i] for v in r[tree]) for i in (0, 1)]
                   for tree in r}
            print(f"in turns {case}: parent {med['parent'][0]:.5f} ms (host "
                  f"{med['parent'][1]:.5f}), this {med['this'][0]:.5f} ms (host "
                  f"{med['this'][1]:.5f}); runs {r}", flush=True)
        print(f"outputs of this tree's kernels bitwise the parent's in every case; launch "
              f"floor {floor['launch_floor_ms']:.5f} ms; card: {gpu_label()}", flush=True)
        return {**runs, **{case + " [isolated span us]": r for case, r in spans.items()}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rev_heun_launcher_costs(dev) -> dict:
    """The host cost of a ``brownian_increment`` call (one key over 1024 ×
    17, float32) and a ``rev_heun_phase2`` call (1024 × 17, float32), piece
    by piece as :func:`launcher_costs` reads ``fused_mlp``'s: the checks
    (and the same checks as one pass on device indices), the output (and
    the allocations the launcher made before, or could make), the stream
    lookup (the raw handle, and the Stream object the launchers built
    before), the device guard, the ctypes call (with the kernel's
    enqueue), and the whole launcher and dispatch.  µs a call."""
    from repro_torch.kernels import brownian as bk, build, ops
    from repro_torch.kernels import reversible_heun_step as rh

    g = torch.Generator().manual_seed(7)
    keys = torch.randint(0, 2 ** 32, (1, 2), generator=g, dtype=torch.int64).to(dev)
    st = [torch.randn(1024, 17, generator=g).to(dev) for _ in range(7)]
    z = st[0]
    lib = build.load()
    idx = dev.index or 0
    stream = rh._stream(z)
    inc_out = torch.empty(1, 1024 * 17, device=dev)
    inc_args = (0, keys.data_ptr(), 7, 1.0 / 23, inc_out.data_ptr(), 1, 1024 * 17, stream)
    p2_args = (0, *(t.data_ptr() for t in st[:6]), 1.0 / 23, 1.0, st[6].data_ptr(),
               1024 * 17, stream)

    def one_pass(ref, others):  # the checks as one pass on device indices
        shape, dtype, index = ref.shape, ref.dtype, ref.get_device()
        for t in (ref, *others):
            if (t.shape != shape or t.dtype != dtype or t.get_device() != index
                    or not t.is_contiguous()):
                raise ValueError("operands differ")

    pieces = {
        "increment checks (_check_keys)": lambda: bk._check_keys("brownian_increment", keys,
                                                                 keys.device),
        "increment output: keys.new_empty(shape, dtype)":
            lambda: keys.new_empty((1, 1024 * 17), dtype=torch.float32),
        "increment output: torch.empty(shape, dtype, device) (parent)":
            lambda: torch.empty((1, 1024 * 17), dtype=torch.float32, device=keys.device),
        "increment output: torch.empty(shape, dtype, device=index)":
            lambda: torch.empty((1, 1024 * 17), dtype=torch.float32, device=idx),
        "increment ctypes: rt_brownian_increment (+ kernel enqueue)":
            lambda: lib.rt_brownian_increment(*inc_args),
        "increment launcher (kernels/brownian.py)":
            lambda: bk.brownian_increment(keys, 7, (1024 * 17,), torch.float32, 1.0 / 23),
        "increment dispatch (ops.brownian_increment)":
            lambda: ops.brownian_increment(keys, 7, (1024 * 17,), torch.float32, 1.0 / 23),
        "phase2 checks (check_operands, 6 operands)":
            lambda: rh.check_operands("rev_heun_phase2", z, st[1:6]),
        "phase2 checks, one pass on get_device()": lambda: one_pass(z, st[1:6]),
        "phase2 output: torch.empty_like": lambda: torch.empty_like(z),
        "phase2 scalars: scalar(dt), scalar(sign)": lambda: (rh.scalar(1.0 / 23),
                                                            rh.scalar(1.0)),
        "phase2 x.data_ptr() x7": lambda: [t.data_ptr() for t in st],
        "phase2 ctypes: rt_rev_heun_phase2 (+ kernel enqueue)":
            lambda: lib.rt_rev_heun_phase2(*p2_args),
        "phase2 launcher (kernels/reversible_heun_step.py)":
            lambda: rh.rev_heun_phase2(*st[:6], 1.0 / 23),
        "phase2 dispatch (ops.rev_heun_phase2)": lambda: ops.rev_heun_phase2(*st[:6], 1.0 / 23),
        "stream: raw handle (rh._stream)": lambda: rh._stream(z),
        "stream: torch.cuda.current_stream(dev).cuda_stream (parent)":
            lambda: torch.cuda.current_stream(z.device).cuda_stream,
        "device guard (the device's index)": lambda: build.device_guard(idx).__enter__(),
        "device guard (z.device)": lambda: build.device_guard(z.device).__enter__(),
    }
    costs = {name: host_us(fn) for name, fn in pieces.items()}
    for name, us in costs.items():
        print(f"rev_heun launcher host cost: {name}: {us:.2f} us", flush=True)
    print(f"card: {gpu_label()}", flush=True)
    return costs


# Cut points of fused_mlp_bwd for mlp_bwd_split, (label, [(anchor, code),
# ...]): the variant "cut after <label>" inserts each `code` after the first
# occurrence of its `anchor` in the source, so that every block ends there
# (a `continue` skips the rest of a tile; no cut falls between a block's
# sends and the wait for its own slice, so no block leaves while others
# still write into its shared memory).  PARENT_BWD_CUTS fit the backward
# before its cluster design (one tile a block, global partials, a ticket,
# the last block's pass), as in a parent tree unpacked beside this one;
# BWD_CUTS fit the cluster kernel.
PARENT_BWD_CUTS = [
    ("staging (W1, W1ᵀ, W2ᵀ, b1)",
     [("for (int e = tid; e < hidden; e += kBwdThreads) b1s[e] = b1[e];\n  }\n",
       "  __syncthreads();\n  return;\n")]),
    ("the tile (x, g loads and the products)",
     [("    __syncthreads();  // the next tile overwrites xs, gs, as, ds\n  }\n",
       "  return;\n")]),
    ("the partial write, fence and ticket",
     [("  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;  // a ticket, not a sum\n"
       "  __syncthreads();\n", "  if (tid == 0 && last) *ticket = 0u;\n  return;\n")]),
]
_BWD_REDUCTION = "  // -- the cluster reduction --\n"
BWD_CUTS = [
    ("the launch", [("  cg::cluster_group cluster = cg::this_cluster();\n", "  return;\n")]),
    ("the loads (cp.async issued at once, one wait)",
     [("  tc::cp_async_wait<0>();\n  __syncthreads();\n", "  return;\n")]),
    ("step 1 of the tiles (pre, da, a, dpre)",
     [("    // 2. the sums over the tile's rows", "    continue;\n"),
      (_BWD_REDUCTION, "  return;\n")]),
    ("the wait for the slices (mbarrier)",
     [("    tc::mbar_wait(bar, 0);  // every block's slice for me has arrived\n",
       "    return;\n")]),
]


# A throwaway library's function-local statics stay its own (g++ makes those
# of inline template functions process-wide STB_GNU_UNIQUE symbols, so a
# second library loaded beside the first would share its state).
_LOCAL_STATICS = ("-Xcompiler", "-fno-gnu-unique")


def mlp_bwd_split(cu_path: str, cuts,
                  shapes=((64, 17, 32, 16), (1024, 17, 32, 16))) -> dict:
    """Where one fused_mlp_bwd launch's time goes, float32:
    :func:`source_variants` of the backward's source at ``cu_path``, as it
    is and cut after each of ``cuts`` (PARENT_BWD_CUTS or BWD_CUTS: each
    `code` inserted after the line that ends its `anchor`), at ``shapes``
    (R, Din, H, Dout).  A variant computes only what precedes its cut, so
    the differences between consecutive variants are the stages' times.
    -> {"R×Din→H→Dout f32": {variant: [ms, ms]}}"""
    src = open(cu_path).read()
    variants = []
    for label, inserts in cuts:
        edits = []
        for anchor, code in inserts:
            at = src.find(anchor)
            check(at >= 0, f"mlp_bwd_split: no anchor {anchor!r} for {label!r} in {cu_path}")
            line = src[at:src.index("\n", at + len(anchor) - 1) + 1]
            edits.append((line, line + code))
        variants.append((f"cut after {label}", edits, False))

    def cases(dev):
        scratch = torch.zeros(4 << 20, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for rows, din, h, dout in shapes:
            g0 = torch.Generator().manual_seed(7)
            x, *w = _mlp_operands(g0, dev, torch.float32, rows, din, h, dout)
            g = torch.randn(rows, dout, generator=g0).to(dev)
            grads = [torch.empty_like(t) for t in (x, *w)]
            args = (0, x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
                    g.data_ptr(), dout, 1, *(t.data_ptr() for t in grads), scratch.data_ptr(),
                    scratch.numel(), rows, din, h, dout, stream)

            def run(fn, args=args, grads=grads):
                check(fn(*args) == 0, "mlp_bwd_split: the launch failed")
                return grads
            yield f"{rows}x{din}->{h}->{dout} f32", run

    return source_variants(cu_path, "rt_fused_mlp_bwd", variants, cases, "fused_mlp_bwd")


# Stage marks of the cluster kernel for mlp_bwd_stamps, (label, anchor):
# thread 0 of every block records clock64 and %globaltimer after the line
# that ends each anchor.
BWD_MARKS = [
    ("start", "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("the mbarrier's set-up", "  tc::cluster_arrive_relaxed();  // my barrier is ready"),
    ("the loads issued", "    pad_cols(ds, d.sd, tile, hidden, d.dc, -1);\n"),
    ("the loads waited for", "  tc::cp_async_wait<0>();\n  __syncthreads();\n"),
    ("the cluster wait", "  tc::cluster_wait();  // every block's barrier is ready"),
    ("tile's loads (the last tile's)", "    const int mt = (nr + M - 1) / M;"),
    ("step 1: pre, da", "    // a and dpre, a thread an element"),
    ("step 1: a, dpre", "    // 2. the sums over the tile's rows"),
    ("step 2: warp 0's first product", "tc::smem_addr(xs + n0), d.sx * es, es, kr);"),
    ("step 2 (warp 0)", _BWD_REDUCTION),
    ("the slices arrive", "    tc::mbar_wait(bar, 0);  // every block's slice for me has"),
    ("end", "    else db2[e - n_w1 - hidden - n_w2] = o;\n  }\n"),
]
# Stage marks of the forward for mlp_fwd_stamps, (label, anchor): in the
# fixed-width kernel (FWD_MARKS) and in the runtime-width kernel the
# forward had before it (PARENT_FWD_MARKS, also this tree's generic path).
FWD_MARKS = [
    ("start", "  const int nr = static_cast<int>(rows - row0 < kFixedRows ? rows - row0 : "
              "kFixedRows);\n"),
    ("the copies issued (cp.async)", "  repro_torch_tc::cp_async_commit();\n"),
    ("the copies waited for", "  repro_torch_tc::cp_async_wait<0>();\n  __syncthreads();\n"),
    ("layer 1: pre, a (warp 0)", "  __syncwarp();\n"),
    ("layer 2 and the store (warp 0)",
     "        out[(row0 + r) * DOUT + j] = from_acc<T, Acc>(acc[q][m] + to_acc(b2s[j]));\n"
     "      }\n    }\n  }\n"),
]
PARENT_FWD_MARKS = [
    ("start", "  const int nr = static_cast<int>(rows - row0 < tile ? rows - row0 : tile);\n"),
    ("the weights and x staged",
     "  for (int e = tid; e < nr * din; e += kThreads) xs[e] = load(xb + e);\n"
     "  __syncthreads();\n"),
    ("pass 1: pre, a", "    as[e] = to_acc(from_acc<T, Acc>(lipswish(pre)));\n  }\n"
                       "  __syncthreads();\n"),
    ("pass 2: out", "    ob[e] = from_acc<T, Acc>(acc + (kStaged ? to_acc(b2s[j]) : "
                    "load(b2 + j)));\n  }\n"),
]
# Stage marks of space_time_value for st_value_stamps, (label, anchor,
# recording thread): the pipelined kernel (ST_MARKS: the walker is thread
# 0, the combiner thread 128, drawer 1 (warp 2) thread 64) and the one it
# replaced (PARENT_ST_MARKS).
ST_MARKS = [
    ("start", "  if (tid == 0) walked = combined = tail_ready = 0;\n  __syncthreads();\n", 0),
    ("the root pair (combiner)", "      area = mul(span, add(hr, mul(T(0.5), w)));\n    }\n", 128),
    ("the walk (walker)", "    publish(&tail_ready, 1, lane);\n", 0),
    ("drawer 1's levels (warp 2)", "      publish(&drawn[l % kStRing], l + 1, lane);\n    }\n", 64),
    ("the levels' combine (combiner)", "      publish(&combined, l + 1, lane);\n    }\n", 128),
    ("the tail and the store (combiner)",
     "                   mul(sub(mul(T(3), th2), mul(T(2), th3)), area));\n", 128),
]
PARENT_ST_MARKS = [
    ("start", "  const int nr = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);\n"),
    ("1. the walk",
     "  __syncthreads();\n  // 2. the levels' keys and scales, and the root's keys\n"),
    ("2. the keys", "  __syncthreads();\n  // 3. combine: element e of row r\n"),
    ("3. the draws and the combine, a thread an element, and the store",
     "                 mul(sub(mul(T(3), th2), mul(T(2), th3)), area));\n"),
]
_STAMP_BLOCKS, _STAMP_MARKS = 1024, 16
_STAMPS = r"""
__device__ long long repro_stamps[1024 * 16 * 2];
#define REPRO_STAMP(k, th) do { if (threadIdx.x == (th) && blockIdx.x < 1024) { \
  unsigned long long n_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n_)); \
  repro_stamps[(blockIdx.x * 16 + (k)) * 2] = clock64(); \
  repro_stamps[(blockIdx.x * 16 + (k)) * 2 + 1] = (long long)n_; } } while (0)
extern "C" int repro_read_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, repro_stamps, sizeof(repro_stamps));
}
extern "C" int repro_clear_stamps(void) {
  static long long zero[1024 * 16 * 2];
  return (int)cudaMemcpyToSymbol(repro_stamps, zero, sizeof(zero));
}
"""


def kernel_stamps(cu_path: str, entry: str, marks, cases, what: str, runs: int = 21,
                  edits=()) -> dict:
    """Where one launch's time goes inside its blocks: the source at
    ``cu_path`` built once more (a throwaway library in a temporary
    directory; the repo's kernels are not touched) with one thread of every
    block recording clock64 and %globaltimer after each of ``marks``
    ((label, anchor[, thread]): after the line that ends the anchor, thread
    0 unless given).  ``cases``
    is a function of the card and the loaded library's entry point
    returning ``[(tag, call)]``, ``call()`` one launch of ``entry`` that
    returns its error code; ``runs`` synchronised launches each, the
    stamps cleared before each; ``edits`` ((old, new) pairs, a variant's)
    change the source first.  Prints, for block 0 and the block whose
    stages sum to the most, the median cycles and ns from one mark it
    passed to the next (a block that skips a mark skips its stage) and the
    start's lag behind the earliest block.  -> {tag: {block: {stage:
    [cycles, ns, ns since the start], "start_lag_ns": ns}}}"""
    import ctypes

    from repro_torch.kernels import build

    check(len(marks) <= _STAMP_MARKS, f"{what} stamps: at most {_STAMP_MARKS} marks")
    text = open(cu_path).read()
    for old, new in edits:  # a variant's (ST_VARIANTS), applied before the marks
        check(old in text, f"{what} stamps: no {old!r} in {cu_path}")
        text = text.replace(old, new, 1)
    at = text.index("\nnamespace ") + 1  # the stamps at file scope, before the kernels
    text = text[:at] + _STAMPS + text[at:]
    for k, (label, anchor, *thread) in enumerate(marks):
        at = text.find(anchor)
        check(at >= 0, f"{what} stamps: no anchor for {label!r} in {cu_path}")
        at = text.index("\n", at + len(anchor) - 1) + 1
        text = text[:at] + f"  REPRO_STAMP({k}, {thread[0] if thread else 0});\n" + text[at:]
    tmp = tempfile.mkdtemp(prefix="stamps_")
    try:
        cu, so = os.path.join(tmp, "stamps.cu"), os.path.join(tmp, "stamps.so")
        with open(cu, "w") as f:
            f.write(text)
        build._run_all([[build._nvcc(), *build.NVCC_FLAGS, *_LOCAL_STATICS, "-I",
                         os.path.dirname(os.path.abspath(cu_path)), "-shared", "-o", so, cu]])
        lib = ctypes.CDLL(so)
        fn = getattr(lib, entry)
        fn.argtypes = list(build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        dev = torch.device("cuda")
        size = _STAMP_BLOCKS * _STAMP_MARKS * 2
        buf = (ctypes.c_longlong * size)()
        slot = lambda b, k: (b * _STAMP_MARKS + k) * 2
        out = {}
        for tag, call in cases(dev, fn):
            samples = []
            for _ in range(runs):
                check(lib.repro_clear_stamps() == 0, f"{what} stamps: cannot clear the stamps")
                check(call() == 0, f"{what} stamps {tag}: the launch failed")
                torch.cuda.synchronize()
                check(lib.repro_read_stamps(buf) == 0, f"{what} stamps: no stamps")
                samples.append(list(buf))
            blocks = [b for b in range(_STAMP_BLOCKS) if all(s[slot(b, 0)] for s in samples)]
            out[tag] = {}
            for b in blocks:
                seen = [k for k in range(len(marks)) if all(s[slot(b, k)] for s in samples)]
                stages = {}
                for j, k in zip(seen, seen[1:]):
                    cyc = [s[slot(b, k)] - s[slot(b, j)] for s in samples]
                    ns = [s[slot(b, k) + 1] - s[slot(b, j) + 1] for s in samples]
                    at = [s[slot(b, k) + 1] - s[slot(b, seen[0]) + 1] for s in samples]
                    stages[marks[k][0]] = [statistics.median(cyc), statistics.median(ns),
                                           statistics.median(at)]
                lag = statistics.median(s[slot(b, 0) + 1] - min(s[slot(q, 0) + 1] for q in blocks)
                                        for s in samples)
                out[tag][b] = dict(stages, start_lag_ns=lag)
            slowest = max(out[tag], key=lambda b: sum(
                v[1] for k, v in out[tag][b].items() if k != "start_lag_ns"))
            for b in sorted({0, slowest}):
                print(f"{what} stamps {tag} block {b} of {len(blocks)}: start lag "
                      f"{out[tag][b]['start_lag_ns']:.0f} ns; "
                      + "; ".join(f"{k} {v[0]:.0f} cycles / {v[1]:.0f} ns (at {v[2]:.0f})"
                                  for k, v in out[tag][b].items() if k != "start_lag_ns"),
                      flush=True)
        print(f"card: {gpu_label()}", flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mlp_bwd_stamps(cu_path: str, marks, shapes=((64, 17, 32, 16), (1024, 17, 32, 16)),
                   runs: int = 21) -> dict:
    """:func:`kernel_stamps` of one fused_mlp_bwd launch, float32, at
    ``shapes`` (R, Din, H, Dout), marks BWD_MARKS."""
    def cases(dev, fn):
        scratch = torch.zeros(4 << 20, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for rows, din, h, dout in shapes:
            g0 = torch.Generator().manual_seed(7)
            x, *w = _mlp_operands(g0, dev, torch.float32, rows, din, h, dout)
            g = torch.randn(rows, dout, generator=g0).to(dev)
            grads = [torch.empty_like(t) for t in (x, *w)]
            args = (0, x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),
                    g.data_ptr(), dout, 1, *(t.data_ptr() for t in grads), scratch.data_ptr(),
                    scratch.numel(), rows, din, h, dout, stream)
            yield f"{rows}x{din}->{h}->{dout} f32", lambda: fn(*args)

    return kernel_stamps(cu_path, "rt_fused_mlp_bwd", marks, cases, "fused_mlp_bwd", runs)


def mlp_fwd_stamps(cu_path: str, marks, shapes=((64, 17, 32, 16), (1024, 17, 32, 16)),
                   runs: int = 21) -> dict:
    """:func:`kernel_stamps` of one fused_mlp launch, float32, at ``shapes``
    (R, Din, H, Dout): marks FWD_MARKS for this tree's source,
    PARENT_FWD_MARKS for the runtime-width kernel it replaced (a parent
    tree's source).  Run it as ``python3 -c "import chip_smoke as C;
    C.mlp_fwd_stamps('src/repro_torch/kernels/csrc/fused_mlp.cu',
    C.FWD_MARKS)"``."""
    def cases(dev, fn):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for rows, din, h, dout in shapes:
            x, *w = _mlp_operands(torch.Generator().manual_seed(7), dev, torch.float32, rows,
                                  din, h, dout)
            o = torch.empty(rows, dout, device=dev)
            args = (0, *(t.data_ptr() for t in (x, *w, o)), rows, din, h, dout, stream)
            yield f"{rows}x{din}->{h}->{dout} f32", lambda: fn(*args)

    return kernel_stamps(cu_path, "rt_fused_mlp", marks, cases, "fused_mlp", runs)


def st_value_stamps(cu_path: str, marks, depths=(10, 24), runs: int = 21, edits=()) -> dict:
    """:func:`kernel_stamps` of one space_time_value launch at row 13's
    shape (one key over (256, 32), float64) and ``depths``: marks ST_MARKS
    for this tree's source (``edits``: an ST_VARIANTS entry's),
    PARENT_ST_MARKS for the kernel it replaced."""
    from repro_torch.kernels.ref import space_time_scales

    def cases(dev, fn):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys = torch.tensor([[12345, 678]], dtype=torch.int64, device=dev)
        t = torch.tensor([0.4375], dtype=torch.float64, device=dev)
        w, i = (torch.empty(1, 256 * 32, dtype=torch.float64, device=dev) for _ in range(2))
        s_w, s_h = space_time_scales(1.0, torch.float64)
        for depth in depths:
            args = (1, keys.data_ptr(), t.data_ptr(), 0.0, 1.0, 1.0, s_w, s_h, depth,
                    w.data_ptr(), i.data_ptr(), 1, 256 * 32, stream)
            yield f"1x(256, 32) f64 depth {depth}", lambda: fn(*args)

    return kernel_stamps(cu_path, "rt_space_time_value", marks, cases, "space_time_value", runs,
                         edits)


# Source variants for source_variants, (label, [(old, new), ...], exact):
# the first `old` is replaced by `new`; an exact variant must give the
# unchanged source's bits.  FWD_VARIANTS cut fused_mlp's fixed-width
# kernel short (where a launch's device time goes) or change its staging;
# ST_VARIANTS change space_time_value's waits, block, ring and walk.
_FWD_START = ("  const int nr = static_cast<int>(rows - row0 < kFixedRows ? rows - row0 : "
              "kFixedRows);\n")
_FWD_WAIT = "  repro_torch_tc::cp_async_wait<0>();\n  __syncthreads();\n"
FWD_VARIANTS = [
    ("cut at the start", [(_FWD_START, _FWD_START + "  return;\n")], False),
    ("cut after the copies", [(_FWD_WAIT, _FWD_WAIT + "  return;\n")], False),
    ("16-byte loads and stores in place of cp.async",
     [("      repro_torch_tc::cp_async16(repro_torch_tc::smem_addr(reinterpret_cast<char*>(dst)"
       " + 16 * c),\n                                 reinterpret_cast<const char*>(src) + 16 * "
       "c, 16);\n",
       "      *reinterpret_cast<int4*>(reinterpret_cast<char*>(dst) + 16 * c) =\n"
       "          *reinterpret_cast<const int4*>(reinterpret_cast<const char*>(src) + 16 * c);\n")],
     True),
    ("x staged first",
     [("  stage(w1s, w1, DIN * H, tid);\n", "  stage(xs, x + row0 * DIN, nr * DIN, tid);\n"
                                            "  stage(w1s, w1, DIN * H, tid);\n"),
      ("  stage(b2s, b2, DOUT, tid);\n  stage(xs, x + row0 * DIN, nr * DIN, tid);\n",
       "  stage(b2s, b2, DOUT, tid);\n")], True),
]
ST_VARIANTS = [
    ("the drawers wait for the walk's first kStRing levels (all of them at depth 10)",
     [("      while (ld_acquire(&walked) <= l) __nanosleep(32);\n",
       "      while (ld_acquire(&walked) < (depth < kStRing ? depth : kStRing)) __nanosleep(32);\n"
       "      while (ld_acquire(&walked) <= l) __nanosleep(32);\n")], True),
    ("the walker publishes every 4 levels",
     [("      publish(&walked, l + 1, lane);\n",
       "      if ((l + 1) % 4 == 0 || l + 1 == depth) publish(&walked, l + 1, lane);\n")], True),
    ("the combiner is warp 1",
     [("constexpr int kStCombineWarp = 4;", "constexpr int kStCombineWarp = 1;")], True),
    ("the drawers derive fold_in(c, 1)",
     [("        uint32_t f0 = ch0, f1 = ch1;  // the midpoint's key, off the chain\n"
       "        fold_in(f0, f1, 1);\n        sl.c0[lane] = f0;\n        sl.c1[lane] = f1;\n",
       "        sl.c0[lane] = ch0;\n        sl.c1[lane] = ch1;\n"),
      ("        uint32_t k0 = sl.c0[r], k1 = sl.c1[r];\n",
       "        uint32_t k0 = sl.c0[r], k1 = sl.c1[r];\n        fold_in(k0, k1, 1);\n")], True),
    ("publish after __threadfence_block",
     [("  __syncwarp();\n  if (lane == 0) st_release(flag, v);",
       "  __threadfence_block();\n  __syncwarp();\n  if (lane == 0) st_release(flag, v);")], True),
    ("the combiner sleeps while it waits",
     [("      while (ld_acquire(&drawn[l % kStRing]) <= l) {\n      }\n",
       "      while (ld_acquire(&drawn[l % kStRing]) <= l) __nanosleep(16);\n")], True),
    ("the drawers spin without sleeping",
     [("      while (ld_acquire(&walked) <= l) __nanosleep(32);\n",
       "      while (ld_acquire(&walked) <= l) {\n      }\n")], True),
    ("512 threads a block (14 drawer warps)",
     [("constexpr int kStThreads = 256;", "constexpr int kStThreads = 512;")], True),
    ("a ring of 32 levels", [("constexpr int kStRing = 16;", "constexpr int kStRing = 32;")], True),
    ("four blocks an SM (16 elements a block)",
     [("constexpr int kStTargetBlocks = kTargetBlocks;",
       "constexpr int kStTargetBlocks = 2 * kTargetBlocks;")], True),
]


def source_variants(cu_path: str, entry: str, variants, cases, what: str,
                    passes: int = 2) -> dict:
    """Device ms of ``entry`` built from the source at ``cu_path`` as it is
    and with each of ``variants`` (FWD_VARIANTS, ST_VARIANTS), each a
    throwaway library in a temporary directory (all built at once; the
    repo's kernels are not touched), timed by time_ms at each case in
    ``passes`` passes in alternating order.  ``cases`` is a function of the
    card returning ``[(tag, run)]``, ``run(fn)`` one launch through the
    entry point ``fn`` returning its output tensors; an exact variant's
    outputs must equal the unchanged source's bitwise.  Each pass also
    reads each variant's device span on an idle card (span_us, printed in
    µs).  -> {tag: {label: [ms, ...]}}"""
    import ctypes

    from repro_torch.kernels import build

    src = open(cu_path).read()
    texts = [("as it is", src, True)]
    for label, edits, exact in variants:
        text = src
        for old, new in edits:  # the first occurrence, as the stamps' anchors
            check(old in text, f"{what} variants: no {old!r} for {label!r} in {cu_path}")
            text = text.replace(old, new, 1)
        texts.append((label, text, exact))
    tmp = tempfile.mkdtemp(prefix="variants_")
    try:
        cmds, libs = [], []
        for i, (_, text, _) in enumerate(texts):
            cu = os.path.join(tmp, f"v{i}.cu")
            with open(cu, "w") as f:
                f.write(text)
            libs.append(os.path.join(tmp, f"v{i}.so"))
            cmds.append([build._nvcc(), *build.NVCC_FLAGS, *_LOCAL_STATICS, "-I",
                         os.path.dirname(os.path.abspath(cu_path)), "-shared", "-o", libs[-1],
                         cu])
        build._run_all(cmds)
        fns = []
        for path in libs:
            fn = getattr(ctypes.CDLL(path), entry)
            fn.argtypes = list(build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
            fns.append(fn)
        out = {}
        for tag, run in cases(torch.device("cuda")):
            want = run(fns[0])
            for (label, _, exact), fn in zip(texts, fns):
                got = run(fn)
                torch.cuda.synchronize()
                check(not exact or all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{what} variant {label!r} at {tag}: bits differ from the source's")
            times = {label: [] for label, _, _ in texts}
            span = {label: [] for label, _, _ in texts}
            for p in range(passes):
                order = range(len(fns)) if p % 2 == 0 else reversed(range(len(fns)))
                for i in order:
                    times[texts[i][0]].append(time_ms(lambda: run(fns[i]))[0])
                    span[texts[i][0]].append(span_us(lambda: run(fns[i])))
            out[tag] = times
            for label, ms in times.items():
                print(f"{what} variant {tag}: {label}: {' / '.join(f'{t:.5f}' for t in ms)} "
                      f"ms; isolated span {' / '.join(f'{t:.3f}' for t in span[label])} us",
                      flush=True)
        print(f"card: {gpu_label()}", flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fwd_variant_cases(dev):
    """source_variants cases of rt_fused_mlp: float32 at the training
    batches, 64 and 1024 rows of 17 -> 32 -> 16."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows in (64, 1024):
        x, *w = _mlp_operands(torch.Generator().manual_seed(7), dev, torch.float32, rows,
                              17, 32, 16)

        def run(fn, x=x, w=w, rows=rows):
            o = torch.zeros(rows, 16, device=dev)
            check(fn(0, *(t.data_ptr() for t in (x, *w, o)), rows, 17, 32, 16, stream) == 0,
                  "fused_mlp variant: launch failed")
            return (o,)
        yield f"{rows}x17->32->16 f32", run


def _st_variant_cases(dev):
    """source_variants cases of rt_space_time_value: row 13's one key over
    (256, 32), float64, depth 10 and 24."""
    from repro_torch.kernels.ref import space_time_scales

    stream = torch.cuda.current_stream(dev).cuda_stream
    keys = torch.tensor([[12345, 678]], dtype=torch.int64, device=dev)
    t = torch.tensor([0.4375], dtype=torch.float64, device=dev)
    s_w, s_h = space_time_scales(1.0, torch.float64)
    for depth in (10, 24):
        def run(fn, depth=depth):
            w, i = (torch.empty(1, 256 * 32, dtype=torch.float64, device=dev) for _ in range(2))
            check(fn(1, keys.data_ptr(), t.data_ptr(), 0.0, 1.0, 1.0, s_w, s_h, depth,
                     w.data_ptr(), i.data_ptr(), 1, 256 * 32, stream) == 0,
                  "space_time_value variant: launch failed")
            return w, i
        yield f"1x(256, 32) f64 depth {depth}", run


# Variants of rev_heun_phase1_gen's source for source_variants (exact: same
# bits): where its time goes on an idle card, the eager step's case.
GEN_VARIANTS = [
    ("a pair's second normal drawn only where it is an element (a branch between the two)",
     [("    w0 = mul(normal_f32_bits(x0), sqrt_dt);\n    w1 = mul(normal_f32_bits(x1), sqrt_dt);\n"
       "    return second < d;\n",
       "    w0 = mul(normal_f32_bits(x0), sqrt_dt);\n    if (second >= d) return false;\n"
       "    w1 = mul(normal_f32_bits(x1), sqrt_dt);\n    return true;\n")], True),
    ("the state loads after the draw",
     [("  const T z0 = z[e0], zh0 = zh[e0], mu0 = mu[e0], s0 = sigma[e0];\n"
       "  T z1 = T(0), zh_1 = T(0), mu1 = T(0), s1 = T(0);\n"
       "  if (pair) {\n    z1 = z[e1];\n    zh_1 = zh[e1];\n    mu1 = mu[e1];\n    s1 = sigma[e1];\n"
       "  }\n  T w0, w1;\n  const bool two = draw_unit(keys, n, b, j, units, d, sqrt_dt, w0, w1);\n",
       "  T w0, w1;\n  const bool two = draw_unit(keys, n, b, j, units, d, sqrt_dt, w0, w1);\n"
       "  const T z0 = z[e0], zh0 = zh[e0], mu0 = mu[e0], s0 = sigma[e0];\n"
       "  T z1 = T(0), zh_1 = T(0), mu1 = T(0), s1 = T(0);\n"
       "  if (pair) {\n    z1 = z[e1];\n    zh_1 = zh[e1];\n    mu1 = mu[e1];\n    s1 = sigma[e1];\n"
       "  }\n")], True),
    ("a plain launch (its griddepcontrol.wait then returns at once)",
     [("  return launch_dependent(phase1_gen_kernel<T, I>, (total + kThreads - 1) / kThreads, s,\n",
       "  phase1_gen_kernel<T, I><<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(\n"),
      ("                          static_cast<I>(d));\n}\n\ninline bool aligned16",
       "                          static_cast<I>(d));\n  return cudaGetLastError();\n}\n\n"
       "inline bool aligned16")], True),
]


def _gen_variant_cases(dev):
    """source_variants cases of rt_rev_heun_phase1_gen at sign +1: the
    training path's one key over 64 × 17 and 1024 × 17 (float32, and
    float64 at 1024), and the serving bucket, a key a row of 1024 × 16."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(29)
    for tag, dtype, rows, d in (("1x(64*17) f32", torch.float32, 1, 64 * 17),
                                ("1x(1024*17) f32", torch.float32, 1, 1024 * 17),
                                ("1x(1024*17) f64", torch.float64, 1, 1024 * 17),
                                ("1024x16 f32", torch.float32, 1024, 16)):
        keys, st = _operands(g, dev, dtype, rows, d)
        code = 0 if dtype == torch.float32 else 1

        def run(fn, keys=keys, st=st, code=code, rows=rows, d=d):
            zh1, dw = torch.empty_like(st[0]), torch.empty_like(st[0])
            check(fn(code, *(t.data_ptr() for t in st[:4]), keys.data_ptr(), 7, 1.0 / 23,
                     1.0 / 23, 1.0, zh1.data_ptr(), dw.data_ptr(), rows, d, stream) == 0,
                  "rev_heun_phase1_gen variant: launch failed")
            return zh1, dw
        yield tag, run


def launch_floor() -> dict:
    """The card's launch floor: the device time per launch of an empty
    kernel (``torch.cuda._sleep(0)``) back to back behind a stream hold, and
    the host time per launch, by CUDA events (time_ms)."""
    ms, host = time_ms(lambda: torch.cuda._sleep(0), reps=200)
    print(f"launch floor: torch.cuda._sleep(0) back to back {ms:.5f} ms a launch on the card "
          f"(host {host:.5f} ms a call)", flush=True)
    return {"launch_floor_ms": ms, "launch_floor_host_ms": host}


def _gan_params(dev, seed: int):
    from repro_torch.core.sde import NeuralSDEConfig, generator_init

    cfg = NeuralSDEConfig(**GAN_WIDTHS)
    return cfg, generator_init(torch.Generator().manual_seed(seed), cfg, device=dev)


def serve_adaptive_checks(ops, dev, label: str) -> dict:
    """Phase 10: adaptive SDE-GAN serving through serve_sde, with the
    brownian_value launches held against the loop iterations; padding
    invariance of both SDE-GAN samplers at buckets 1 and 1024."""
    from repro_torch.launch.steps import make_adaptive_terminal_step, make_sample_step
    from repro_torch.serving import serve_sde
    from repro_torch.serving.service import _request_keys
    from repro_torch.serving.types import Request, synthetic_requests

    serve = dict(max_batch=1024, requests=32, request_max=64, seed=5, collect=True)
    ops.reset_launch_counts()
    stats = serve_sde("sde-gan", adaptive=True, atol=1e-6, sde_steps=GAN_WIDTHS["num_steps"],
                      **serve)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    calls = stats["warmup_iterations"] + [b["iterations"] for b in stats["batch_log"]]
    expected = sum(1 + it for it in calls)
    print(f"[{label}] adaptive serve: {stats['traj_per_s']:.1f} traj/s overall, p50 "
          f"{stats['p50_s'] * 1e3:.2f} ms, p99 {stats['p99_s'] * 1e3:.2f} ms "
          f"({stats['trajectories']} rows in {stats['batches']} batches)", flush=True)
    for name, c in stats["per_class"].items():
        print(f"[{label}] adaptive serve class {name}: {c['rows']} rows, "
              f"{c['traj_per_s']:.1f} traj/s, p50 {c['p50_s'] * 1e3:.2f} ms, "
              f"p99 {c['p99_s'] * 1e3:.2f} ms", flush=True)
    for b in stats["batch_log"]:
        print(f"[{label}] adaptive batch: class {b['deadline_class']}, {b['rows']} rows "
              f"in bucket {b['bucket']}, rtol {b['rtol']}, {b['iterations']} loop "
              f"iterations", flush=True)
    print(f"[{label}] adaptive serving launches: {launches} (warm-up iterations "
          f"{stats['warmup_iterations']})", flush=True)
    check(launches["fused_mlp"] > 0, "fused_mlp was not launched on the adaptive service")
    check(launches["brownian_value"] == expected,
          f"brownian_value: {launches['brownian_value']} launches, expected {expected} "
          f"(1 + loop iterations per sampler call)")
    check(stats["classes_served"] == ["realtime", "interactive", "standard", "relaxed"],
          f"classes served: {stats['classes_served']}")
    for rid, y in stats["samples"].items():
        check(y.shape[1:] == (1,) and torch.isfinite(y).all().item(),
              f"adaptive request {rid}: bad sample {tuple(y.shape)}")
    print(f"[{label}] adaptive serve: {stats['non_converged']} rows out of budget",
          flush=True)

    cfg, params = _gan_params(dev, 6)
    others = list(synthetic_requests(20, 64, 7, adaptive=True))
    one = Request(rid=20, size=1, seed=424242, kind="terminal")
    batch = others + [one]
    row = sum(r.size for r in others)
    check(row + 1 <= 1024, "padding batch too large")
    big, small = _request_keys(batch, 1024, dev), _request_keys([one], 1, dev)
    paths = make_sample_step("sde-gan", cfg)
    terminal = make_adaptive_terminal_step(cfg)
    ops.reset_launch_counts()
    check(torch.equal(paths(params, small)[:, 0], paths(params, big)[:, row]),
          "fixed-grid SDE-GAN: bucket-1 row != its row in the 1024 bucket")
    n_fixed = ops.launch_counts()["fused_mlp"]
    ops.reset_launch_counts()
    y1, c1, s1 = terminal(params, small, 1e-2)
    y2, c2, s2 = terminal(params, big, 1e-2)
    n_adaptive = ops.launch_counts()["fused_mlp"]
    check(n_fixed > 0 and n_adaptive > 0, f"SDE-GAN samplers: fused_mlp launched {n_fixed} "
          f"(fixed grid) and {n_adaptive} (adaptive) times")
    print(f"[{label}] SDE-GAN samplers at buckets 1 and 1024: fused_mlp launched {n_fixed} "
          f"times (fixed grid, 2 calls) and {n_adaptive} (adaptive terminal, 2 calls)",
          flush=True)
    check(torch.equal(y1[0], y2[row]) and bool(c1[0] == c2[row]),
          "adaptive SDE-GAN: bucket-1 row != its row in the 1024 bucket")
    check(int(s1.num_accepted[0]) == int(s2.num_accepted[row])
          and int(s1.num_rejected[0]) == int(s2.num_rejected[row]),
          "adaptive SDE-GAN: the row's controller took other steps in the 1024 bucket")
    print(f"padding invariance: SDE-GAN fixed-grid and adaptive rows, bucket 1 == bucket "
          f"1024 (bitwise; the adaptive row: {int(s1.num_accepted[0])} accepted, "
          f"{int(s1.num_rejected[0])} rejected; the 1024 bucket took {s2.iterations} "
          f"iterations)", flush=True)
    profile_call(lambda: terminal(params, big, 1e-2), f"{label}] [adaptive terminal "
                                                      f"B=1024 rtol 1e-2")
    return dict(launches=launches, stats=stats)


GAN_SEQ = 32            # observations of the OU data (train_sde_gan's seq_len)
GAN_STEPS = 31          # solver steps (train_sde_gan's num_steps)
GAN_BATCHES = (128, 1024)  # examples/sde_gan_ou.py:27, benchmarks/clipping.py:40 "full"
GAN_SEED = 21


def _gan_problem(dev, batch: int, dtype=torch.float32, num_steps: int = GAN_STEPS, **kw):
    """train_sde_gan's config and fresh parameters (float ``dtype``), the
    real OU batch and the fake key a clip step draws -> (cfg, params, key, y_real)."""
    from repro_torch.core.sde import NeuralSDEConfig, discriminator_init, generator_init
    from repro_torch.data import ou_process
    from repro_torch.kernels import prng

    cfg = NeuralSDEConfig(data_dim=1, hidden_dim=16, noise_dim=4, width=32,
                          num_steps=num_steps, dtype=dtype, **kw)
    g = torch.Generator().manual_seed(GAN_SEED)
    params = {"gen": generator_init(g, cfg, device=dev),
              "disc": discriminator_init(g, cfg, device=dev)}
    key = prng.PRNGKey(GAN_SEED, device=dev)
    y_real = ou_process(prng.fold_in_key(key, 0), batch, GAN_SEQ, dtype=dtype)
    return cfg, params, prng.fold_in_key(key, 1), y_real


def _gan_step(dev, batch: int, constraint: str = "clip", num_steps: int = GAN_STEPS):
    """``run()`` takes one SDE-GAN step (make_sde_gan_step) from fresh
    parameters at train_sde_gan's widths, float32."""
    from repro_torch.kernels import prng
    from repro_torch.launch.steps import make_gan_optimizers, make_sde_gan_step

    cfg, params, _, _ = _gan_problem(dev, batch, num_steps=num_steps)
    (gi, gu), (di, du) = make_gan_optimizers(1.0, constraint)
    step = make_sde_gan_step(cfg, gu, du, batch, GAN_SEQ, constraint=constraint, device=dev)
    state = (params, gi(params["gen"]), di(params["disc"]))
    key = prng.PRNGKey(GAN_SEED + 1, device=dev)
    return lambda: step(*state, key)


def _check_gan_launches(got: dict, want: dict, what: str) -> None:
    for name, n in got.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, expected "
                                      f"{want.get(name, 0)}")


def _rel_err(got, want) -> float:
    return (sum((a - b).abs().sum().item() for a, b in zip(got, want))
            / sum(b.abs().sum().item() for b in want))


def _two_pull_grads(params, cfg, key, y_real, batch: int):
    """The reference's two cotangent pulls over ``gan_losses`` (``gen_loss``
    over the generator, then ``disc_loss`` over the discriminator), the
    check of ``sde_gan_grads``' one pull -> the same 4-tuple."""
    from repro_torch import tree
    from repro_torch.core.sde import gan_losses

    (gen, gspec), (disc, dspec) = tree.flatten(params["gen"]), tree.flatten(params["disc"])
    gen = [x.detach().requires_grad_() for x in gen]
    disc = [x.detach().requires_grad_() for x in disc]
    gl, dl, _ = gan_losses({"gen": tree.unflatten(gspec, gen),
                            "disc": tree.unflatten(dspec, disc)},
                           cfg, key, y_real, batch, paths=False)
    gg = torch.autograd.grad(gl, gen, retain_graph=True)
    dg = torch.autograd.grad(dl, disc)
    return (gl.detach(), dl.detach(), tree.unflatten(gspec, list(gg)),
            tree.unflatten(dspec, list(dg)))


def gan_checks(ops, dev, label: str) -> dict:
    """Phase 11b: the SDE-GAN training step (the second half of the main
    path), float32 at train_sde_gan's widths, batch 128 and 1024.  Returns
    the launches counted in one clip step (step 3 at batch 128, no sig-MMD
    log) and its timings."""
    from repro_torch import tree
    from repro_torch.core import clipping
    from repro_torch.core.sde import gradient_penalty
    from repro_torch.kernels import prng
    from repro_torch.launch.steps import sde_gan_grads
    from repro_torch.launch.train import train_sde_gan
    from repro_torch.serving import serve_sde

    never = 10 ** 9  # log_every: the sig-MMD log at step 0 only
    step_launches = {}
    for batch in GAN_BATCHES:
        full_params, full = train_sde_gan(3, batch, seed=GAN_SEED, log_every=never,
                                          device=dev)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-gan-") as tmp:
            for k in (1, 2, 3):  # one step a call, each resuming the last
                ops.reset_launch_counts()
                params, hist = train_sde_gan(k, batch, tmp, ckpt_every=1, seed=GAN_SEED,
                                             log_every=never, device=dev)
                torch.cuda.synchronize()
                want = dict(GAN_STEP_LAUNCHES)
                if k == 1:  # the sig-MMD log of step 0
                    want = {n: want[n] + GAN_LOG_LAUNCHES[n] for n in want}
                counts = ops.launch_counts()
                _check_gan_launches(counts, want, f"sde-gan clip step {k} at B={batch}")
                if k == 3:  # a step without the log: the kernels line's gan_launches
                    step_launches[batch] = counts
                rec = hist[0]
                check(len(hist) == 1 and rec["step"] == k - 1
                      and all(map(math.isfinite, (v for n, v in rec.items() if n != "step"))),
                      f"sde-gan step {k} at B={batch}: bad metrics {hist}")
                viol = {n: clipping.per_layer_violation(params["disc"][n]).item()
                        for n in ("f", "g", "xi")}
                check(max(viol.values()) <= 1.0,
                      f"sde-gan step {k} at B={batch}: a clipped layer left its box {viol}")
                print(f"[{label}] sde-gan clip step {k} (B={batch}, train_sde_gan resuming "
                      f"from step {k - 1}): {rec}; per-layer violation {viol}", flush=True)
            check(rec == full[2] and all(torch.equal(a, b) for a, b in zip(
                tree.leaves(params), tree.leaves(full_params))),
                  f"sde-gan B={batch}: step 3 after a resume != the uninterrupted run's "
                  f"({rec} vs {full[2]})")
            served = serve_sde("sde-gan", tmp, max_batch=64, requests=4, request_max=16,
                               seed=12, collect=True)
        for rid, ys in served["samples"].items():
            check(ys.shape[0] == GAN_STEPS + 1 and ys.shape[2] == 1
                  and torch.isfinite(ys).all().item(),
                  f"sde-gan bundle, request {rid}: bad trajectory {tuple(ys.shape)}")
        print(f"[{label}] sde-gan B={batch}: launches per clip step {GAN_STEP_LAUNCHES} "
              f"(the sig-MMD log {GAN_LOG_LAUNCHES}), every other kernel 0; step 3 after "
              f"a resume bitwise the uninterrupted run's; the bundle served "
              f"{served['trajectories']} trajectories", flush=True)

    # one pull of both players' gradients == the reference's two pulls
    cfg, params, key, y_real = _gan_problem(dev, GAN_BATCHES[0])
    one = tree.leaves(sde_gan_grads(params, cfg, key, y_real, GAN_BATCHES[0]))
    two = tree.leaves(_two_pull_grads(params, cfg, key, y_real, GAN_BATCHES[0]))
    check(all(torch.equal(a, b) for a, b in zip(one, two)),
          f"sde-gan: one-pull gradients != two pulls (max |Δ| "
          f"{max((a - b).abs().max().item() for a, b in zip(one, two))})")
    # the fields through fused_mlp against the layer loop
    with plain_mlp():
        plain = tree.leaves(sde_gan_grads(params, cfg, key, y_real, GAN_BATCHES[0]))
    worst = 0.0
    for a, b in zip(one, plain):
        tol = MLP_TOL[torch.float32]
        atol = max(tol, tol * b.abs().max().item())
        worst = max(worst, (a - b).abs().max().item())
        check(torch.allclose(a, b, rtol=tol, atol=atol),
              f"sde-gan gradients: fused_mlp vs plain fields beyond rtol {tol}, atol {atol} "
              f"(max |Δ| {(a - b).abs().max().item()})")
    print(f"[{label}] sde-gan B={GAN_BATCHES[0]}: one-pull gradients == two pulls bitwise; "
          f"fields through fused_mlp vs the layer loop max |Δ| {worst:.3g} (rtol {tol}, "
          f"atol {tol} of each leaf's largest)", flush=True)

    # the gradient penalty: its double backward launches no fused_mlp_bwd
    leaves, spec = tree.flatten(params["disc"])
    leaves = [x.detach().requires_grad_() for x in leaves]
    ops.reset_launch_counts()
    gp = gradient_penalty(tree.unflatten(spec, leaves), cfg, prng.fold_in_key(key, 3), y_real,
                          (0.5 * y_real).flip(1))
    torch.cuda.synchronize()
    inner = ops.launch_counts()
    torch.autograd.grad(gp, leaves, allow_unused=True)
    torch.cuda.synchronize()
    outer = ops.launch_counts()
    check(inner["fused_mlp"] == 1 + 2 * GAN_SEQ and inner["fused_mlp_bwd"] == 0
          and outer["fused_mlp_bwd"] == 1 + 2 * GAN_SEQ and math.isfinite(gp.item()),
          f"gradient penalty: launches {inner} then {outer}, value {gp.item()}")
    ops.reset_launch_counts()
    params_gp, hist = train_sde_gan(1, GAN_BATCHES[0], constraint="gp", seed=GAN_SEED,
                                    device=dev)
    torch.cuda.synchronize()
    want = {n: GP_STEP_LAUNCHES[n] + GAN_LOG_LAUNCHES[n] for n in GP_STEP_LAUNCHES}
    _check_gan_launches(ops.launch_counts(), want, "sde-gan gp step")
    check(all(math.isfinite(v) for n, v in hist[0].items() if n != "step")
          and all(torch.isfinite(x).all().item() for x in tree.leaves(params_gp)),
          f"sde-gan gp step: not finite {hist}")
    print(f"[{label}] sde-gan gp step (B={GAN_BATCHES[0]}): {hist[0]}; launches "
          f"{GP_STEP_LAUNCHES} (+ the log); the penalty's create_graph gradient launched "
          f"{inner['fused_mlp']} fused_mlp and no fused_mlp_bwd, its outer backward "
          f"{outer['fused_mlp_bwd']} fused_mlp_bwd", flush=True)

    # float64: the exact adjoint against discretise, both players
    cfg64, p64, key64, y64 = _gan_problem(dev, 64, dtype=torch.float64)
    exact = sde_gan_grads(p64, cfg64, key64, y64, 64)
    dto = sde_gan_grads(p64, dataclasses.replace(cfg64, gradient_mode="discretise"), key64,
                        y64, 64)
    rel = {who: _rel_err(tree.leaves(exact[i]), tree.leaves(dto[i]))
           for who, i in (("generator", 2), ("discriminator", 3))}
    check(max(rel.values()) <= ADJOINT_RTOL,
          f"sde-gan float64: exact adjoint vs discretise relative error {rel}")
    print(f"[{label}] sde-gan float64 B=64: exact adjoint vs discretise relative error "
          f"{rel} (<= {ADJOINT_RTOL})", flush=True)

    # the clip and the gp step in turns, one clip step under the profiler
    timing = {}
    for batch in GAN_BATCHES:
        runs = {"clip": _gan_step(dev, batch), "gp": _gan_step(dev, batch, "gp")}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        walls = {v: [] for v in runs}
        for i in range(4):
            for v in (("clip", "gp") if i % 2 == 0 else ("gp", "clip")):
                t0 = time.perf_counter()
                runs[v]()
                torch.cuda.synchronize()
                walls[v].append(time.perf_counter() - t0)
        med = {v: statistics.median(w) * 1e3 for v, w in walls.items()}
        prof = profile_call(runs["clip"], f"{label}] [sde-gan clip step B={batch}")
        timing[batch] = dict(clip_ms=med["clip"], gp_ms=med["gp"],
                             gp_over_clip=med["gp"] / med["clip"],
                             clip_walls_ms=[w * 1e3 for w in walls["clip"]],
                             gp_walls_ms=[w * 1e3 for w in walls["gp"]],
                             busy_ms=prof["busy_ms"], idle=prof["idle"],
                             device_kernels=prof["kernels"])
        print(f"[{label}] sde-gan B={batch} (float32, {GAN_STEPS} steps): clip step "
              f"{med['clip']:.1f} ms, gp step {med['gp']:.1f} ms (medians of 4 in turns), "
              f"gp / clip {med['gp'] / med['clip']:.3f}", flush=True)

    # memory of a clip step at 31 and 310 solver steps
    peaks = {}
    for n in (GAN_STEPS, 10 * GAN_STEPS):
        run = _gan_step(dev, GAN_BATCHES[0], num_steps=n)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[n] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"[{label}] sde-gan memory (clip step, B={GAN_BATCHES[0]}): peak "
          f"{ {n: round(v, 2) for n, v in peaks.items()} } MiB above what was held before",
          flush=True)
    return dict(launches=step_launches[GAN_BATCHES[0]], timing=timing, peak_mib=peaks)


def _burst(dev, dtype):
    """The adaptive workload's fields, parameters and initial state."""
    from repro_torch import nn

    x = BURST["x_dim"]
    g = torch.Generator().manual_seed(9)
    params = {"f": nn.mlp_init(g, [x, 64, x], dtype=dtype, device=dev)}

    def drift(p, t, y):
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        theta = 0.5 + 30.0 * torch.exp(-(((t - 0.5) / 0.05) ** 2))
        return theta * (1.0 - y) + 0.05 * nn.mlp(p["f"], y, nn.lipswish, torch.tanh)

    def diffusion(p, t, y):
        return 0.05 * torch.ones_like(y)

    z0 = torch.zeros(BURST["batch"], x, dtype=dtype, device=dev)
    return drift, diffusion, params, z0


def _burst_path(dev, dtype):
    from repro_torch.core import BrownianPath
    from repro_torch.kernels import prng

    return BrownianPath(prng.PRNGKey(5, device=dev), 0.0, 1.0,
                        (BURST["batch"], BURST["x_dim"]), dtype)


def _adaptive_grad(dev, dtype, fused: bool, depth, rtol=None):
    """``run() -> (z_T, grads)`` of mean(z_T²) through the adaptive exact
    adjoint."""
    from repro_torch import tree
    from repro_torch.core import solve

    drift, diffusion, params, z0 = _burst(dev, dtype)
    bm = _burst_path(dev, dtype)

    def run():
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        z = z0.clone().requires_grad_()
        zT = solve(drift, diffusion, tree.unflatten(spec, leaves), z, bm, 0.0, 1.0, 16,
                   gradient_mode="reversible_adjoint", save_trajectory=False, adaptive=True,
                   rtol=BURST["rtol"] if rtol is None else rtol, atol=BURST["atol"],
                   max_steps=BURST["max_steps"], bridge_depth=depth,
                   use_pallas_kernels=fused)
        return zT.detach(), torch.autograd.grad(torch.mean(zT ** 2), [z, *leaves])

    return run


def _frozen_grad(dev, dtype, depth, rtol=None):
    """``run() -> (z_T, grads)``: autograd through the accepted grid held
    fixed (the exact adjoint's oracle), and the solve's stats."""
    from repro_torch import tree
    from repro_torch.core.gradients.discretise import solve_accepted_grid
    from repro_torch.core.solve import solve_adaptive

    drift, diffusion, params, z0 = _burst(dev, dtype)
    bm = _burst_path(dev, dtype)
    _, st = solve_adaptive(drift, diffusion, params, z0, bm, 0.0, 1.0,
                           rtol=BURST["rtol"] if rtol is None else rtol, atol=BURST["atol"],
                           max_steps=BURST["max_steps"], dt0=1 / 16, bridge_depth=depth)
    n = int(st.num_accepted)

    def run():
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        z = z0.clone().requires_grad_()
        zT = solve_accepted_grid(drift, diffusion, tree.unflatten(spec, leaves), z, bm, 0.0,
                                 st.ts[:n], st.dts[:n], bridge_depth=depth)
        return zT.detach(), torch.autograd.grad(torch.mean(zT ** 2), [z, *leaves])

    return run, st


def adaptive_grad_checks(ops, dev, label: str) -> dict:
    """Phase 11: the adaptive exact adjoint — launches, fused ≡ unfused,
    exact vs frozen-grid autograd, memory, time."""
    counts = {}
    for depth in (10, 24):
        run_f = _adaptive_grad(dev, torch.float32, True, depth)
        run_u = _adaptive_grad(dev, torch.float32, False, depth)
        _, st = _frozen_grad(dev, torch.float32, depth)
        A = int(st.num_accepted) + int(st.num_rejected)
        N = int(st.num_accepted)
        check(bool(st.converged), f"burst solve (depth {depth}) did not converge")
        ops.reset_launch_counts()
        z_f, g_f = run_f()
        torch.cuda.synchronize()
        c = ops.launch_counts()
        # the burst's one field MLP carries a gradient in each local VJP and
        # in the initial VJP
        want = {"brownian_value": 1 + A + 2 * N, "rev_heun_phase1": A + 2 * N,
                "rev_heun_phase2": A + N, "rev_heun_bwd_phase1": N, "rev_heun_bwd_phase2": N,
                "brownian_increment": 0, "rev_heun_phase1_gen": 0, "fused_mlp_bwd": N + 1}
        print(f"[{label}] adaptive gradient (float32, depth {depth}): {N} accepted, "
              f"{A - N} rejected; launches {c}", flush=True)
        for name, n in want.items():
            check(c[name] == n, f"adaptive gradient depth {depth}: {name} launched {c[name]}"
                                f" times, expected {n} (A={A}, N={N})")
        check(c["fused_mlp"] > 0, f"adaptive gradient depth {depth}: fused_mlp not launched")
        if depth == 10:
            counts = c
        z_u, g_u = run_u()
        check(torch.equal(z_f, z_u) and all(torch.equal(a, b) for a, b in zip(g_f, g_u)),
              f"adaptive gradient depth {depth}: fused != unfused")
        walls = {"fused": [], "unfused": []}
        for i in range(6):
            for variant in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
                t0 = time.perf_counter()
                (run_f if variant == "fused" else run_u)()
                torch.cuda.synchronize()
                walls[variant].append(time.perf_counter() - t0)
        for variant, w in walls.items():
            print(f"[{label}] adaptive gradient depth {depth} ({variant}, float32, batch "
                  f"{BURST['batch']}, x_dim {BURST['x_dim']}): median "
                  f"{statistics.median(w) * 1e3:.1f} ms (all "
                  f"{', '.join(f'{x * 1e3:.1f}' for x in w)} ms)", flush=True)
        profile_call(run_f, f"{label}] [adaptive gradient fused depth {depth}")
        if depth == 10:
            counts["device_kernels"] = compare_kernels(run_f, label,
                                                       "adaptive gradient (fused, depth 10)")
    print("adaptive gradient: launches as the code reads, fused == unfused bitwise "
          "(depth 10 and 24)", flush=True)

    run_x = _adaptive_grad(dev, torch.float64, False, 10)
    run_r, st = _frozen_grad(dev, torch.float64, 10)
    z_x, g_x = run_x()
    z_r, g_r = run_r()
    check(torch.equal(z_x, z_r), "float64: the frozen-grid replay's z_T != the solve's")
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(g_x, g_r))
    check(rel <= ADJOINT_RTOL, f"adaptive exact adjoint vs frozen-grid autograd: {rel}")
    print(f"adaptive adjoint (float64, depth 10, {int(st.num_accepted)} accepted steps): "
          f"exact vs frozen-grid autograd max relative error {rel:.3g} (<= "
          f"{ADJOINT_RTOL})", flush=True)

    peaks = {}
    for rtol in (2e-3, 2e-4):
        for mode in ("exact", "frozen"):
            run = (_adaptive_grad(dev, torch.float32, True, 10, rtol) if mode == "exact"
                   else _frozen_grad(dev, torch.float32, 10, rtol)[0])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            peaks[(mode, rtol)] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        _, st = _frozen_grad(dev, torch.float32, 10, rtol)
        print(f"[{label}] memory (adaptive gradient, rtol {rtol}, {int(st.num_accepted)} "
              f"accepted steps): exact {peaks[('exact', rtol)]:.2f} MiB, frozen-grid "
              f"autograd {peaks[('frozen', rtol)]:.2f} MiB", flush=True)
    check(peaks[("exact", 2e-4)] <= 1.5 * peaks[("exact", 2e-3)],
          f"adaptive exact adjoint's peak grew with the steps: {peaks}")
    check(peaks[("frozen", 2e-4)] >= 2 * peaks[("frozen", 2e-3)],
          f"frozen-grid autograd's peak did not grow with the steps: {peaks}")
    return counts


def attention_bound(B: int, Hq: int, Hkv: int, S: int, D: int, dtype,
                    causal: bool = True, tensor_cores: bool = True, Sk=None) -> tuple:
    """Least time for one attention call: Q, K, V read and O written once
    (Q and O of S rows, K and V of Sk, default S) against 4·D flops per
    (query, key) pair the mask keeps (QKᵀ and PV), over HBM bandwidth and
    the dtype's peak; -> (ms, 'bytes'|'operations').

    float32 runs on the tensor cores as split TF32, three TF32 products for
    each f32 one (at PEAK_TF32_OPS_PER_S); ``tensor_cores=False`` gives the
    float32 CUDA-core bound (the earlier design's) instead."""
    s = torch.finfo(dtype).bits // 8
    Sk = S if Sk is None else Sk
    pairs = S * (S + 1) // 2 if causal else S * Sk
    flops = 4 * B * Hq * D * pairs
    if dtype == torch.float32 and tensor_cores:
        t_ops = 3 * flops / PEAK_TF32_OPS_PER_S * 1e3
    else:
        t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = 2 * (Hq * S + Hkv * Sk) * B * D * s / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _qkv(g, dev, dtype, B, Hq, Hkv, S, D):
    return tuple(torch.randn(B, h, S, D, generator=g, device=dev, dtype=dtype)
                 for h in (Hq, Hkv, Hkv))


def _qkv_sk(g, dev, dtype, B, Hq, Hkv, S, Sk, D):
    """q (B, Hq, S, D) and k, v (B, Hkv, Sk, D), standard normal."""
    return (torch.randn(B, Hq, S, D, generator=g, device=dev, dtype=dtype),
            *(torch.randn(B, Hkv, Sk, D, generator=g, device=dev, dtype=dtype)
              for _ in range(2)))


def _bshd(t):
    """The same values as a (B, H, S, D) view of a (B, S, H, D) buffer: the
    layout the LM's projections hand the kernel."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _in_turns(fns: dict, reps: dict) -> dict:
    """name -> (device ms, host ms), each timed twice in the order a, b, …,
    …, b, a (time_ms), the two medians averaged."""
    runs = {}
    order = list(fns)
    for name in order + order[::-1]:
        runs.setdefault(name, []).append(time_ms(fns[name], reps=reps[name],
                                                 trials=3 if reps[name] < 5 else 5))
    return {name: tuple(sum(x) / 2 for x in zip(*r)) for name, r in runs.items()}


def sass_mix(kernel: str = "flash_attention") -> dict:
    """Instruction mix (mnemonic with its modifiers, e.g.
    ``HMMA.1688.F32.TF32`` -> count) of each kernel whose name holds
    ``kernel`` in the built library, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found: the SASS check needs the CUDA toolkit's")
    out = subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    mix, func = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            func = name if kernel in name else None
            continue
        text = line.strip()
        if func and text.startswith("/*") and "*/" in text:
            words = text.split("*/", 1)[1].replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                mix.setdefault(func, {}).setdefault(words[0], 0)
                mix[func][words[0]] += 1
    return mix


def sass_count(ops_count: dict, base: str, variant: str = "") -> int:
    """Instructions of ``sass_mix`` counts whose mnemonic is ``base`` (any
    modifiers) and, if given, whose modifiers include ``variant``."""
    return sum(n for op, n in ops_count.items()
               if op.split(".")[0] == base and (not variant or variant in op.split(".")[1:]))


def attention_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ‖got − want‖ / ‖want‖ over the (b, h) slices, in f32."""
    d = (got.float() - want.float()).flatten(2).norm(dim=-1)
    return (d / want.float().flatten(2).norm(dim=-1).clamp_min(1e-30)).max().item()


def attention_checks(ops, dev) -> tuple:
    """Phase 12: flash_attention against its plain version at ATTN_SHAPES
    (bf16 also by attention_rel_err), two launches bitwise equal, (B, S, H,
    D) views bitwise the contiguous operands' result, the output's layout;
    the SASS instruction mix; then timed in turns at the prefill shape
    (bf16) and the training shape (f32 and bf16).  Returns ({tag: timed
    row}, max |Δ|, the largest bf16 attention_rel_err)."""
    g = torch.Generator(device=dev).manual_seed(21)
    err = rel_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, S, D in ATTN_SHAPES:
            q, k, v = _qkv(g, dev, dtype, B, Hq, Hkv, S, D)
            views = tuple(_bshd(t) for t in (q, k, v))
            for causal in (True, False):
                got = ops.flash_attention(q, k, v, causal=causal)
                again = ops.flash_attention(q, k, v, causal=causal)
                strided = ops.flash_attention(*views, causal=causal)
                want = ops.flash_attention(q, k, v, causal=causal, scale=1 / math.sqrt(D),
                                           use_kernel=False)
                torch.cuda.synchronize()
                tol = ATTN_TOL[dtype]
                d = (got.float() - want.float()).abs().max().item()
                tag = f"flash_attention {dtype} {(B, Hq, Hkv, S, D)} causal={causal}"
                check(got.dtype == dtype and got.shape == q.shape
                      and torch.isfinite(got.float()).all().item()
                      and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"{tag}: kernel != plain (max |Δ| {d}, tolerance {tol})")
                check(torch.equal(got, again), f"{tag}: two launches differ")
                check(torch.equal(strided, got), f"{tag}: (B, S, H, D) views differ from "
                      f"contiguous operands")
                check(got.transpose(1, 2).is_contiguous()
                      and torch.equal(got.contiguous(), got),
                      f"{tag}: the output is not the (B, Hq, S, D) view of a (B, S, Hq, D) "
                      f"buffer (strides {got.stride()})")
                rel = attention_rel_err(got, want)
                if dtype == torch.bfloat16:
                    check(rel <= ATTN_REL_TOL, f"{tag}: ‖Δ‖/‖want‖ {rel} over a (b, h) slice "
                          f"(limit {ATTN_REL_TOL})")
                    rel_bf16 = max(rel_bf16, rel)
                err = max(err, d)
                print(f"flash_attention {str(dtype)[6:]:8s} {(B, Hq, Hkv, S, D)} "
                      f"causal={causal!s:5s}: max |Δ| {d:.3g} (tol {tol}); ‖Δ‖/‖want‖ "
                      f"{rel:.3g}; two launches equal; (B, S, H, D) views equal", flush=True)
            del q, k, v, views, got, again, strided, want
    torch.cuda.empty_cache()

    mix = sass_mix()
    for func, ops_count in mix.items():
        top = sorted(ops_count.items(), key=lambda kv: -kv[1])[:12]
        print(f"SASS {func[:72]}: HGMMA {sass_count(ops_count, 'HGMMA')}, HMMA TF32 "
              f"{sass_count(ops_count, 'HMMA', 'TF32')}, {sum(ops_count.values())} "
              f"instructions; top {top}", flush=True)
    wgmma = [f for f in mix if "wgmma" in f]
    f32 = [f for f in mix if "f32" in f]
    check(wgmma and all(sass_count(mix[f], "HGMMA") > 0 for f in wgmma),
          f"the bf16 attention kernels must issue HGMMA: {wgmma}")
    check(f32 and all(sass_count(mix[f], "HGMMA") == 0 and sass_count(mix[f], "HMMA", "TF32") > 0
                      for f in f32),
          f"the f32 attention kernels must issue HMMA with TF32 and no HGMMA: {f32}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for tag, dtype, shape in (("bf16 prefill", torch.bfloat16, ATTN_PREFILL),
                              ("f32 training", torch.float32, ATTN_TRAIN),
                              ("bf16 training", torch.bfloat16, ATTN_TRAIN),
                              *((f"bf16 {arch} prefill", torch.bfloat16, shape)
                                for arch, shape in ATTN_MOE_PREFILLS.items())):
        B, Hq, Hkv, S, D = shape
        q, k, v = (_bshd(t) for t in _qkv(g, dev, dtype, B, Hq, Hkv, S, D))
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        lib_out = sdpa(qc, kc, vc, is_causal=True, enable_gqa=True)
        d_lib = (ops.flash_attention(q, k, v).float() - lib_out.float()).abs().max().item()
        t = _in_turns({"kernel": lambda: ops.flash_attention(q, k, v),
                       "sdpa": lambda: sdpa(qc, kc, vc, is_causal=True, enable_gqa=True),
                       "plain": lambda: ops.flash_attention(q, k, v, use_kernel=False)},
                      {"kernel": 10, "sdpa": 10, "plain": 2})
        b_ms, b_by = attention_bound(B, Hq, Hkv, S, D, dtype)
        cc_ms = attention_bound(B, Hq, Hkv, S, D, dtype, tensor_cores=False)[0]
        cc = f", f32 CUDA-core bound {cc_ms:.4f} ms" if dtype == torch.float32 else ""
        print(f"flash_attention {tag} {(B, Hq, Hkv, S, D)} causal, operands as (B, S, H, D) "
              f"views (SDPA on contiguous copies; TF32 off): kernel {t['kernel'][0]:.4f} ms "
              f"(host {t['kernel'][1]:.4f}), SDPA {t['sdpa'][0]:.4f} ms (host "
              f"{t['sdpa'][1]:.4f}), plain {t['plain'][0]:.4f} ms (host {t['plain'][1]:.4f}), "
              f"bound {b_ms:.4f} ms ({b_by}){cc}; kernel vs SDPA max |Δ| {d_lib:.3g}",
              flush=True)
        rows[tag] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0], host_ms=t["kernel"][1],
                         plain_host_ms=t["plain"][1], bound_ms=b_ms, bound_by=b_by,
                         library_ms=t["sdpa"][0])
        if dtype == torch.float32:
            rows[tag]["cuda_core_bound_ms"] = cc_ms
        del q, k, v, qc, kc, vc, lib_out
        torch.cuda.empty_cache()
    return rows, err, rel_bf16


def attention_zoo_checks(ops, dev) -> tuple:
    """Phase 12b: flash_attention at D = 96 and with Sk != S, in float32
    and bfloat16, at ATTN_ZOO_SHAPES against its plain version (f32 within
    ATTN_TOL, bf16 within it and by attention_rel_err), two launches
    bitwise equal, (B, S, H, D) views bitwise the contiguous operands'
    result; causal with Sk != S refused by name on the card; HGMMA in the
    bf16 D = 96 kernel's SASS; then timed in turns at ATTN_ZOO_TIMED in
    both dtypes beside SDPA (on contiguous copies) and the plain version.
    Returns ({tag: timed row}, max |Δ|, the largest bf16 rel err)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(22)
    err = rel_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, S, Sk, D, causal in ATTN_ZOO_SHAPES:
            q, k, v = _qkv_sk(g, dev, dtype, B, Hq, Hkv, S, Sk, D)
            views = tuple(_bshd(t) for t in (q, k, v))
            scale = 1 / math.sqrt(D)
            got = ops.flash_attention(q, k, v, causal=causal, scale=scale)
            again = ops.flash_attention(q, k, v, causal=causal, scale=scale)
            strided = ops.flash_attention(*views, causal=causal, scale=scale)
            want = ops.flash_attention(q, k, v, causal=causal, scale=scale, use_kernel=False)
            torch.cuda.synchronize()
            tol = ATTN_TOL[dtype]
            d = (got.float() - want.float()).abs().max().item()
            tag = f"flash_attention {dtype} {(B, Hq, Hkv, S, Sk, D)} causal={causal}"
            check(got.dtype == dtype and got.shape == q.shape
                  and torch.isfinite(got.float()).all().item()
                  and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                  f"{tag}: kernel != plain (max |Δ| {d}, tolerance {tol})")
            check(torch.equal(got, again), f"{tag}: two launches differ")
            check(torch.equal(strided, got), f"{tag}: (B, S, H, D) views differ from "
                  f"contiguous operands")
            rel = attention_rel_err(got, want)
            if dtype == torch.bfloat16:
                check(rel <= ATTN_REL_TOL, f"{tag}: ‖Δ‖/‖want‖ {rel} over a (b, h) slice "
                      f"(limit {ATTN_REL_TOL})")
                rel_bf16 = max(rel_bf16, rel)
            err = max(err, d)
            print(f"flash_attention {str(dtype)[6:]:8s} {(B, Hq, Hkv, S, Sk, D)} "
                  f"causal={causal!s:5s}: max |Δ| {d:.3g} (tol {tol}); ‖Δ‖/‖want‖ {rel:.3g}; "
                  f"two launches equal; (B, S, H, D) views equal", flush=True)
            del q, k, v, views, got, again, strided, want
    q, k, v = _qkv_sk(g, dev, torch.bfloat16, 1, 4, 4, 64, 32, 96)
    for fn in (lambda: fa._launch(q, k, v, True, 0.1),
               lambda: ops.flash_attention(q, k, v, causal=True, use_kernel=False)):
        try:
            fn()
        except ValueError as e:
            check("key length" in str(e), f"causal Sk != S: unexpected message {e}")
        else:
            check(False, "causal attention with Sk != S was not refused")
    torch.cuda.empty_cache()

    mix = sass_mix()
    d96 = [f for f in mix if "wgmma" in f and "ILi96E" in f]
    check(d96 and all(sass_count(mix[f], "HGMMA") > 0 for f in d96),
          f"the bf16 D = 96 attention kernel must issue HGMMA: {d96}")
    print(f"SASS: HGMMA in {d96}", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, (B, Hq, Hkv, S, Sk, D, causal) in ATTN_ZOO_TIMED.items():
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{str(dtype)[6:]} {name}"
            q, k, v = (_bshd(t) for t in _qkv_sk(g, dev, dtype, B, Hq, Hkv, S, Sk, D))
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

            def lib():
                return sdpa(qc, kc, vc, is_causal=causal, enable_gqa=Hq != Hkv)

            d_lib = (ops.flash_attention(q, k, v, causal=causal).float()
                     - lib().float()).abs().max().item()
            t = _in_turns({"kernel": lambda: ops.flash_attention(q, k, v, causal=causal),
                           "sdpa": lib,
                           "plain": lambda: ops.flash_attention(q, k, v, causal=causal,
                                                                use_kernel=False)},
                          {"kernel": 10, "sdpa": 10, "plain": 2})
            b_ms, b_by = attention_bound(B, Hq, Hkv, S, D, dtype, causal, Sk=Sk)
            by_bytes = (2 * (Hq * S + Hkv * Sk) * B * D * torch.finfo(dtype).bits // 8
                        / HBM_BYTES_PER_S * 1e3)
            print(f"flash_attention {tag} {(B, Hq, Hkv, S, Sk, D)} causal={causal}, operands "
                  f"as (B, S, H, D) views (SDPA on contiguous copies; TF32 off): kernel "
                  f"{t['kernel'][0]:.4f} ms (host {t['kernel'][1]:.4f}), SDPA "
                  f"{t['sdpa'][0]:.4f} ms, plain {t['plain'][0]:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}; the bytes alone {by_bytes:.4f} ms); kernel vs SDPA max |Δ| "
                  f"{d_lib:.3g}", flush=True)
            rows[tag] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0], host_ms=t["kernel"][1],
                             plain_host_ms=t["plain"][1], bound_ms=b_ms, bound_by=b_by,
                             bytes_bound_ms=by_bytes, library_ms=t["sdpa"][0],
                             shape=[B, Hq, Hkv, S, Sk, D], causal=causal)
            del q, k, v, qc, kc, vc
            torch.cuda.empty_cache()
    return rows, err, rel_bf16


ATTN_IN_TURNS = [("bf16 tinyllama training", torch.bfloat16, (4, 32, 4, 2048, 2048, 64, True)),
                 ("bf16 qwen prefill", torch.bfloat16, (4, 40, 8, 2048, 2048, 128, True)),
                 ("bf16 D 16", torch.bfloat16, (2, 8, 4, 300, 300, 16, True)),
                 ("f32 tinyllama training", torch.float32, (4, 32, 4, 2048, 2048, 64, True))]


def _parent_attention(lib):
    """flash_attention through the parent library's entry point, whose
    signature has no key length (q, k, v of one length)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    fn = lib.rt_flash_attention
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [I, I, P, P, P, P, I64, I64, I64, I64, I, ctypes.c_double, P, P]
    fn.restype = I

    def call(q, k, v, causal: bool):
        st = fa.check_operands(q, k, v, causal)
        B, Hq, S, D = q.shape
        out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
        args = (ctypes.c_int64 * 12)(*(s for t in (*st, out.stride()[:3]) for s in t))
        err = fn(fa.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, Hq, k.shape[1], S, int(causal), 1 / math.sqrt(D), args,
                 torch.cuda.current_stream().cuda_stream)
        build.check("parent flash_attention", err)
        return out

    return call


def attention_in_turns(parent_root: str) -> dict:
    """flash_attention with the parent tree's build and this one's, in turns
    (parent, this, this, parent), at ATTN_IN_TURNS (the shapes whose
    instantiations this tree's key length touched), outputs bitwise alike;
    and the parent source's ptxas report of its attention kernels.  Run it
    as ``python3 -c "import chip_smoke as C; C.attention_in_turns(
    'build/parent')"`` after unpacking the parent commit there."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="parent_lib_")
    try:
        parent = _parent_attention(_parent_library(parent_root, tmp, ()))
        csrc = os.path.join(os.path.abspath(parent_root), "src", "repro_torch", "kernels", "csrc")
        rep = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc,
                              "-c", "-o", os.path.join(tmp, "fa.o"),
                              os.path.join(csrc, "flash_attention.cu")],
                             capture_output=True, text=True, timeout=600)
        func = None
        for line in rep.stderr.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif func and "flash_attention" in func and ("spill" in line or "Used" in line):
                print(f"parent ptxas {func[:80]}: {line.split(':', 1)[-1].strip()}", flush=True)
        this = lambda q, k, v, causal: fa._launch(q, k, v, causal, 1 / math.sqrt(q.shape[-1]))
        g = torch.Generator(device=dev).manual_seed(35)
        runs = {}
        for tag, dtype, (B, Hq, Hkv, S, Sk, D, causal) in ATTN_IN_TURNS:
            q, k, v = (_bshd(t) for t in _qkv_sk(g, dev, dtype, B, Hq, Hkv, S, Sk, D))
            fns = {"parent": lambda: parent(q, k, v, causal), "this": lambda: this(q, k, v, causal)}
            check(torch.equal(fns["parent"](), fns["this"]()), f"{tag}: this tree's attention "
                  f"differs from the parent's")
            runs[tag] = {"parent": [], "this": []}
            for tree in ("parent", "this", "this", "parent"):
                runs[tag][tree].append(time_ms(fns[tree])[0])
            print(f"flash_attention in turns, {tag} {(B, Hq, Hkv, S, D)}: parent "
                  f"{statistics.mean(runs[tag]['parent']):.4f} ms, this "
                  f"{statistics.mean(runs[tag]['this']):.4f} ms; runs {runs[tag]}; outputs "
                  f"bitwise equal", flush=True)
            del q, k, v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {gpu_label()}", flush=True)
    return runs


# The ping-pong schedule at D = 96, as a text edit of the source.
PIPELINED_96 = (("constexpr bool kPipelined = D <= 64;", "constexpr bool kPipelined = D <= 96;"),)


def ptxas_attention_variant(edits=PIPELINED_96) -> dict:
    """A copy of ``flash_attention.cu`` with ``edits`` (``(old, new)`` text
    pairs, each found once) compiled with ``-Xptxas -v``: {mangled D = 96
    kernel: its ptxas lines, warnings (C7512, "wgmma serialized")
    included}.  Reads a schedule the library does not build (the
    ping-pong one at D = 96); no edits reads the library's own."""
    from repro_torch.kernels import build

    text = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        check(text.count(old) == 1, f"ptxas variant: {old!r} is not in the source once")
        text = text.replace(old, new)
    variant = [new for _, new in edits]
    with tempfile.TemporaryDirectory(prefix="ptxas_variant_") as tmp:
        src = os.path.join(tmp, "flash_attention.cu")
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                               str(build.CSRC), "-c", "-o", os.path.join(tmp, "v.o"), src],
                              capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc {variant} failed:\n{proc.stderr}")
    out, func = {}, None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and "ILi96E" in func and ("spill" in line or "Used" in line
                                            or "C7512" in line or "serialized" in line):
            out.setdefault(func, []).append(line.split(":", 1)[-1].strip())
    for func, lines in out.items():
        print(f"ptxas {' '.join(variant)} {func[:80]}: {'; '.join(lines)}", flush=True)
    for line in proc.stderr.splitlines():
        if "C75" in line:
            print(f"ptxas {' '.join(variant)}: {line.strip()}", flush=True)
    return out


@contextlib.contextmanager
def plain_mlp():
    """Route every depth-1 SDE field back to the layer loop it ran before
    fused_mlp (``nn.linear``'s 1024-row blocks and the written-out LipSwish),
    for the launch counts with and without the kernel."""
    from repro_torch import nn
    from repro_torch.nn import core as nn_core

    dispatch = nn_core._mlp_dispatch
    nn_core._mlp_dispatch = lambda layers, x: nn_core._mlp_layers(layers, x, nn.lipswish)
    try:
        yield
    finally:
        nn_core._mlp_dispatch = dispatch


@contextlib.contextmanager
def plainvjp_mlp():
    """Route every depth-1 field through fused_mlp inside the node it had
    before its backward kernel (``kernels/vjp.py:PlainVJP``: the forward
    kernel, the plain version's VJP as the backward, a node whatever the
    grad mode), for the device kernels the backward kernel saves."""
    from repro_torch.kernels import fused_mlp as fm, ref
    from repro_torch.kernels.vjp import PlainVJP
    from repro_torch.nn import core as nn_core

    def dispatch_then(layers, x):
        (l1, l2) = layers
        args = (x.contiguous(), l1["w"], l1["b"], l2["w"], l2["b"])
        fm.check_operands(*args)
        return PlainVJP.apply(fm._launch, ref.fused_mlp, {}, *args)

    dispatch = nn_core._mlp_dispatch
    nn_core._mlp_dispatch = dispatch_then
    try:
        yield
    finally:
        nn_core._mlp_dispatch = dispatch


def compare_kernels(fn, label: str, what: str) -> dict:
    """One profiled call with the fields through fused_mlp (its backward
    kernel), one with them in the PlainVJP node (plainvjp_mlp()) and one
    under plain_mlp(): the device kernels (and copies) each issues."""
    with_kernel = profile_call(fn, f"{label}] [{what}, fields through fused_mlp")
    with plainvjp_mlp():
        plain_vjp = profile_call(fn, f"{label}] [{what}, fields in the PlainVJP node")
    with plain_mlp():
        without = profile_call(fn, f"{label}] [{what}, fields on the layer loop")
    print(f"[{label}] device kernels per {what}: {with_kernel['kernels']} with fused_mlp and "
          f"its backward kernel, {plain_vjp['kernels']} with the PlainVJP node, "
          f"{without['kernels']} under plain_mlp(); wall {with_kernel['wall_ms']:.3f} vs "
          f"{plain_vjp['wall_ms']:.3f} vs {without['wall_ms']:.3f} ms; idle share "
          f"{with_kernel['idle']} vs {plain_vjp['idle']} vs {without['idle']}", flush=True)
    return {"kernel": with_kernel["kernels"], "plain_vjp": plain_vjp["kernels"],
            "layer_loop": without["kernels"]}


@contextlib.contextmanager
def plain_attention():
    """Route every LM attention through the plain version (use_kernel=False)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    dispatch = layers._attend_dispatch
    layers._attend_dispatch = lambda cfg, q, k, v, causal, scale=None: ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, scale=scale,
        use_kernel=False)
    try:
        yield
    finally:
        layers._attend_dispatch = dispatch


@contextlib.contextmanager
def copying_attention():
    """Route every LM attention through the kernel as the LM called it
    before it read the (B, S, H, D) projections in place: on contiguous
    copies of q, k, v, writing a contiguous (B, Hq, S, D) output, which the
    layer's transpose-reshape then copies (four copies a layer)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    dispatch = layers._attend_dispatch
    layers._attend_dispatch = lambda cfg, q, k, v, causal, scale=None: fa._launch(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        1 / math.sqrt(q.shape[-1]) if scale is None else scale,
        out=torch.empty(q.shape, dtype=q.dtype, device=q.device))
    try:
        yield
    finally:
        layers._attend_dispatch = dispatch


@contextlib.contextmanager
def plain_ssd():
    """Route every Mamba2 SSD scan through the plain version (use_kernel=False)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    dispatch = layers._ssd_dispatch
    layers._ssd_dispatch = lambda x, a, b, c: ops.ssd_chunk(x, a, b, c, use_kernel=False)
    try:
        yield
    finally:
        layers._ssd_dispatch = dispatch


# The kernel each LM family's prefill runs, and the switch to its plain version.
LM_KERNELS = {LM_ARCH: ("flash_attention", plain_attention), SSM_ARCH: ("ssd_chunk", plain_ssd)}
# The hand kernels an LM prefill can reach (attention and Mamba2 mixers).
LM_PATH_KERNELS = ("flash_attention", "ssd_chunk")


def _greedy(cfg, params, prompts, gen: int, kernels=LM_PATH_KERNELS) -> tuple:
    """Prefill, then ``gen`` greedy decode steps -> (prefill logits, tokens,
    {kernel: launches in the prefill}, {kernel: launches in the decode})."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step

    S = prompts.shape[1]
    ops.reset_launch_counts()
    logits, caches = make_prefill_step(cfg, max_len=S + gen)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    n_prefill = {k: ops.launch_counts()[k] for k in kernels}
    decode = make_serve_step(cfg)
    token = greedy_sample(logits)
    tokens = [token]
    for i in range(gen):
        step_logits, caches = decode(params, caches, token, S + i)
        token = greedy_sample(step_logits)
        tokens.append(token)
    torch.cuda.synchronize()
    n_decode = {k: ops.launch_counts()[k] - n_prefill[k] for k in kernels}
    return logits.float(), torch.cat(tokens, 1), n_prefill, n_decode


def lm_parity_checks(dev, label: str, arch: str) -> None:
    """Phases 13 and 16: a float32 LM at full width and two layers, kernel
    vs plain."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.models import transformer as T

    kernel_name, plain = LM_KERNELS[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype=torch.float32)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(31), cfg, device=dev)
    B, S, gen = LM_PARITY["batch"], LM_PARITY["prompt_len"], LM_PARITY["gen"]
    prompts = lm_prompts(31, B, S, cfg.vocab).to(dev)
    kernel = _greedy(cfg, params, prompts, gen, (kernel_name,))
    with plain():
        plain_run = _greedy(cfg, params, prompts, gen, (kernel_name,))
    kernel = (*kernel[:2], kernel[2][kernel_name], kernel[3][kernel_name])
    plain_run = (*plain_run[:2], plain_run[2][kernel_name], plain_run[3][kernel_name])
    check(kernel[2:] == (2, 0), f"LM parity ({arch}): {kernel_name} launched {kernel[2]} "
          f"times in the prefill and {kernel[3]} in decode (want 2, 0)")
    check(plain_run[2:] == (0, 0), f"LM parity ({arch}): the plain run launched "
          f"{plain_run[2:]}")
    check(torch.isfinite(kernel[0]).all().item(), f"LM parity ({arch}): non-finite logits")
    diff = (kernel[0] - plain_run[0]).abs().max().item()
    top = plain_run[0].abs().max().item()
    check(diff <= LM_LOGIT_RTOL * top, f"LM parity ({arch}): prefill logits differ by "
          f"{diff} (largest logit {top}, tolerance {LM_LOGIT_RTOL} of it)")
    check(torch.equal(kernel[1], plain_run[1]), f"LM parity ({arch}): greedy tokens differ "
          f"{kernel[1].tolist()} vs {plain_run[1].tolist()}")
    print(f"[{label}] LM parity ({arch}, float32, 2 layers, B={B}, S={S}): prefill "
          f"logits max |Δ| {diff:.3g} (largest logit {top:.3g}; {diff / top:.3g} relative, "
          f"tolerance {LM_LOGIT_RTOL}); {gen + 1} greedy tokens equal on every row; "
          f"{kernel_name} launches: {kernel[2]} per prefill, {kernel[3]} in decode",
          flush=True)
    del params
    torch.cuda.empty_cache()


def _tree_bytes(params) -> int:
    from repro_torch import tree

    return sum(a.numel() * a.element_size() for a in tree.leaves(params))


def lm_serve_checks(ops, dev, label: str, arch: str) -> dict:
    """Phases 14 and 17: the full model in bfloat16 served through serve_lm."""
    from repro_torch import tree
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.counting import param_count

    kernel, plain = LM_KERNELS[arch]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in tree.leaves(params))
    w_bytes = _tree_bytes(params)
    check(n_params == param_count(cfg), f"{n_params} parameters, param_count "
          f"{param_count(cfg)}")
    B, S, gen = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    cache_bytes = _tree_bytes(T.init_cache_zeros(cfg, B, S + gen, device="meta"))
    print(f"[{label}] {arch} (bf16, {cfg.num_layers} layers): {n_params} parameters "
          f"(= param_count), weights {w_bytes / 1e9:.3f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; cache at B={B}, {S}+{gen} slots "
          f"{cache_bytes / 1e9:.3f} GB; a decode step's bound (the weights read once) "
          f"{w_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms", flush=True)

    launches = {}
    for b, s, g in ((B, S, gen), (4, 32, 16)):
        gc.collect()  # an earlier phase's tensors may wait in reference cycles
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        tokens = serve_cli.serve_lm(arch, b, s, g, smoke=False, params=params)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launches[s] = counts[kernel]
        check(counts[kernel] == cfg.num_layers,
              f"serve_lm {arch} prompt {s}: {kernel} launched {counts[kernel]} times, want "
              f"{cfg.num_layers} (one per prefill layer, none in decode)")
        check(tokens.shape == (b, g) and tokens.dtype == torch.int32
              and 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab,
              f"serve_lm {arch} prompt {s}: bad tokens {tuple(tokens.shape)} {tokens.dtype}")
        print(f"[{label}] serve_lm {arch} B={b} prompt {s} gen {g}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({base / 1e9:.3f} GB "
              f"allocated before the call); {kernel} launches "
              f"{counts[kernel]} (prefill {cfg.num_layers}, decode 0)", flush=True)
    ops.reset_launch_counts()
    smoke_tokens = serve_cli.main(["--workload", "lm", "--arch", arch])
    torch.cuda.synchronize()
    n_smoke = smoke_config(arch).num_layers
    check(ops.launch_counts()[kernel] == n_smoke and smoke_tokens.shape == (4, 16),
          f"the CLI (--workload lm --arch {arch}, smoke config): "
          f"{ops.launch_counts()[kernel]} launches of {kernel} (want {n_smoke}), tokens "
          f"{tuple(smoke_tokens.shape)}")

    from repro_torch.launch.serve import lm_prompts

    prompts = lm_prompts(0, B, S, cfg.vocab).to(dev)
    prefill = make_prefill_step(cfg, max_len=S + gen)
    prof = profile_call(lambda: prefill(params, {"tokens": prompts}),
                        f"{label}] [{arch} prefill B={B} S={S}")
    k_ms = sum(ms for name, ms in prof["by_name"].items() if kernel in name)
    if prof["busy_ms"]:
        print(f"[{label}] {arch} prefill: {kernel} {k_ms:.3f} ms of {prof['busy_ms']:.3f} "
              f"ms device busy ({k_ms / prof['busy_ms']:.3f}) and of "
              f"{prof['wall_ms']:.3f} ms wall ({k_ms / prof['wall_ms']:.3f})", flush=True)
    copies_saved = None
    if kernel == "flash_attention":
        check(prof["kernels"] is not None, f"{arch} prefill: the profiler recorded no device "
              f"kernels, so the copies cannot be counted")
        # A profile now and then holds a few events from outside the call (a
        # run showed one GEMM, one elementwise and three copy kernels more
        # than the call issues) or drops a few of the call's (six copy
        # kernels in run 4, PR 32), so each route's count is the median of
        # three profiled calls.
        in_place = [prof] + [profile_call(lambda: prefill(params, {"tokens": prompts}),
                                          f"{label}] [{arch} prefill B={B} S={S}, again")
                             for _ in range(2)]
        with copying_attention():
            copying = [profile_call(lambda: prefill(params, {"tokens": prompts}),
                                    f"{label}] [{arch} prefill B={B} S={S}, attention on "
                                    f"contiguous copies{tag}")
                       for tag in ("", ", again", ", a third time")]

        def each(profs):
            return [sum(n for name, n in p["counts"].items() if "copy" in name.lower())
                    for p in profs]

        def copies(profs):
            return statistics.median(each(profs))

        copies_saved = (copies(copying) - copies(in_place)) / cfg.num_layers
        print(f"[{label}] {arch} prefill: {prof['kernels']} device kernels ({copies(in_place)} "
              f"copy kernels, the median of three profiles) reading the projections in place, "
              f"{copying[0]['kernels']} ({copies(copying)}) with the copies: {copies_saved:g} "
              f"fewer copy kernels a layer; wall {prof['wall_ms']:.3f} vs "
              f"{copying[0]['wall_ms']:.3f} ms; copy kernels of each profile "
              f"{each(in_place)} in place, {each(copying)} with the copies", flush=True)
        check(copies_saved >= 4, f"{arch} prefill: only {copies_saved} fewer copy kernels "
              f"a layer without the copies (want at least 4)")

    logits, caches = prefill(params, {"tokens": prompts})
    decode, token = make_serve_step(cfg), greedy_sample(logits)
    profile_call(lambda: decode(params, caches, token, S),
                 f"{label}] [{arch} decode step B={B}, cache {S + gen} slots")
    del caches
    with plain():
        t0 = time.perf_counter()
        plain_logits, _ = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    logits, plain_logits = logits.float(), plain_logits.float()
    check(torch.isfinite(logits).all().item() and torch.isfinite(plain_logits).all().item(),
          f"{arch} full-depth prefill: non-finite logits")
    diff = (logits - plain_logits).abs().max().item()
    agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item()
    print(f"[{label}] {arch} full-depth bf16 prefill, kernel vs plain {kernel} "
          f"({plain_s * 1e3:.1f} ms plain): last-position logits max |Δ| {diff:.4g} (largest "
          f"{plain_logits.abs().max().item():.4g}); first-token agreement {agree:.3f} over "
          f"{B} rows", flush=True)
    del params, logits, plain_logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches[S], copies_saved_per_layer=copies_saved)


def ssd_bound(B: int, H: int, S: int, P: int, N: int, dtype, b_heads: int, L: int,
              tensor_cores: bool = True) -> tuple:
    """Least time for one SSD call: the chunked form's 2LN + 2LP + 4NP flops
    per position and head at chunk L, against x read and y written in
    ``dtype``, a in f32, b and c over their ``b_heads`` distinct heads (1
    when expanded) and the f32 state written once; -> (ms,
    'bytes'|'operations').  On tensor cores: bf16 at the bf16 MMA rate,
    f32 as split TF32 (three TF32 products an f32 one); ``tensor_cores=False``
    gives the f32 CUDA-core bound (the earlier design's, at its L = 32)."""
    s = torch.finfo(dtype).bits // 8
    flops = B * H * S * (2 * L * N + 2 * L * P + 4 * N * P)
    nbytes = 2 * B * H * S * P * s + B * H * S * 4 + 2 * B * b_heads * S * N * s + B * H * N * P * 4
    if not tensor_cores:
        t_ops = flops / PEAK_OPS_PER_S[torch.float32] * 1e3
    elif dtype == torch.float32:
        t_ops = 3 * flops / PEAK_TF32_OPS_PER_S * 1e3
    else:
        t_ops = flops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ssd_operands(g, dev, dtype, B, H, S, P, N, mixer_layout: bool, scale: float = 0.1):
    """x ~ N(0, 1), a = −scale·|N(0, 1)| (the JAX suite's 0.1 by default),
    b, c ~ 0.5·N(0, 1) (the JAX suite's draws).  In the mixer's layout x and
    a are transposed views of (B, S, H, ·) tensors and b, c are (B, S, N)
    expanded over the heads."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    if mixer_layout:
        x = randn(B, S, H, P).to(dtype).transpose(1, 2)
        a = (-scale * randn(B, S, H).abs()).transpose(1, 2)
        b, c = ((0.5 * randn(B, S, N)).to(dtype)[:, None].expand(B, H, S, N)
                for _ in range(2))
    else:
        x = randn(B, H, S, P).to(dtype)
        a = -scale * randn(B, H, S).abs()
        b, c = ((0.5 * randn(B, H, S, N)).to(dtype) for _ in range(2))
    return x, a, b, c


def ssd_checks(ops, dev) -> tuple:
    """Phase 15: ssd_chunk against its plain version at SSD_SHAPES in both
    dtypes (finite; two launches and contiguous copies of the operands give
    the same bits; at batch 1 the grid covers 128 SMs or more), the SASS
    instruction mix, then timed in turns at the prefill shape and at batch
    1 (bf16, mixer views) beside the plain version and both bounds.
    Returns (timing row, max |Δ| of y)."""
    from repro_torch.kernels import ssd_chunk as ssd_kernel

    g = torch.Generator(device=dev).manual_seed(15)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (B, H, S, P, N), layout, scale in SSD_SHAPES:
            x, a, b, c = _ssd_operands(g, dev, dtype, B, H, S, P, N, layout, scale)
            y, h = ops.ssd_chunk(x, a, b, c)
            y2, h2 = ops.ssd_chunk(x, a, b, c)
            yc, hc = ops.ssd_chunk(*(t.contiguous() for t in (x, a, b, c)))
            y_ref, h_ref = ops.ssd_chunk(x, a, b, c, use_kernel=False)
            torch.cuda.synchronize()
            tol = SSD_TOL[dtype]
            d_y = (y.float() - y_ref.float()).abs().max().item()
            d_h = (h - h_ref).abs().max().item()
            top_h = h_ref.abs().max().item()
            slices = ssd_kernel.slices(dtype, N, P, B * H)
            where = f"ssd_chunk {str(dtype)[6:]} {(B, H, S, P, N)} a×{scale}"
            check(y.dtype == dtype and y.shape == x.shape and h.shape == (B, H, N, P)
                  and torch.isfinite(y.float()).all().item()
                  and torch.isfinite(h).all().item()
                  and torch.allclose(y.float(), y_ref.float(), rtol=tol, atol=tol),
                  f"{where}: kernel y != plain (max |Δ| {d_y}, tolerance {tol})")
            check(d_h <= SSD_STATE_RTOL * top_h, f"{where}: kernel state != plain (max |Δ| "
                  f"{d_h}, largest {top_h}, tolerance {SSD_STATE_RTOL} of it)")
            check(torch.equal(y, y2) and torch.equal(h, h2), f"{where}: two launches differ")
            check(torch.equal(y, yc) and torch.equal(h, hc),
                  f"{where}: the operands' views and contiguous copies give other bits")
            if (B, H, S, P, N) == SSD_BATCH1:
                check(B * H * slices >= 128, f"{where}: {B * H * slices} blocks ({slices} "
                      f"slices of P) leave SMs without work")
            err = max(err, d_y)
            print(f"{where} {'mixer views' if layout else 'contiguous '}, {B * H * slices} "
                  f"blocks ({slices} slice{'s' if slices > 1 else ''} of P): y max |Δ| "
                  f"{d_y:.3g} (largest {y_ref.float().abs().max().item():.3g}; rtol = atol = "
                  f"{tol}); h_final max |Δ| {d_h:.3g} (largest {top_h:.3g}, tol "
                  f"{SSD_STATE_RTOL} of it); two launches and contiguous copies bitwise "
                  f"equal", flush=True)
            del x, a, b, c, y, h, y2, h2, yc, hc, y_ref, h_ref
    torch.cuda.empty_cache()

    mix = sass_mix("ssd_chunk")
    for func, ops_count in mix.items():
        print(f"SASS {func[:72]}: HMMA BF16 {sass_count(ops_count, 'HMMA', 'BF16')}, HMMA "
              f"TF32 {sass_count(ops_count, 'HMMA', 'TF32')}, HGMMA "
              f"{sass_count(ops_count, 'HGMMA')}, {sum(ops_count.values())} instructions",
              flush=True)
    bf16 = [f for f in mix if "bfloat16" in f]
    f32 = [f for f in mix if "bfloat16" not in f]
    check(bf16 and all(sass_count(mix[f], "HMMA", "BF16") + sass_count(mix[f], "HGMMA") > 0
                       for f in bf16),
          f"the bf16 ssd_chunk kernels must issue HMMA or HGMMA on bf16: {bf16}")
    check(f32 and all(sass_count(mix[f], "HMMA", "TF32") > 0 for f in f32),
          f"the f32 ssd_chunk kernels must issue HMMA on TF32: {f32}")

    rows = {}
    for tag, shape in (("prefill", SSD_PREFILL), ("batch 1", SSD_BATCH1),
                       ("jamba prefill", SSD_JAMBA)):
        B, H, S, P, N = shape
        x, a, b, c = _ssd_operands(g, dev, torch.bfloat16, B, H, S, P, N, True)
        t = _in_turns({"kernel": lambda: ops.ssd_chunk(x, a, b, c),
                       "plain": lambda: ops.ssd_chunk(x, a, b, c, use_kernel=False)},
                      {"kernel": 10, "plain": 1})
        b_ms, b_by = ssd_bound(B, H, S, P, N, torch.bfloat16, b_heads=1, L=ssd_kernel.CHUNK)
        cc_ms = ssd_bound(B, H, S, P, N, torch.bfloat16, b_heads=1, L=SSD_CUDA_CORE_CHUNK,
                          tensor_cores=False)[0]
        slices = ssd_kernel.slices(torch.bfloat16, N, P, B * H)
        # the launcher's other choices, for its rule (every slice count gives the same bits)
        by_slices = {n: time_ms(lambda: ssd_kernel._launch(x, a, b, c, slices=n), reps=10,
                                trials=5)[0] for n in (1, 2, 4) if P // n >= 16}
        print(f"ssd_chunk bf16 {tag} {shape}: device ms by P slices "
              f"{ {n: round(ms, 4) for n, ms in by_slices.items()} } (blocks = {B * H} × "
              f"slices); the launcher takes {slices}", flush=True)
        print(f"ssd_chunk bf16 {tag} {shape} (mixer views, {B * H * slices} blocks): kernel "
              f"{t['kernel'][0]:.4f} ms (host {t['kernel'][1]:.4f}), plain "
              f"{t['plain'][0]:.4f} ms (host {t['plain'][1]:.4f}), bound {b_ms:.4f} ms "
              f"({b_by}, tensor cores, L = {ssd_kernel.CHUNK}), f32 CUDA-core bound "
              f"{cc_ms:.4f} ms (L = {SSD_CUDA_CORE_CHUNK}); no library call computes it",
              flush=True)
        rows[tag] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0], host_ms=t["kernel"][1],
                         plain_host_ms=t["plain"][1], bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, cuda_core_bound_ms=cc_ms, shape=list(shape),
                         blocks=B * H * slices, ms_by_slices=by_slices)
        del x, a, b, c
        torch.cuda.empty_cache()
    B, H, S, P, N = SSD_PREFILL
    x, a, b, c = _ssd_operands(g, dev, torch.float32, B, H, S, P, N, True)
    f32_ms, f32_host = time_ms(lambda: ops.ssd_chunk(x, a, b, c), reps=10, trials=5)
    f32_bound, f32_by = ssd_bound(B, H, S, P, N, torch.float32, b_heads=1, L=ssd_kernel.CHUNK)
    print(f"ssd_chunk float32 prefill {SSD_PREFILL} (mixer views): kernel {f32_ms:.4f} ms (host "
          f"{f32_host:.4f}), bound {f32_bound:.4f} ms ({f32_by}, split TF32)", flush=True)
    del x, a, b, c
    torch.cuda.empty_cache()
    rows["f32 prefill"] = dict(ms=f32_ms, host_ms=f32_host, bound_ms=f32_bound, bound_by=f32_by)
    row = dict(rows["prefill"], batch1=rows["batch 1"], f32_prefill=rows["f32 prefill"],
               jamba_prefill=rows["jamba prefill"],
               sass={f: {"HMMA_BF16": sass_count(m, "HMMA", "BF16"),
                         "HMMA_TF32": sass_count(m, "HMMA", "TF32"),
                         "HGMMA": sass_count(m, "HGMMA")} for f, m in mix.items()})
    return row, err


# One process of one tree (run from its root): ssd_chunk at the prefill and
# batch-1 shapes (bf16, mixer views) and the steady bf16 prefill of the full
# mamba2-1.3b (B 4 × 2048, wall of a synchronised call, median of 5).
# Prints one JSON line.
_SSD_CHILD = r"""
import json, statistics, sys, time
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as C
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.launch.serve import lm_prompts
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
build.load()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(15)
out = {}
for tag, shape in (("prefill", (4, 64, 2048, 64, 128)), ("batch 1", (1, 64, 2048, 64, 128))):
    x, a, b, c = C._ssd_operands(g, dev, torch.bfloat16, *shape, True)
    out[tag + " ms"] = C.time_ms(lambda: ops.ssd_chunk(x, a, b, c), reps=10, trials=5)[0]
cfg = get_config("mamba2-1.3b")
params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
prompts = lm_prompts(0, 4, 2048, cfg.vocab).to(dev)
prefill = make_prefill_step(cfg, max_len=2048 + 16)
walls = []
for i in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
out["mamba2 prefill ms"] = statistics.median(walls[1:]) * 1e3
print(json.dumps(out))
"""


def ssd_in_turns(parent_root: str) -> dict:
    """ssd_chunk at the prefill and batch-1 shapes and mamba2-1.3b's steady
    bf16 prefill in the tree at ``parent_root`` and in this one, in turns
    (parent, this, this, parent), each a fresh process that builds its own
    kernels (~1 minute each): ``{tree: [runs]}``.  Run it as ``python3 -c
    "import chip_smoke as C; C.ssd_in_turns('build/parent')"`` after
    unpacking the parent commit there (``git archive``)."""
    return _children_in_turns(parent_root, _SSD_CHILD, "ssd_chunk in turns", 900)


def _linear_loss_grads(fn, inputs, seed: int):
    """Gradients of sum(c·out) over every output for fixed random c."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=leaves[0].device).manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=g, device=o.device, dtype=o.dtype)).sum()
               for o in outs)
    return torch.autograd.grad(loss, leaves)


def lm_grad_checks(ops, dev, label: str) -> None:
    """Phase 17b: gradients through the hand kernels.  For a loss linear in
    the outputs, flash_attention's and ssd_chunk's gradients (the plain
    versions' VJPs at the saved inputs) are bitwise the plain path's, and
    fused_mlp's (its backward kernel, one launch) within MLP_TOL of them;
    then one backward of a two-layer smoke LM's next-token loss
    (qwen2.5-14b's and mamba2-1.3b's families) reaches every parameter with
    a finite gradient, through one kernel launch per layer."""
    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, f=1.0):
        return f * torch.randn(*shape, generator=g, device=dev)

    B, H, S, P, N = 2, 8, 100, 16, 16
    cases = [("fused_mlp", ops.fused_mlp, _mlp_operands(torch.Generator().manual_seed(17), dev,
                                                          torch.float32, 64, 17, 32, 16)),
             ("flash_attention", ops.flash_attention,
              [randn(2, 8, 77, 64), randn(2, 2, 77, 64), randn(2, 2, 77, 64)]),
             ("ssd_chunk", ops.ssd_chunk,
              [randn(B, S, H, P).transpose(1, 2), (-0.1 * randn(B, S, H).abs()).transpose(1, 2),
               randn(B, S, N, f=0.5)[:, None].expand(B, H, S, N),
               randn(B, S, N, f=0.5)[:, None].expand(B, H, S, N)])]
    for name, fn, inputs in cases:
        ops.reset_launch_counts()
        got = _linear_loss_grads(fn, inputs, 3)
        torch.cuda.synchronize()
        n = ops.launch_counts()[name]
        n_bwd = ops.launch_counts()["fused_mlp_bwd"]
        want = _linear_loss_grads(lambda *t: fn(*t, use_kernel=False), inputs, 3)
        torch.cuda.synchronize()
        check(n == 1, f"{name}: {n} launches in one gradient, want 1")
        diff = max((a - b).abs().max().item() for a, b in zip(got, want) if a is not None)
        check(all(a is not None for a in got), f"{name}: an input got no gradient")
        if name == "fused_mlp":
            tol = MLP_TOL[torch.float32]
            check(n_bwd == 1 and all(torch.allclose(a, b, rtol=tol, atol=mlp_bwd_atol(o, b))
                                     for o, a, b in zip(("dx", "dW1", "db1", "dW2", "db2"),
                                                        got, want)),
                  f"fused_mlp: {n_bwd} backward launches, gradients max |Δ| {diff} from the "
                  f"plain path's (tolerance {tol})")
            mlp_diff = diff
        else:
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{name}: gradients through the kernel != the plain path's (max |Δ| {diff})")
    print(f"gradients: flash_attention and ssd_chunk (strided x and a, stride-0 b and c) "
          f"give the plain path's gradients bitwise for a linear loss; fused_mlp's backward "
          f"kernel (one launch) within {mlp_diff:.3g} of them (tolerance "
          f"{MLP_TOL[torch.float32]})", flush=True)

    for arch, kernel in ((LM_ARCH, "flash_attention"), (SSM_ARCH, "ssd_chunk")):
        cfg = smoke_config(arch)
        params = T.init_lm(torch.Generator(device=dev).manual_seed(18), cfg, device=dev)
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        tokens = torch.randint(0, cfg.vocab, (2, 65), generator=g, device=dev)
        ops.reset_launch_counts()
        logits, _ = T.lm_forward(tree.unflatten(spec, leaves), cfg, tokens)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].float().reshape(-1, cfg.vocab), tokens[:, 1:].reshape(-1))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        n = ops.launch_counts()[kernel]
        missing = sum(gr is None for gr in grads)
        check(n == cfg.num_layers, f"LM gradient ({arch} smoke): {kernel} launched {n} "
              f"times, want {cfg.num_layers}")
        check(missing == 0 and all(torch.isfinite(gr).all().item() for gr in grads),
              f"LM gradient ({arch} smoke): {missing} of {len(grads)} parameters got no "
              f"gradient, or one is not finite")
        print(f"[{label}] LM gradient ({arch} smoke config, {cfg.num_layers} layers, B 2, "
              f"S 65): loss {loss.item():.4f}; {kernel} launched {n} times; all "
              f"{len(grads)} parameter leaves have finite gradients (largest |g| "
              f"{max(gr.abs().max().item() for gr in grads):.3g})", flush=True)


def xent_bound(R: int, V: int, dtype, backward: bool) -> tuple:
    """Least time for one cross-entropy call: the logits read once (and, for
    the backward, dlogits written once) with the (R,) labels, lse, loss or
    g, against XENT_FWD_OPS / XENT_BWD_OPS float32 operations per logit;
    -> (ms, 'bytes'|'operations')."""
    s = torch.finfo(dtype).bits // 8
    nbytes = (2 if backward else 1) * R * V * s + 3 * R * 4
    n_ops = (XENT_BWD_OPS if backward else XENT_FWD_OPS) * R * V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _xent_operands(g, dev, dtype, R, V):
    """The JAX suite's draws: logits 3·N(0, 1), labels uniform, g ~ N(0, 1)."""
    x = (3 * torch.randn(R, V, generator=g, device=dev)).to(dtype)
    lab = torch.randint(0, V, (R,), generator=g, device=dev, dtype=torch.int32)
    return x, lab, torch.randn(R, generator=g, device=dev)


def xent_checks(ops, dev) -> tuple:
    """Phase 18: the fused_xent forward and backward kernels against their
    plain versions at XENT_SHAPES, float32 and bfloat16; rows invariant
    bitwise (1 vs 300 vs 8192 rows); then timed at XENT_TIMED beside the
    plain versions, the bounds and F.cross_entropy.  Returns (timing rows
    by kernel, float32 first, max |Δ| by kernel)."""
    from repro_torch.kernels import ref, xent

    g = torch.Generator(device=dev).manual_seed(18)
    err = {"fused_xent": 0.0, "fused_xent_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = XENT_TOL[dtype]
        for R, V in XENT_SHAPES:
            x, lab, cot = _xent_operands(g, dev, dtype, R, V)
            loss, lse = xent.launch_fwd(x, lab)
            dx = xent.launch_bwd(x, lab, lse, cot)
            want_loss, want_lse = ref.fused_xent_fwd(x, lab)
            want_dx = ref.fused_xent_bwd(x, lab, lse, cot)  # at the kernel's lse
            torch.cuda.synchronize()
            where = f"fused_xent {str(dtype)[6:]} {(R, V)}"
            d_loss = (loss - want_loss).abs().max().item()
            d_lse = (lse - want_lse).abs().max().item()
            check(loss.dtype == torch.float32 and loss.shape == (R,)
                  and torch.isfinite(loss).all().item()
                  and torch.allclose(loss, want_loss, rtol=tol, atol=tol)
                  and torch.allclose(lse, want_lse, rtol=tol, atol=tol),
                  f"{where}: kernel loss/lse != plain (max |Δ| {d_loss} / {d_lse}, "
                  f"tolerance {tol})")
            d_dx = (dx.float() - want_dx.float()).abs().max().item()
            if dtype == torch.float32:
                ok = torch.allclose(dx, want_dx, rtol=1e-5, atol=1e-5)
            else:  # one bf16 ulp of the output
                ulp = torch.finfo(dtype).eps * want_dx.float().abs().clamp_min(2 ** -126)
                ok = bool(((dx.float() - want_dx.float()).abs() <= ulp).all().item())
            check(ok and dx.dtype == dtype and dx.shape == x.shape,
                  f"{where}: kernel dlogits != plain (max |Δ| {d_dx})")
            err["fused_xent"] = max(err["fused_xent"], d_loss)
            err["fused_xent_bwd"] = max(err["fused_xent_bwd"], d_dx)
            if (R, V) == XENT_TIMED:
                for r in (1, 300):
                    lr_, lse_r = xent.launch_fwd(x[:r], lab[:r])
                    dx_r = xent.launch_bwd(x[:r], lab[:r], lse_r, cot[:r])
                    check(torch.equal(lr_, loss[:r]) and torch.equal(dx_r, dx[:r]),
                          f"{where}: rows {r} != the first {r} of {R} (not row-invariant)")
            print(f"{where}: loss max |Δ| {d_loss:.3g}, lse {d_lse:.3g} (tol {tol}); dlogits "
                  f"max |Δ| {d_dx:.3g}" + ("; rows 1 = 300 = 8192 bitwise"
                                           if (R, V) == XENT_TIMED else ""), flush=True)
            del x, lab, cot, loss, lse, dx, want_loss, want_lse, want_dx
        torch.cuda.empty_cache()

    R, V = XENT_TIMED
    rows = {"fused_xent": {}, "fused_xent_bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        x, lab, cot = _xent_operands(g, dev, dtype, R, V)
        lab64 = lab.long()
        _, lse = xent.launch_fwd(x, lab)
        ce = torch.nn.functional.cross_entropy
        k_ms, k_host = time_ms(lambda: xent.launch_fwd(x, lab), reps=20, trials=5)
        p_ms, p_host = time_ms(lambda: ref.fused_xent_fwd(x, lab), reps=5, trials=3)
        l_ms, l_host = time_ms(lambda: ce(x, lab64, reduction="none"), reps=20, trials=5)
        kb_ms, kb_host = time_ms(lambda: xent.launch_bwd(x, lab, lse, cot), reps=20, trials=5)
        pb_ms, pb_host = time_ms(lambda: ref.fused_xent_bwd(x, lab, lse, cot), reps=3,
                                 trials=3)
        b_ms, b_by = xent_bound(R, V, dtype, backward=False)
        bb_ms, bb_by = xent_bound(R, V, dtype, backward=True)
        name = str(dtype)[6:]
        print(f"fused_xent {name} {(R, V)}: kernel {k_ms:.4f} ms (host {k_host:.4f}), plain "
              f"{p_ms:.4f} ms (host {p_host:.4f}), F.cross_entropy {l_ms:.4f} ms (host "
              f"{l_host:.4f}), bound {b_ms:.4f} ms ({b_by})", flush=True)
        print(f"fused_xent_bwd {name} {(R, V)}: kernel {kb_ms:.4f} ms (host {kb_host:.4f}), "
              f"plain {pb_ms:.4f} ms (host {pb_host:.4f}), bound {bb_ms:.4f} ms ({bb_by}); "
              f"no single library call computes it", flush=True)
        rows["fused_xent"][name] = dict(ms=k_ms, plain_ms=p_ms, host_ms=k_host,
                                        plain_host_ms=p_host, bound_ms=b_ms, bound_by=b_by,
                                        library_ms=l_ms)
        rows["fused_xent_bwd"][name] = dict(ms=kb_ms, plain_ms=pb_ms, host_ms=kb_host,
                                            plain_host_ms=pb_host, bound_ms=bb_ms,
                                            bound_by=bb_by, library_ms=None)
        del x, lab, lab64, cot, lse
        torch.cuda.empty_cache()
    return rows, err


@contextlib.contextmanager
def plain_xent():
    """Route the LM loss's per-token cross entropy through the plain version
    (use_kernel=False; autograd of the plain ops for its backward)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    dispatch = T._xent_dispatch
    T._xent_dispatch = lambda logits, labels: ops.fused_xent(logits, labels,
                                                             use_kernel=False)
    try:
        yield
    finally:
        T._xent_dispatch = dispatch


def _data_key(device):
    """The train loop's data key, fold_in(PRNGKey(0), 1), on ``device``."""
    from repro_torch.kernels import prng

    return prng.fold_in_key(prng.PRNGKey(0, device=device), 1)


def _one_train_step(ops, cfg, params, batch):
    """One make_train_step step from fresh optimizer state -> (params,
    metrics, launch counts)."""
    from repro_torch.launch.steps import make_optimizer, make_train_step

    init, update = make_optimizer(cfg)
    ops.reset_launch_counts()
    new, _, metrics = make_train_step(cfg, update)(params, init(params), batch)
    torch.cuda.synchronize()
    return new, metrics, ops.launch_counts()


def lm_train_parity_checks(ops, dev, label: str) -> None:
    """Phase 19: one float32 training step of tinyllama-1.1b at full width
    and two layers, through fused_xent and flash_attention, against the same
    step on their plain versions; the card's token batches against the
    port's on the CPU, bitwise."""
    from repro_torch import optim, tree
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2, dtype=torch.float32)
    B, S = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"]
    for b, s, step in ((B, S, 0), (TRAIN_FULL["batch"], TRAIN_FULL["seq"], 0),
                       (TRAIN_FULL["batch"], TRAIN_FULL["seq"], 2)):
        on_card = token_batches(_data_key(dev), step, b, s, cfg.vocab)
        on_cpu = token_batches(_data_key("cpu"), step, b, s, cfg.vocab)
        check(all(torch.equal(on_card[k].cpu(), on_cpu[k]) for k in on_cpu),
              f"token_batches B={b} S={s} step {step}: the card's differ from the CPU's")
    print(f"[{label}] token_batches on the card = on the CPU, bitwise (B {B} × {S}, and "
          f"B {TRAIN_FULL['batch']} × {TRAIN_FULL['seq']} at steps 0 and 2)", flush=True)
    batch = token_batches(_data_key(dev), 0, B, S, cfg.vocab)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(41), cfg, device=dev)
    kp, km, kc = _one_train_step(ops, cfg, params, batch)
    with plain_attention(), plain_xent():
        pp, pm, pc = _one_train_step(ops, cfg, params, batch)
    # per step: one fused_xent and one fused_xent_bwd launch; flash_attention
    # once per layer in the forward and once more per layer in the backward,
    # where the per-unit checkpoint (cfg.remat) recomputes the unit.
    want = {"fused_xent": 1, "fused_xent_bwd": 1, "flash_attention": 2 * cfg.num_layers}
    check(all(kc[k] == n for k, n in want.items()),
          f"LM train parity: launches {kc}, want {want}")
    check(not any(pc.values()), f"LM train parity: the plain step launched {pc}")
    lr1 = optim.cosine_schedule(3e-4, 100, 10_000)(1)
    d_loss = abs(km["loss"].item() - pm["loss"].item()) / abs(pm["loss"].item())
    d_gn = abs(km["grad_norm"].item() - pm["grad_norm"].item()) / pm["grad_norm"].item()
    d_p = max((a - b).abs().max().item() for a, b in zip(tree.leaves(kp), tree.leaves(pp)))
    check(math.isfinite(km["loss"].item()) and d_loss <= TRAIN_LOSS_RTOL,
          f"LM train parity: loss {km['loss'].item()} vs {pm['loss'].item()} ({d_loss} rel)")
    check(d_gn <= TRAIN_GNORM_RTOL, f"LM train parity: grad_norm {km['grad_norm'].item()} vs "
          f"{pm['grad_norm'].item()} ({d_gn} rel)")
    check(d_p <= 2 * lr1, f"LM train parity: parameters differ by {d_p} > 2·lr_1 {2 * lr1}")
    print(f"[{label}] LM train parity ({TRAIN_ARCH}, float32, 2 layers, B={B}, S={S}): loss "
          f"{km['loss'].item():.6f} vs plain {pm['loss'].item():.6f} ({d_loss:.3g} rel, tol "
          f"{TRAIN_LOSS_RTOL}); grad_norm {d_gn:.3g} rel (tol {TRAIN_GNORM_RTOL}); "
          f"parameters max |Δ| {d_p:.3g} (tol 2·lr_1 = {2 * lr1:.3g}); launches {want}",
          flush=True)
    del params, kp, pp
    gc.collect()
    torch.cuda.empty_cache()


def _grad_peak_gb(cfg, params, batch) -> float:
    """Device memory one gradient of the training loss (forward and
    backward, no optimizer update) takes at its peak above what was
    allocated before it, in GB."""
    from repro_torch import tree
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves, spec = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = T.lm_loss(tree.unflatten(spec, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    del loss, grads, leaves
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def lm_train_checks(ops, dev, label: str) -> dict:
    """Phase 20: train(tinyllama-1.1b, 3 steps, B 4 × 2048, the full config,
    random bf16 weights drawn on the card), each step's launches counted;
    then peak memory with and without remat, a profile of one step, and the
    resume from a checkpoint.  Returns the launches per step."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod

    cfg = get_config(TRAIN_ARCH)
    B, S, n = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    per_step = []
    make_step = steps_mod.make_train_step

    def counted(cfg_, opt_update=None, grad_clip=1.0):
        inner = make_step(cfg_, opt_update, grad_clip)

        def step(params, opt_state, batch):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = inner(params, opt_state, batch)
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0, ops.launch_counts(),
                             {p.dtype for p in tree.leaves(out[0])}))
            return out

        return step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps_mod.make_train_step = counted
    try:
        params, losses = train_mod.train(TRAIN_ARCH, n, B, S, None, smoke=False, log_every=1)
    finally:
        steps_mod.make_train_step = make_step
    peak = torch.cuda.max_memory_allocated() / 1e9
    # per step: fused_xent forward 1 and backward 1 (the loss is one call over
    # all B·S tokens); flash_attention 22 in the forward (one per layer) plus
    # 22 in the backward, where the per-unit checkpoint recomputes each unit.
    want = {"fused_xent": 1, "fused_xent_bwd": 1, "flash_attention": 2 * cfg.num_layers}
    for i, (_, counts, dtypes) in enumerate(per_step):
        check(all(counts[k] == v for k, v in want.items()),
              f"train step {i}: launches {counts}, want {want}")
        check(dtypes == {torch.float32}, f"train step {i}: parameters come out {dtypes}, "
              f"want float32 (the reference's promotion)")
    check(len(losses) == n and all(map(math.isfinite, losses)), f"train losses {losses}")
    wall = statistics.median(w for w, _, _ in per_step[1:])
    print(f"[{label}] train {TRAIN_ARCH} (full config, {cfg.num_layers} layers, bf16 weights "
          f"drawn on the card, float32 from step 2), B={B} S={S}: losses {losses}; walls "
          f"{[round(w, 4) for w, _, _ in per_step]} s; median of steps 2-3 {wall:.4f} s = "
          f"{B * S / wall:.1f} tokens/s; peak device memory {peak:.3f} GB (remat on); "
          f"launches per step {want}", flush=True)

    peaks = {}
    for s_len, remat in ((S, True), (S // 2, True), (S // 2, False)):
        b = token_batches(_data_key(dev), 0, B, s_len, cfg.vocab)
        peaks[s_len, remat] = _grad_peak_gb(dataclasses.replace(cfg, remat=remat), params, b)
    print(f"[{label}] one gradient of the loss (float32 parameters), peak device memory above "
          f"the parameters: {peaks[S, True]:.3f} GB at B={B} S={S} with remat; at S={S // 2} "
          f"{peaks[S // 2, True]:.3f} GB with remat, {peaks[S // 2, False]:.3f} GB without",
          flush=True)

    from repro_torch.launch.steps import make_optimizer

    init, update = make_optimizer(cfg, total=n)
    opt_state = init(params)
    batch = token_batches(_data_key(dev), 2, B, S, cfg.vocab)
    step_fn = make_step(cfg, update)
    prof = profile_call(lambda: step_fn(params, opt_state, batch),
                        f"{label}] [{TRAIN_ARCH} train step B={B} S={S}")
    if prof["busy_ms"]:
        x_ms = sum(ms for name, ms in prof["by_name"].items() if "xent" in name)
        print(f"[{label}] {TRAIN_ARCH} train step: fused_xent (both kernels) {x_ms:.3f} ms of "
              f"{prof['busy_ms']:.3f} ms device busy ({x_ms / prof['busy_ms']:.4f})",
              flush=True)
    del params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-") as tmp:
        free = shutil.disk_usage(tmp).free / 1e9
        t0 = time.perf_counter()
        _, first = train_mod.train(TRAIN_ARCH, 2, B, S, tmp, smoke=False, log_every=1)
        gc.collect()
        torch.cuda.empty_cache()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, resumed = train_mod.train(TRAIN_ARCH, n, B, S, tmp, smoke=False, log_every=1)
        print(out.getvalue(), end="", flush=True)
        check("[train] resumed from step 2" in out.getvalue(), "the resumed run printed no "
              "resume line")
        check(first == losses[:2] and resumed == losses[2:],
              f"resume: losses {first} + {resumed} != the uninterrupted run's {losses}")
        print(f"[{label}] resume: 2 steps with a checkpoint, then a rerun to {n} resumed from "
              f"step 2; step {n}'s loss {resumed[0]} = the uninterrupted run's, bitwise "
              f"({time.perf_counter() - t0:.1f} s with the checkpoints; {free:.1f} GB free "
              f"before)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return want


def ssm_train_checks(ops, dev, label: str) -> None:
    """Phase 21: one gradient of mamba2-1.3b's training loss at full width,
    two layers, B 2 × 512, bfloat16, through ssd_chunk and fused_xent,
    against the plain route; every leaf's gradient finite."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=2)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(51), cfg, device=dev)
    batch = token_batches(_data_key(dev), 0, SSM_TRAIN["batch"], SSM_TRAIN["seq"], cfg.vocab)

    def grads():
        ops.reset_launch_counts()
        leaves, spec = tree.flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, _ = T.lm_loss(tree.unflatten(spec, leaves), cfg, batch)
        gr = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        return loss.item(), gr, ops.launch_counts()

    k_loss, k_g, kc = grads()
    with plain_ssd(), plain_xent():
        p_loss, p_g, pc = grads()
    # ssd_chunk once per layer forward and once more per layer in the
    # recomputing backward (remat); the loss one forward and one backward.
    want = {"fused_xent": 1, "fused_xent_bwd": 1, "ssd_chunk": 2 * cfg.num_layers}
    check(all(kc[k] == v for k, v in want.items()), f"mamba2 train: launches {kc}, want {want}")
    check(not any(pc.values()), f"mamba2 train: the plain route launched {pc}")
    rel = abs(k_loss - p_loss) / abs(p_loss)
    check(math.isfinite(k_loss) and rel <= SSM_LOSS_RTOL,
          f"mamba2 train: loss {k_loss} vs plain {p_loss} ({rel} rel)")
    bad = sum(gr is None or not torch.isfinite(gr.float()).all().item() for gr in k_g)
    check(bad == 0, f"mamba2 train: {bad} of {len(k_g)} leaves have no or a non-finite gradient")
    gn = math.sqrt(sum(gr.float().pow(2).sum().item() for gr in k_g))
    pgn = math.sqrt(sum(gr.float().pow(2).sum().item() for gr in p_g if gr is not None))
    print(f"[{label}] mamba2 train ({SSM_ARCH}, bf16, 2 layers, B={SSM_TRAIN['batch']} "
          f"S={SSM_TRAIN['seq']}): loss {k_loss:.5f} vs plain route {p_loss:.5f} ({rel:.3g} "
          f"rel, tol {SSM_LOSS_RTOL}); gradient norm {gn:.5g} vs {pgn:.5g}; all {len(k_g)} "
          f"leaves finite; launches {want}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 23-25: the MoE and hybrid families (dbrx-132b, grok-1-314b,
# jamba-v0.1-52b)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("dbrx-132b", "grok-1-314b", "jamba-v0.1-52b")
# float32 parity at full width (phase 23): the depth cut as phases 13 and 16
# cut theirs; jamba's one unit is 8 layers (1 attention, 7 Mamba2, 4 MoE),
# 53 GB of float32 weights.
MOE_PARITY_LAYERS = {"dbrx-132b": 2, "grok-1-314b": 2, "jamba-v0.1-52b": 8}
# bfloat16 serving at LM_SERVE's B 4 x 2048 + 16 (phase 24): jamba's one unit
# (26.5 GB), dbrx at 4 of its 40 layers (28.5 GB).
MOE_SERVE_LAYERS = {"jamba-v0.1-52b": 8, "dbrx-132b": 4}
# the train CLI's LM defaults (--batch 8 --seq 64) on the smoke configs (phase 25)
MOE_TRAIN = dict(batch=8, seq=64, steps=3)
MOE_RANGES = {"moe_apply": "moe", "moe_dispatch": "moe.dispatch",
              "moe_experts": "moe.experts", "moe_combine": "moe.combine"}


def _path_launches(cfg) -> dict:
    """The hand kernels one prefill of ``cfg`` launches: flash_attention once
    per attention layer, ssd_chunk once per Mamba2 layer."""
    from repro_torch.models import transformer as T

    mixers = [m for m, _ in T.unit_pattern(cfg)] * T.num_units(cfg)
    return {"flash_attention": mixers.count("attn"), "ssd_chunk": mixers.count("mamba")}


@contextlib.contextmanager
def recorded_routes(replay=None):
    """Record every ``moe_topk`` call's router logits and chosen experts, in
    call order; with ``replay`` (an earlier run's record), route each call
    with that run's experts instead, this run's own choice recorded beside
    them (its weights are this run's probabilities at those experts,
    normalised as ``moe_topk`` does, so an equal choice gives equal bits)."""
    from repro_torch.models import layers

    topk = layers.moe_topk
    calls = []

    def routed(logits, k):
        w, idx = topk(logits, k)
        calls.append((logits.detach(), idx))
        if replay is not None:
            idx = replay[len(calls) - 1][1]
            w = torch.softmax(logits, dim=-1).gather(-1, idx)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, idx

    layers.moe_topk = routed
    try:
        yield calls
    finally:
        layers.moe_topk = topk


def route_flips(ref_calls, calls, k: int) -> tuple:
    """Choices of ``calls`` whose expert set differs from ``ref_calls``' ->
    (flips, choices, the router logits' max |Δ| and largest |logit|, the
    k-th minus (k+1)-th probability of ``calls`` at each flip)."""
    flips = total = 0
    d = top = 0.0
    margins = []
    for (ref_logits, ref_idx), (logits, idx) in zip(ref_calls, calls):
        moved = (ref_idx.sort(-1).values != idx.sort(-1).values).any(-1)
        flips += int(moved.sum())
        total += moved.numel()
        d = max(d, (logits - ref_logits).abs().max().item())
        top = max(top, ref_logits.abs().max().item())
        if moved.any() and logits.shape[-1] > k:
            p = torch.softmax(logits, dim=-1).sort(-1, descending=True).values
            margins += (p[..., k - 1] - p[..., k])[moved].tolist()
    return flips, total, d, top, margins


def moe_parity_checks(ops, dev, label: str) -> dict:
    """Phase 23: float32 at full width and MOE_PARITY_LAYERS, B 2, a 512-token
    prefill and 8 greedy decode steps through the kernels, twice more
    prefilled through them (bits equal: the combine has no atomics), and
    once with every attention and SSD scan plain, routed with the kernel
    run's experts (route_flips reports where its own choice would differ,
    and the margin there).  The prefill logits within LM_LOGIT_RTOL of the
    largest, the router logits too, the tokens equal, flash_attention once
    per attention layer and ssd_chunk once per Mamba2 layer of a prefill,
    neither in decode.  Returns {arch: prefill launches}."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    check(not torch.backends.cuda.matmul.allow_tf32, "MoE parity: TF32 is on; the router "
          "product must run in float32")
    B, S, gen = LM_PARITY["batch"], LM_PARITY["prompt_len"], LM_PARITY["gen"]
    out = {}
    for arch, n_layers in MOE_PARITY_LAYERS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=n_layers, dtype=torch.float32)
        params = T.init_lm(torch.Generator(device=dev).manual_seed(33), cfg, device=dev)
        prompts = lm_prompts(33, B, S, cfg.vocab).to(dev)
        want = _path_launches(cfg)
        with recorded_routes() as k_calls:
            kernel = _greedy(cfg, params, prompts, gen)
        prefill = make_prefill_step(cfg, max_len=S + gen)
        first, again = (prefill(params, {"tokens": prompts}) for _ in range(2))
        torch.cuda.synchronize()
        same = (torch.equal(first[0].float(), kernel[0]) and torch.equal(first[0], again[0])
                and all(torch.equal(a, b) for a, b in zip(tree.leaves(first[1]),
                                                          tree.leaves(again[1]))))
        del first, again
        with plain_attention(), plain_ssd(), recorded_routes(replay=k_calls) as p_calls:
            plain_run = _greedy(cfg, params, prompts, gen)
        check(kernel[2] == want and not any(kernel[3].values()),
              f"MoE parity ({arch}): launches {kernel[2]} per prefill, {kernel[3]} in decode "
              f"(want {want} and none)")
        check(not any(plain_run[2].values()) and not any(plain_run[3].values()),
              f"MoE parity ({arch}): the plain run launched {plain_run[2:]}")
        check(same, f"MoE parity ({arch}): three kernel prefills are not bitwise equal")
        check(len(p_calls) == len(k_calls) == T.num_units(cfg) * sum(
            f == "moe" for _, f in T.unit_pattern(cfg)) * (gen + 1),
              f"MoE parity ({arch}): {len(k_calls)} / {len(p_calls)} routings")
        flips, total, d_router, top_router, margins = route_flips(k_calls, p_calls, cfg.top_k)
        check(torch.isfinite(kernel[0]).all().item(), f"MoE parity ({arch}): non-finite logits")
        diff = (kernel[0] - plain_run[0]).abs().max().item()
        top = plain_run[0].abs().max().item()
        check(diff <= LM_LOGIT_RTOL * top, f"MoE parity ({arch}): prefill logits differ by "
              f"{diff} (largest logit {top}, tolerance {LM_LOGIT_RTOL} of it)")
        check(d_router <= LM_LOGIT_RTOL * top_router, f"MoE parity ({arch}): router logits "
              f"differ by {d_router} (largest {top_router})")
        check(torch.equal(kernel[1], plain_run[1]), f"MoE parity ({arch}): greedy tokens "
              f"differ {kernel[1].tolist()} vs {plain_run[1].tolist()}")
        print(f"[{label}] MoE parity ({arch}, float32, {n_layers} layers, B={B}, S={S}): "
              f"prefill logits max |Δ| {diff:.3g} (largest {top:.3g}; {diff / top:.3g} "
              f"relative, tolerance {LM_LOGIT_RTOL}); router logits max |Δ| {d_router:.3g} "
              f"(largest {top_router:.3g}); {flips} of {total} top-{cfg.top_k} choices would "
              f"flip on the plain route (margins {[f'{m:.3g}' for m in margins]}); {gen + 1} "
              f"greedy tokens equal on every row; three kernel prefills bitwise equal; "
              f"launches {kernel[2]} per prefill, {kernel[3]} in decode; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[arch] = dict(launches=kernel[2], flips=flips, choices=total, margins=margins,
                         max_rel=diff / top, router_max_abs=d_router)
        del params, kernel, plain_run, k_calls, p_calls
        gc.collect()
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def moe_ranges():
    """The MoE layer's stages as profiler ranges (MOE_RANGES); the routing
    (router product, top-k, slots) is the rest of the ``moe`` range."""
    from torch.profiler import record_function

    from repro_torch.models import layers

    saved = {name: getattr(layers, name) for name in MOE_RANGES}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    for name, rng in MOE_RANGES.items():
        setattr(layers, name, ranged(rng, saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(layers, name, fn)


def profile_moe(fn, label: str) -> dict:
    """One call profiled with host and device activity, the MoE stages as
    ranges: wall (median of 3 synchronised calls), device busy (the device
    kernels and copies), idle share, and the device ms of the MoE's routing,
    dispatch, expert products and combine beside flash_attention and
    ssd_chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    with moe_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ranges = set(MOE_RANGES.values())
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.key not in ranges and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in device) / 1e3
    if not device:
        print(f"[{label}: wall {wall_ms:.3f} ms; device time not measured (the profiler "
              f"recorded no device events)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=None, idle=None, shares=None)
    host = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key in ranges}
    parts = {"moe routing": host.get("moe", 0.0) - sum(
        host.get(r, 0.0) for r in ranges - {"moe"}),
             "moe dispatch": host.get("moe.dispatch", 0.0),
             "moe expert products": host.get("moe.experts", 0.0),
             "moe combine": host.get("moe.combine", 0.0)}
    for kernel in LM_PATH_KERNELS:
        parts[kernel] = sum(_device_us(e) for e in device if kernel in e.key) / 1e3
    idle = round(1 - busy_ms / wall_ms, 3)
    shares = {k: round(v / busy_ms, 4) for k, v in parts.items()}
    print(f"[{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({sum(e.count for e in device)} device kernels and copies), idle share {idle:.3f}; "
          f"device ms {({k: round(v, 3) for k, v in parts.items()})}, share of busy "
          f"{shares}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=idle, ms=parts, shares=shares)


def moe_serve_checks(ops, dev, label: str) -> dict:
    """Phase 24: bfloat16 serving at full width, MOE_SERVE_LAYERS deep, with
    random weights drawn on the card: the parameter count against
    param_count, a prefill of B 4 x 2048 and 15 greedy decode steps through
    make_prefill_step and make_serve_step (serve_lm's loop: it builds the
    full depth), launches counted (flash_attention once per attention layer
    and ssd_chunk once per Mamba2 layer of the prefill, neither in decode),
    peak memory, the decode bound (every expert's weights are read: each
    computes its capacity rows, empty or not), profiles of one prefill and
    one decode step; then the serve CLI (``--workload lm --arch``, the smoke
    config) of the three archs.  Returns {arch: prefill launches}."""
    from repro_torch import tree
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.counting import param_count

    B, S, gen = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    out = {}
    for arch, n_layers in MOE_SERVE_LAYERS.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
        t0 = time.perf_counter()
        params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        n_params = sum(a.numel() for a in tree.leaves(params))
        active = param_count(cfg, active_only=True)
        check(n_params == param_count(cfg), f"{arch}: {n_params} parameters, param_count "
              f"{param_count(cfg)}")
        w_bytes = _tree_bytes(params)
        active_bytes = w_bytes - (n_params - active) * 2  # the idle experts' bf16 words
        print(f"[{label}] {arch} (bf16, {n_layers} of {get_config(arch).num_layers} layers): "
              f"{n_params} parameters (= param_count; {active} active), weights "
              f"{w_bytes / 1e9:.3f} GB drawn on the card in {time.perf_counter() - t0:.1f} s; "
              f"a decode step's bound {w_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (every "
              f"weight read once: all {cfg.num_experts} experts compute their capacity rows; "
              f"{active_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms if only the top-{cfg.top_k} "
              f"were read)", flush=True)
        want = _path_launches(cfg)
        prompts = lm_prompts(0, B, S, cfg.vocab).to(dev)
        prefill, decode = make_prefill_step(cfg, max_len=S + gen), make_serve_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        n_prefill = {k: ops.launch_counts()[k] for k in LM_PATH_KERNELS}
        token = greedy_sample(logits)
        tokens = [token]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, caches = decode(params, caches, token, S + i)
            token = greedy_sample(logits)
            tokens.append(token)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        n_decode = {k: ops.launch_counts()[k] - n_prefill[k] for k in LM_PATH_KERNELS}
        tokens = torch.cat(tokens, 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(n_prefill == want and not any(n_decode.values()),
              f"{arch} serve: launches {n_prefill} in the prefill, {n_decode} in decode "
              f"(want {want} and none)")
        check(tokens.shape == (B, gen) and 0 <= int(tokens.min())
              and int(tokens.max()) < cfg.vocab and torch.isfinite(logits.float()).all().item(),
              f"{arch} serve: bad tokens {tuple(tokens.shape)} or non-finite logits")
        print(f"[{label}] {arch} serve B={B} prompt {S} gen {gen}: prefill "
              f"{t_prefill * 1e3:.1f} ms, decode {gen - 1} steps @ "
              f"{B * (gen - 1) / t_decode:.1f} tok/s ({t_decode / (gen - 1) * 1e3:.2f} ms a "
              f"step); peak device memory {peak:.3f} GB ({base / 1e9:.3f} GB before); "
              f"launches {n_prefill} in the prefill, {n_decode} in decode", flush=True)
        del caches
        prof_prefill = profile_moe(lambda: prefill(params, {"tokens": prompts}),
                                   f"{label}] [{arch} prefill B={B} S={S}")
        logits, caches = prefill(params, {"tokens": prompts})
        token = greedy_sample(logits)
        prof_decode = profile_moe(lambda: decode(params, caches, token, S),
                                  f"{label}] [{arch} decode step B={B}, cache {S + gen} slots")
        out[arch] = dict(launches=n_prefill, prefill_ms=t_prefill * 1e3,
                         decode_tok_s=B * (gen - 1) / t_decode, peak_gb=peak,
                         params=n_params, decode_bound_ms=w_bytes / HBM_BYTES_PER_S * 1e3,
                         profile_prefill=prof_prefill, profile_decode=prof_decode)
        del params, caches, logits
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MOE_ARCHS:
        ops.reset_launch_counts()
        tokens = serve_cli.main(["--workload", "lm", "--arch", arch])
        torch.cuda.synchronize()
        want = _path_launches(smoke_config(arch))
        got = {k: ops.launch_counts()[k] for k in LM_PATH_KERNELS}
        check(got == want and tokens.shape == (4, 16),
              f"the CLI (--workload lm --arch {arch}, smoke config): launches {got} (want "
              f"{want}), tokens {tuple(tokens.shape)}")
        print(f"[{label}] serve CLI --workload lm --arch {arch} (smoke config): launches "
              f"{got}, tokens {tuple(tokens.shape)}", flush=True)
    return out


def moe_train_checks(ops, dev, label: str) -> dict:
    """Phase 25: the train CLI (``--workload lm --arch``, the smoke configs,
    float32) MOE_TRAIN['steps'] steps on the card, each step's launches and
    metrics read: finite losses, ``moe_aux`` > 0 and in the loss at 0.01,
    fused_xent and fused_xent_bwd once a step, flash_attention once per
    attention layer and ssd_chunk once per Mamba2 layer (the smoke configs
    do not remat); then one gradient of the loss twice: the router and
    every expert finite, the router's nonzero, and which leaves' bits do
    not repeat (the dispatch gather's backward, like the embedding's, is
    autograd's index backward).  Returns {arch: launches per step}."""
    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.data import token_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T

    make_step = steps_mod.make_train_step
    out = {}
    for arch in MOE_ARCHS:
        cfg = smoke_config(arch)
        per_step = []

        def counted(cfg_, opt_update=None, grad_clip=1.0):
            inner = make_step(cfg_, opt_update, grad_clip)

            def step(params, opt_state, batch):
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                res = inner(params, opt_state, batch)
                torch.cuda.synchronize()
                per_step.append((ops.launch_counts(), {k: float(v) for k, v in res[2].items()}))
                return res

            return step

        steps_mod.make_train_step = counted
        try:
            losses = train_mod.main(["--workload", "lm", "--arch", arch, "--steps",
                                     str(MOE_TRAIN["steps"]), "--batch",
                                     str(MOE_TRAIN["batch"]), "--seq", str(MOE_TRAIN["seq"])])
        finally:
            steps_mod.make_train_step = make_step
        want = dict(_path_launches(cfg), fused_xent=1, fused_xent_bwd=1)
        for i, (counts, m) in enumerate(per_step):
            check(all(counts[k] == v for k, v in want.items()),
                  f"{arch} train step {i}: launches {counts}, want {want}")
            check(all(map(math.isfinite, m.values())) and m["moe_aux"] > 0
                  and abs(m["loss"] - (m["xent"] + 0.01 * m["moe_aux"])) <= 1e-6 * m["loss"],
                  f"{arch} train step {i}: metrics {m} (want finite, moe_aux > 0, loss = "
                  f"xent + 0.01 moe_aux)")
        check(len(per_step) == len(losses) == MOE_TRAIN["steps"], f"{arch}: {len(per_step)} "
              f"steps counted, losses {losses}")

        params = T.init_lm(torch.Generator(device=dev).manual_seed(61), cfg, device=dev)
        batch = token_batches(_data_key(dev), 0, MOE_TRAIN["batch"], MOE_TRAIN["seq"], cfg.vocab)

        leaves, spec = tree.flatten(params)
        paths = tree.unflatten(spec, list(range(len(leaves))))
        paths = {i: f"units[{j}].{part}.{name}" for j, u in enumerate(paths["units"])
                 for part, d in u.items() for name, i in d.items()} | {
            paths["embed"]: "embed", paths["head"]: "head"}

        def grads():
            xs = [x.detach().requires_grad_() for x in leaves]
            loss, _ = T.lm_loss(tree.unflatten(spec, xs), cfg, batch)
            return torch.autograd.grad(loss, xs)

        g1, g2 = grads(), grads()
        torch.cuda.synchronize()
        moe = [u["ffn"] for u in tree.unflatten(spec, g1)["units"]
               if "ffn" in u and "router" in u["ffn"]]
        check(moe and all(torch.isfinite(g).all().item() for f in moe for g in f.values())
              and all(f["router"].abs().sum().item() > 0 for f in moe),
              f"{arch}: a MoE gradient is non-finite, or a router's is zero")
        repeat = [paths.get(i, f"leaf {i}") for i, (a, b) in enumerate(zip(g1, g2))
                  if not torch.equal(a, b)]
        print(f"[{label}] train CLI --workload lm --arch {arch} (smoke, float32, B="
              f"{MOE_TRAIN['batch']} S={MOE_TRAIN['seq']}): losses {losses}; moe_aux "
              f"{[round(m['moe_aux'], 5) for _, m in per_step]} (in the loss at 0.01); "
              f"launches per step {want}; the router and expert gradients of all "
              f"{sum(f['router'].shape[0] for f in moe)} MoE layers finite; two gradients "
              f"differ bitwise in "
              f"{repeat or 'no leaf'}", flush=True)
        out[arch] = dict(launches=want, gradient_bits_differ=repeat, losses=losses)
        del params, g1, g2
        gc.collect()
        torch.cuda.empty_cache()
    return out


ZOO_ARCHS = ("minicpm3-4b", "pixtral-12b", "seamless-m4t-medium")
# the encoder-decoder's source frames in phases 26-27 (its stub frontend's
# frontend_len, as pixtral's prefix rows)
ZOO_SRC_LEN = 1024
ZOO_TRAIN = dict(batch=8, seq=64, steps=3)
# phase 28's reversible stack: tinyllama's smoke config at 4 units against
# the plain two-track recursion, and tinyllama's full width at 4 and 8
# layers (f32, B 2 x 512) for the peak memory of one gradient
REV_UNITS = 4
REV_MEMORY = dict(batch=2, seq=512, units=(4, 8))
# a reversible gradient against the two-track recursion: both float32 on
# the card, the same kernels; the adjoint reconstructs each unit's input in
# closed form instead of keeping it, which moves the last bits
REV_GRAD_RTOL = 1e-4


def _zoo_launches(cfg) -> int:
    """flash_attention launches in one prefill (or training forward) of a
    zoo model: one per attention layer; the encoder-decoder's encoder layers
    once each and its decoder layers twice (self and cross)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _zoo_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """Prompts (lm_prompts), and pixtral's prefix (serve.lm_prefix: the
    reference's normal draw) or the encoder-decoder's ZOO_SRC_LEN source
    frames (a normal draw of the same key) in cfg.dtype."""
    from repro_torch.kernels import prng
    from repro_torch.launch.serve import lm_prefix, lm_prompts

    batch = {"tokens": lm_prompts(seed, B, S, cfg.vocab).to(dev)}
    if cfg.family == "encdec":
        key = prng.fold_in_key(prng.PRNGKey(seed, device=dev), 2)
        batch["src_embeds"] = prng.normal_like(key[0], key[1], (B, ZOO_SRC_LEN, cfg.d_model),
                                               cfg.dtype)
    elif cfg.frontend:
        batch["embeds"] = lm_prefix(seed, B, cfg).to(dev)
    return batch


def _greedy_batch(cfg, params, batch: dict, gen: int) -> tuple:
    """Prefill ``batch`` (with its prefix or source), then ``gen`` greedy
    decode steps -> (prefill logits, tokens, flash_attention launches in
    the prefill, in the decode)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step

    pos = batch["tokens"].shape[1] + (batch["embeds"].shape[1] if "embeds" in batch else 0)
    ops.reset_launch_counts()
    logits, caches = make_prefill_step(cfg, max_len=pos + gen)(params, batch)
    torch.cuda.synchronize()
    n_prefill = ops.launch_counts()["flash_attention"]
    decode = make_serve_step(cfg)
    token = greedy_sample(logits)
    tokens = [token]
    for i in range(gen):
        step_logits, caches = decode(params, caches, token, pos + i)
        token = greedy_sample(step_logits)
        tokens.append(token)
    torch.cuda.synchronize()
    n_decode = ops.launch_counts()["flash_attention"] - n_prefill
    return logits.float(), torch.cat(tokens, 1), n_prefill, n_decode


def zoo_parity_checks(ops, dev, label: str) -> dict:
    """Phase 26: minicpm3-4b, pixtral-12b (its 1024-row prefix) and
    seamless-m4t-medium (ZOO_SRC_LEN source frames) in float32 at full
    width, two layers (seamless two encoder and two decoder layers), B 2 x
    512 + 8 greedy steps, through the kernel and with every attention
    plain: the prefill logits within LM_LOGIT_RTOL of the largest, the
    tokens equal; flash_attention once per attention of a prefill (seamless:
    once per encoder layer, twice per decoder layer), never in decode;
    three kernel prefills bitwise equal.  Returns {arch: launches a
    prefill}."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    B, S, gen = LM_PARITY["batch"], LM_PARITY["prompt_len"], LM_PARITY["gen"]
    out = {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype=torch.float32,
                                  **({"encoder_layers": 2} if get_config(arch).encoder_layers
                                     else {}))
        params = T.init_lm(torch.Generator(device=dev).manual_seed(34), cfg, device=dev)
        batch = _zoo_batch(cfg, B, S, 34, dev)
        want = _zoo_launches(cfg)
        kernel = _greedy_batch(cfg, params, batch, gen)
        pos = S + (batch["embeds"].shape[1] if "embeds" in batch else 0)
        prefill = make_prefill_step(cfg, max_len=pos + gen)
        first, again = (prefill(params, batch) for _ in range(2))
        torch.cuda.synchronize()
        same = (torch.equal(first[0], again[0]) and torch.equal(first[0].float(), kernel[0])
                and all(torch.equal(a, b) for a, b in zip(tree.leaves(first[1]),
                                                          tree.leaves(again[1]))))
        del first, again
        with plain_attention():
            plain_run = _greedy_batch(cfg, params, batch, gen)
        check(kernel[2:] == (want, 0), f"zoo parity ({arch}): flash_attention launched "
              f"{kernel[2]} times in the prefill, {kernel[3]} in decode (want {want}, 0)")
        check(plain_run[2:] == (0, 0), f"zoo parity ({arch}): the plain run launched "
              f"{plain_run[2:]}")
        check(same, f"zoo parity ({arch}): three kernel prefills are not bitwise equal")
        check(torch.isfinite(kernel[0]).all().item(), f"zoo parity ({arch}): non-finite logits")
        diff = (kernel[0] - plain_run[0]).abs().max().item()
        top = plain_run[0].abs().max().item()
        check(diff <= LM_LOGIT_RTOL * top, f"zoo parity ({arch}): prefill logits differ by "
              f"{diff} (largest logit {top}, tolerance {LM_LOGIT_RTOL} of it)")
        check(torch.equal(kernel[1], plain_run[1]), f"zoo parity ({arch}): greedy tokens "
              f"differ {kernel[1].tolist()} vs {plain_run[1].tolist()}")
        extra = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
        print(f"[{label}] zoo parity ({arch}, float32, {cfg.num_layers} layers"
              f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, B={B}, "
              f"S={S}, {extra or 'no prefix'}): prefill logits max |Δ| {diff:.3g} (largest "
              f"{top:.3g}; {diff / top:.3g} relative, tolerance {LM_LOGIT_RTOL}); {gen + 1} "
              f"greedy tokens equal on every row; three kernel prefills bitwise equal; "
              f"flash_attention {kernel[2]} per prefill, {kernel[3]} in decode; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[arch] = dict(launches=kernel[2], max_rel=diff / top)
        del params, kernel, plain_run, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zoo_serve_checks(ops, dev, label: str) -> dict:
    """Phase 27: minicpm3-4b, pixtral-12b and seamless-m4t-medium in
    bfloat16 at full width and full depth, random weights drawn on the
    card: the parameter count against param_count, a prefill of LM_SERVE's
    B 4 x 2048 (pixtral behind its 1024-row prefix, seamless over
    ZOO_SRC_LEN source frames) and 15 greedy decode steps through
    make_prefill_step / make_serve_step (serve_lm's loop), flash_attention
    once per attention of the prefill (62 / 40 / 36) and never in decode,
    peak memory, each decode step against its weight-read bound, profiles
    of one prefill (busy, idle, flash_attention's share) and one decode
    step; then the serve CLI on the minicpm3 and pixtral smoke configs and
    its refusal of seamless.  Returns {arch: {...}}."""
    from repro_torch import tree
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.counting import param_count

    B, S, gen = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    out = {}
    for arch in ZOO_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        n_params = sum(a.numel() for a in tree.leaves(params))
        check(n_params == param_count(cfg), f"{arch}: {n_params} parameters, param_count "
              f"{param_count(cfg)}")
        w_bytes = _tree_bytes(params)
        bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
        print(f"[{label}] {arch} (bf16, {cfg.num_layers} layers"
              f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, full "
              f"width and depth): {n_params} parameters (= param_count), weights "
              f"{w_bytes / 1e9:.3f} GB drawn on the card in {time.perf_counter() - t0:.1f} s; "
              f"a decode step's bound (the weights read once) {bound_ms:.3f} ms", flush=True)
        want = _zoo_launches(cfg)
        batch = _zoo_batch(cfg, B, S, 0, dev)
        pos = S + (batch["embeds"].shape[1] if "embeds" in batch else 0)
        prefill, decode = make_prefill_step(cfg, max_len=pos + gen), make_serve_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        n_prefill = ops.launch_counts()["flash_attention"]
        token = greedy_sample(logits)
        tokens = [token]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, caches = decode(params, caches, token, pos + i)
            token = greedy_sample(logits)
            tokens.append(token)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        n_decode = ops.launch_counts()["flash_attention"] - n_prefill
        tokens = torch.cat(tokens, 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(n_prefill == want and n_decode == 0, f"{arch} serve: flash_attention "
              f"{n_prefill} in the prefill, {n_decode} in decode (want {want} and none)")
        check(tokens.shape == (B, gen) and 0 <= int(tokens.min())
              and int(tokens.max()) < cfg.vocab and torch.isfinite(logits.float()).all().item(),
              f"{arch} serve: bad tokens {tuple(tokens.shape)} or non-finite logits")
        step_ms = t_decode / (gen - 1) * 1e3
        print(f"[{label}] {arch} serve B={B} prompt {S}{f' + prefix {pos - S}' if pos > S else ''}"
              f"{f' over {ZOO_SRC_LEN} source frames' if cfg.encoder_layers else ''} gen {gen}: "
              f"prefill {t_prefill * 1e3:.1f} ms, decode {gen - 1} steps @ "
              f"{B * (gen - 1) / t_decode:.1f} tok/s ({step_ms:.2f} ms a step against the "
              f"{bound_ms:.3f} ms bound: {step_ms / bound_ms:.1f}x); peak device memory "
              f"{peak:.3f} GB ({base / 1e9:.3f} GB before); flash_attention {n_prefill} in "
              f"the prefill, {n_decode} in decode", flush=True)
        del caches
        prof = profile_call(lambda: prefill(params, batch), f"{label}] [{arch} prefill B={B} S={S}")
        k_ms = sum(ms for name, ms in (prof["by_name"] or {}).items() if "flash_attention" in name)
        share = k_ms / prof["busy_ms"] if prof["busy_ms"] else None
        if share is not None:
            print(f"[{label}] {arch} prefill: flash_attention {k_ms:.3f} ms of "
                  f"{prof['busy_ms']:.3f} ms device busy ({share:.4f})", flush=True)
        logits, caches = prefill(params, batch)
        token = greedy_sample(logits)
        prof_d = profile_call(lambda: decode(params, caches, token, pos),
                              f"{label}] [{arch} decode step B={B}")
        out[arch] = dict(launches=n_prefill, prefill_ms=t_prefill * 1e3,
                         decode_tok_s=B * (gen - 1) / t_decode, decode_step_ms=step_ms,
                         decode_bound_ms=bound_ms, peak_gb=peak, params=n_params,
                         prefill_busy_ms=prof["busy_ms"], prefill_idle=prof.get("idle"),
                         attention_share=share, decode_busy_ms=prof_d["busy_ms"],
                         decode_idle=prof_d.get("idle"))
        del params, caches, logits, batch
        gc.collect()
        torch.cuda.empty_cache()
    for arch in ZOO_ARCHS[:2]:
        ops.reset_launch_counts()
        tokens = serve_cli.main(["--workload", "lm", "--arch", arch])
        torch.cuda.synchronize()
        want = _zoo_launches(smoke_config(arch))
        got = ops.launch_counts()["flash_attention"]
        check(got == want and tokens.shape == (4, 16), f"the CLI (--workload lm --arch "
              f"{arch}, smoke config): flash_attention {got} (want {want}), tokens "
              f"{tuple(tokens.shape)}")
        print(f"[{label}] serve CLI --workload lm --arch {arch} (smoke config): "
              f"flash_attention {got}, tokens {tuple(tokens.shape)}", flush=True)
    try:
        serve_cli.main(["--workload", "lm", "--arch", "seamless-m4t-medium"])
    except SystemExit as e:
        check("decoder-only" in str(e), f"the serve CLI's seamless refusal: {e}")
        print(f"[{label}] serve CLI --arch seamless-m4t-medium: refused ({e})", flush=True)
    else:
        check(False, "the serve CLI served the encoder-decoder")
    return out


def _rev_grads(cfg, params, x):
    """Gradients of sum(stack(x)²) with respect to every unit leaf and x, by
    the reversible stack when ``cfg.reversible_residual``, else by autograd
    of the plain two-track recursion (the reference's ``ref_two_track``)."""
    from repro_torch import tree
    from repro_torch.models import transformer as T
    from repro_torch.models.reversible import reversible_stack

    leaves, spec = tree.flatten(params["units"])
    leaves = [a.detach().requires_grad_() for a in leaves]
    units, x = tree.unflatten(spec, leaves), x.detach().requires_grad_()
    if cfg.reversible_residual:
        z = reversible_stack(cfg, units, x, T._unit_residual)
    else:
        n = T.num_units(cfg)
        z = zh = x
        mu = T._unit_residual(T._layer(units, 0), cfg, zh)
        for i in range(n):
            zh1 = 2 * z - zh + mu
            mu1 = T._unit_residual(T._layer(units, min(i + 1, n - 1)), cfg, zh1)
            z, zh, mu = z + 0.5 * (mu + mu1), zh1, mu1
    return z.detach(), torch.autograd.grad(z.square().sum(), [*leaves, x])


def zoo_train_checks(ops, dev, label: str) -> dict:
    """Phase 28: the train CLI (``--workload lm --arch``, smoke configs,
    float32) ZOO_TRAIN['steps'] steps on the three archs, each step's
    launches and metrics read (finite losses; flash_attention once per
    attention of the forward, fused_xent and fused_xent_bwd once); one
    gradient of a REV_UNITS-unit reversible tinyllama smoke stack against
    the plain two-track recursion (REV_GRAD_RTOL of each leaf's largest);
    the peak memory of one gradient of tinyllama at full width, f32, at
    REV_MEMORY's depths: reversible, remat, neither.  Returns {...}."""
    from repro_torch import tree
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import token_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T

    make_step = steps_mod.make_train_step
    out = {"launches": {}}
    for arch in ZOO_ARCHS:
        cfg = smoke_config(arch)
        per_step = []

        def counted(cfg_, opt_update=None, grad_clip=1.0):
            inner = make_step(cfg_, opt_update, grad_clip)

            def step(params, opt_state, batch):
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                res = inner(params, opt_state, batch)
                torch.cuda.synchronize()
                per_step.append((ops.launch_counts(), {k: float(v) for k, v in res[2].items()}))
                return res

            return step

        steps_mod.make_train_step = counted
        try:
            losses = train_mod.main(["--workload", "lm", "--arch", arch, "--steps",
                                     str(ZOO_TRAIN["steps"]), "--batch", str(ZOO_TRAIN["batch"]),
                                     "--seq", str(ZOO_TRAIN["seq"])])
        finally:
            steps_mod.make_train_step = make_step
        want = {"flash_attention": _zoo_launches(cfg), "fused_xent": 1, "fused_xent_bwd": 1}
        for i, (counts, m) in enumerate(per_step):
            check(all(counts[k] == v for k, v in want.items()),
                  f"{arch} train step {i}: launches {counts}, want {want}")
            check(all(map(math.isfinite, m.values())), f"{arch} train step {i}: metrics {m}")
        check(len(per_step) == len(losses) == ZOO_TRAIN["steps"], f"{arch}: {len(per_step)} "
              f"steps counted, losses {losses}")
        print(f"[{label}] train CLI --workload lm --arch {arch} (smoke, float32, B="
              f"{ZOO_TRAIN['batch']} S={ZOO_TRAIN['seq']}): losses {losses}; launches per step "
              f"{want}", flush=True)
        out["launches"][arch] = want

    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), num_layers=REV_UNITS,
                              reversible_residual=True)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(28), cfg, device=dev)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(29),
                    device=dev)
    ops.reset_launch_counts()
    z_rev, g_rev = _rev_grads(cfg, params, x)
    torch.cuda.synchronize()
    rev_launches = ops.launch_counts()["flash_attention"]
    z_ref, g_ref = _rev_grads(dataclasses.replace(cfg, reversible_residual=False), params, x)
    d_z = (z_rev - z_ref).abs().max().item() / z_ref.abs().max().item()
    rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(g_rev, g_ref))
    check(all(torch.isfinite(g).all().item() for g in g_rev) and d_z <= REV_GRAD_RTOL
          and rel <= REV_GRAD_RTOL, f"reversible stack: value {d_z}, gradients {rel} of their "
          f"largest from the two-track recursion (limit {REV_GRAD_RTOL})")
    print(f"[{label}] reversible tinyllama smoke stack ({REV_UNITS} units, f32, B 2 x 64) on "
          f"the card: value within {d_z:.3g} and every gradient within {rel:.3g} of its "
          f"largest of the two-track recursion (limit {REV_GRAD_RTOL}); flash_attention "
          f"{rev_launches} launches a gradient (forward {REV_UNITS + 1}, the backward's "
          f"reconstructions and local forwards)", flush=True)
    out.update(rev_rel=rel, rev_launches=rev_launches)
    del params, g_rev, g_ref

    peaks = {}
    for units in REV_MEMORY["units"]:
        base_cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=units,
                                       dtype=torch.float32)
        params = T.init_lm(torch.Generator(device=dev).manual_seed(30), base_cfg, device=dev)
        batch = token_batches(_data_key(dev), 0, REV_MEMORY["batch"], REV_MEMORY["seq"],
                              base_cfg.vocab)
        weights = _tree_bytes(params)
        for tag, kw in (("reversible", dict(reversible_residual=True, remat=False)),
                        ("remat", dict(remat=True)), ("neither", dict(remat=False))):
            c = dataclasses.replace(base_cfg, **kw)
            leaves, spec = tree.flatten(params)
            leaves = [a.detach().requires_grad_() for a in leaves]
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, _ = T.lm_loss(tree.unflatten(spec, leaves), c, batch)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            peaks[f"{tag} {units} layers"] = dict(peak_gb=peak / 1e9,
                                                  beyond_grads_gb=(peak - weights) / 1e9)
            check(math.isfinite(loss.item()), f"{tag} {units} layers: loss {loss.item()}")
            del loss, grads, leaves
        print(f"[{label}] one gradient of tinyllama at full width, f32, B "
              f"{REV_MEMORY['batch']} x {REV_MEMORY['seq']}, {units} layers (weights "
              f"{weights / 1e9:.3f} GB, their gradients as many): peak above the weights "
              f"{ {k: round(v['peak_gb'], 3) for k, v in peaks.items() if str(units) in k} } "
              f"GB, of which beyond the gradients "
              f"{ {k: round(v['beyond_grads_gb'], 3) for k, v in peaks.items() if str(units) in k} }",
              flush=True)
        del params
        torch.cuda.empty_cache()
    out["peaks"] = peaks
    return out


# The kernels whose registers, shared memory and spills the run reports.
# The D = 96 attention instantiations (phase 12b), held free of spills and
# of serialised wgmma.
ATTN_D96_KERNELS = ("19flash_attention_f32ILi96E", "21flash_attention_wgmmaILi96E")
PTXAS_SOURCES = ("rev_heun", "flash_attention", "ssd_chunk", "fused_mlp")
# the row-windowed draws' device functions (phase 11e), dependent launches too
WINDOW_KERNELS = ("brownian_increment_window_kernel", "phase1_gen_window_kernel",
                  "space_time_increment_window_kernel")
PTXAS_KERNELS = ("brownian_value_kernel", "flash_attention_f32", "flash_attention_wgmma",
                 "ssd_chunk_kernel",
                 "fused_mlp_bwd_kernel", "fused_mlp_fixed", "space_time_value_kernel",
                 *DEPENDENT_KERNELS.values(), *WINDOW_KERNELS)


def start_ptxas_report():
    """Compile PTXAS_SOURCES once more with ``-Xptxas -v`` (the library's
    flags), in background processes; :func:`ptxas_report` reads them."""
    from repro_torch.kernels import build

    tmp = tempfile.mkdtemp(prefix="ptxas_")
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                               str(build.CSRC), "-c", "-o", os.path.join(tmp, f"{name}.o"),
                               str(build.CSRC / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in PTXAS_SOURCES]
    # a phase that fails leaves none of them running
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return tmp, procs


def ptxas_report(started) -> dict:
    """``{mangled kernel: [ptxas lines]}`` for PTXAS_KERNELS: the stack,
    spill and register / shared-memory lines ptxas prints for each."""
    tmp, procs = started
    usage, func = {}, None
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{err}")
        for line in err.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "C7512" in line:  # wgmma serialised: names its function
                named = line.split("'")[1] if line.count("'") >= 2 else func
                usage.setdefault(named, []).append(line.split(":", 1)[-1].strip())
            elif func and any(k in func for k in PTXAS_KERNELS) and (
                    "spill" in line or "Used" in line):
                usage.setdefault(func, []).append(line.split(":", 1)[-1].strip())
    shutil.rmtree(tmp, ignore_errors=True)
    for func, lines in usage.items():
        print(f"ptxas {func[:80]}: {'; '.join(lines)}", flush=True)
    return usage


def check_no_spills(usage: dict, funcs) -> None:
    """Every instantiation of each device function in ``funcs`` (a name, or
    a mangled piece such as ``19flash_attention_f32ILi96E``) compiled, and
    ptxas reports no spill stores or loads for it and no serialised wgmma
    (C7512), or raise."""
    for func in funcs:
        piece = func if func[0].isdigit() else _mangled(func)
        lines = [line for k, v in usage.items() if piece in k for line in v]
        check(any("spill" in line for line in lines), f"ptxas reported nothing for {func}")
        check(all("0 bytes spill stores, 0 bytes spill loads" in line
                  for line in lines if "spill" in line)
              and not any("C7512" in line for line in lines), f"ptxas: {func} spills or "
              f"serialises its wgmma: {lines}")
    print(f"ptxas: no spills in {', '.join(funcs)}", flush=True)


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def profile_decode(sampler, params, keys, label: str) -> None:
    profile_call(lambda: sampler(params, keys), f"{label}] [decode B={keys.shape[0]}")


def profile_call(fn, label: str) -> dict:
    """Where one call's time goes: wall time (unprofiled, host clock around a
    synchronised call, median of 3) against the card's busy time (the summed
    time of the device-side events — kernels, copies — under torch.profiler);
    the rest is idle.  Only device activity is recorded: the host ops that
    launched the kernels would carry the same time (and count it twice),
    and sorting a host-op trace of an SDE step (~10^5 events) costs seconds
    a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not events:
        print(f"[{label}: wall {wall_ms:.3f} ms; device busy time not measured (the "
              f"profiler recorded no device events)", flush=True)
        return dict(wall_ms=wall_ms, busy_ms=None, by_name={}, kernels=None, idle=None,
                    counts={})
    top = sorted(events, key=_device_us, reverse=True)[:6]
    kernels = sum(e.count for e in events)
    idle = round(1 - busy_ms / wall_ms, 3)
    print(f"[{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({kernels} device kernels and copies), idle share {idle:.3f}", flush=True)
    for e in top:
        print(f"    {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=kernels, idle=idle,
                by_name={e.key: _device_us(e) / 1e3 for e in events},
                counts={e.key: e.count for e in events})


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


PHASE_S: dict = {}


# ---------------------------------------------------------------------------
# Phase 22: data parallelism on torch.distributed
# ---------------------------------------------------------------------------

DP_BATCH = 1024          # the global batch; 512 rows a rank
DP_RANKS = 2             # gloo ranks sharing the one card
DP_STEPS = 3             # clip steps and ELBO steps each
DP_SRK_BATCH = 64        # one srk discretise ELBO step (row 12's windows)
DP_REL = 2e-4            # the CPU tests' float32 bound (tests/test_torch_distributed.py)
DP_WINDOW_KERNELS = ("brownian_increment", "rev_heun_phase1_gen", "space_time_increment")
# (rows, d, ranks) of the windowed draws checked against the plain versions
# and the whole launch: the ELBO's one key over (B, 17), the SDE-GAN's over
# (B, noise 4), the srk ELBO's, three ranks, and odd sizes (a window that
# splits a counter pair)
DP_WINDOW_SHAPES = [(1024, 17, 2), (1024, 17, 3), (1024, 4, 2), (64, 17, 2), (7, 3, 2),
                    (5, 1, 3)]
DP_SCHED = dict(max_batch=64, requests=32, request_max=8, chunks=4)


def _dp_window_calls(ops, key, rows: int, d: int, dtype, g, dev):
    """name -> call(window, rows_slice, use_kernel) of the three one-key draws."""
    dt = 1.0 / 23
    st = [torch.randn(rows, d, generator=g, dtype=dtype).to(dev) for _ in range(4)]

    def gen(window, sl, uk):
        z, zh, mu, sg = (t[sl] for t in st)
        return ops.rev_heun_phase1_gen(z, zh, mu, sg, key, 5, dt, dt, -1.0, use_kernel=uk,
                                       window=window)

    return {
        "brownian_increment": lambda window, sl, uk: (ops.brownian_increment(
            key, 5, (sl.stop - sl.start, d), dtype, dt, use_kernel=uk, window=window),),
        "rev_heun_phase1_gen": gen,
        "space_time_increment": lambda window, sl, uk: ops.space_time_increment(
            key, 5, (sl.stop - sl.start, d), dtype, dt, use_kernel=uk, window=window),
    }


def _window_pairs(e0: int, count: int, size: int) -> int:
    """The float32 counter pairs elements [e0, e0 + count) of a size-``size``
    draw touch (lane 0 of pair j is element j, lane 1 element j + half)."""
    half = (size + 1) // 2
    lo = (e0, min(e0 + count, half))
    hi = (max(e0, half) - half, e0 + count - half)
    a, b = max(lo[1] - lo[0], 0), max(hi[1] - hi[0], 0)
    overlap = max(0, min(lo[1], hi[1]) - max(lo[0], hi[0])) if a and b else 0
    return a + b - overlap


def window_bound(name: str, e0: int, count: int, size: int, dtype) -> tuple:
    """Least time for a windowed one-key draw of ``count`` elements: one
    fold_in (and for space_time_increment the split's two hashes), one hash
    per counter pair the window touches (float32; a float64 element is its
    own), a normal and a scaling an element (two draws for (W, H)); bytes:
    the key in, the outputs out (rev_heun_phase1_gen: four state tensors
    in, two out, and its six flops an element)."""
    s = torch.finfo(dtype).bits // 8
    pairs = _window_pairs(e0, count, size) if dtype == torch.float32 else count
    draws = 2 if name == "space_time_increment" else 1
    ops_ = ((3 if draws == 2 else 1) * HASH_OPS
            + draws * (pairs * HASH_OPS + count * (NORMAL_OPS[dtype] + 1)))
    nbytes = 16 + draws * count * s
    if name == "rev_heun_phase1_gen":
        ops_ += 6 * count
        nbytes = 16 + 6 * count * s
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dp_window_checks(ops, dev) -> tuple:
    """Phase 22c: the windowed draws of rows 5, 7 and 12 against their plain
    versions (same window) and their windows, concatenated, against the
    whole launch, bitwise, in float32 and float64; timed at the ELBO's one
    key over (1024, 17) float32 (rank 0's half) beside the whole launch.
    Returns ``({name: timing row}, {name: max |Δ|})``."""
    from repro_torch.kernels import prng

    g = torch.Generator().manual_seed(2201)
    errs = {name: 0.0 for name in DP_WINDOW_KERNELS}
    for dtype in (torch.float32, torch.float64):
        for rows, d, ranks in DP_WINDOW_SHAPES:
            key = prng.PRNGKey(rows * 131 + d, device=dev)
            calls = _dp_window_calls(ops, key, rows, d, dtype, g, dev)
            bounds = [rows * r // ranks for r in range(ranks + 1)]
            for name, call in calls.items():
                whole = call(None, slice(0, rows), True)
                parts = []
                for r0, r1 in zip(bounds[:-1], bounds[1:]):
                    window = (r0 * d, rows * d)
                    got = call(window, slice(r0, r1), True)
                    want = call(window, slice(r0, r1), False)
                    torch.cuda.synchronize()
                    err = max((a - b).abs().max().item() for a, b in zip(got, want))
                    check(all(torch.equal(a, b) for a, b in zip(got, want)) and err == 0.0,
                          f"{name} {dtype} ({rows}, {d}) window {window}: kernel != plain "
                          f"(max |Δ| {err})")
                    errs[name] = max(errs[name], err)
                    parts.append(got)
                for i, w in enumerate(whole):
                    check(torch.equal(torch.cat([p[i] for p in parts]), w),
                          f"{name} {dtype} ({rows}, {d}) over {ranks} ranks: the windows "
                          f"!= the whole launch")
    print(f"windowed draws: {', '.join(DP_WINDOW_KERNELS)} x {{float32, float64}} x "
          f"(rows, d, ranks) in {DP_WINDOW_SHAPES}: kernel == plain per window, windows "
          f"concatenated == the whole launch, bitwise", flush=True)

    rows_t = {}
    B, d = 1024, 17
    key = prng.PRNGKey(7, device=dev)
    calls = _dp_window_calls(ops, key, B, d, torch.float32, g, dev)
    print("windowed kernel        rows   kernel_ms (host)     plain_ms (host)      "
          "whole_ms (host)      bound_ms (by)", flush=True)
    for name, call in calls.items():
        window, sl = (0, B * d), slice(0, B // DP_RANKS)
        k_ms, k_host = time_ms(lambda: call(window, sl, True))
        p_ms, p_host = time_ms(lambda: call(window, sl, False))
        w_ms, w_host = time_ms(lambda: call(None, slice(0, B), True))
        b_ms, b_by = window_bound(name, 0, (B // DP_RANKS) * d, B * d, torch.float32)
        print(f"{name:22s} {B // DP_RANKS:<4d}/{B}  {k_ms:.5f} ({k_host:.5f})  "
              f"{p_ms:.5f} ({p_host:.5f})  {w_ms:.5f} ({w_host:.5f})  {b_ms:.6f} ({b_by})",
              flush=True)
        rows_t[name] = dict(ms=k_ms, plain_ms=p_ms, host_ms=k_host, plain_host_ms=p_host,
                            whole_ms=w_ms, whole_host_ms=w_host, bound_ms=b_ms,
                            bound_by=b_by, shape=[B // DP_RANKS, d], of=[B, d],
                            dtype="float32")
    return rows_t, errs


def dp_world1_checks(dev) -> dict:
    """Phase 22a: a process group of world size 1 over NCCL on the card: the
    path's collectives (the flat gradient mean, the row gather, the
    broadcast) are each a bitwise identity, and ``data_parallel_mesh`` is
    None, as the reference's on one device."""
    import torch.distributed as dist

    from repro_torch.distributed import compat, sharding

    g = torch.Generator().manual_seed(2202)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            check(sharding.data_parallel_mesh(DP_BATCH) is None,
                  "data_parallel_mesh on one rank is not None")
            mesh = compat.make_mesh((1,), ("data",))
            with compat.set_mesh(mesh):
                grads = [torch.randn(s, generator=g).to(dev) for s in ((33, 32), (32,), ())]
                grads.append(torch.randn(5, generator=g, dtype=torch.float64).to(dev))
                means = sharding.allreduce_mean(grads)
                rows = torch.randn(24, 64, 17, generator=g).to(dev)
                keys = torch.randint(0, 2 ** 32, (64, 2), generator=g).to(dev)
                gathered = sharding.gather_rows(rows, 1)
                sent = sharding.broadcast(keys.clone())
                torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(means, grads))
                    and torch.equal(gathered, rows) and torch.equal(sent, keys))
            check(same, "a world-size-1 collective is not the identity")
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    print(f"world size 1 over {backend}: allreduce_mean, gather_rows and broadcast are "
          f"bitwise identities; data_parallel_mesh({DP_BATCH}) is None", flush=True)
    return {"backend": backend, "identities": True}


def _dp_train(dev) -> dict:
    """DP_STEPS SDE-GAN clip steps and DP_STEPS fused ELBO steps at the
    global batch DP_BATCH, and one srk discretise ELBO step at DP_SRK_BATCH,
    float32 at the training widths, under the data-parallel mesh when the
    process group has ranks -> metrics and parameters after each step, the
    walls, and the launches of the whole run (the counts zeroed just before
    it)."""
    from repro_torch.distributed import compat, sharding
    from repro_torch.kernels import brownian as bk
    from repro_torch.kernels import ops, prng
    from repro_torch.launch.steps import make_gan_optimizers, make_sde_gan_step

    def mesh_ctx(batch):
        mesh = sharding.data_parallel_mesh(batch)
        return compat.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()

    def cpu(x):
        from repro_torch import tree
        return tree.map(lambda t: t.detach().cpu().clone(), x)

    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init
    from repro_torch.launch.steps import make_latent_sde_optimizer, make_latent_sde_step

    cfg, params, _, _ = _gan_problem(dev, DP_BATCH)
    (gi, gu), (di, du) = make_gan_optimizers(1.0, "clip")
    gan = make_sde_gan_step(cfg, gu, du, DP_BATCH, GAN_SEQ, device=dev)
    gan_state = (params, gi(params["gen"]), di(params["disc"]))
    lcfg = LatentSDEConfig(**WIDTHS, kl_weight=0.1, use_pallas_kernels=True)
    lparams = latent_sde_init(torch.Generator().manual_seed(13), lcfg, device=dev)
    init, update = make_latent_sde_optimizer()
    elbo = make_latent_sde_step(lcfg, update, DP_BATCH, SEQ_LEN, device=dev)
    elbo_state = (lparams, init(lparams))
    srk = _train_step(dev, DP_SRK_BATCH, fused=False, solver="srk")
    out = {"clip": [], "elbo": [], "walls_ms": {"clip": [], "elbo": []}}
    ops.reset_launch_counts()
    for k in bk.WINDOW_LAUNCHES:
        bk.WINDOW_LAUNCHES[k] = 0
    key = prng.PRNGKey(GAN_SEED + 1, device=dev)
    with mesh_ctx(DP_BATCH):
        for s in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *gan_state, metrics = gan(*gan_state, prng.fold_in_key(key, s))
            torch.cuda.synchronize()
            out["walls_ms"]["clip"].append((time.perf_counter() - t0) * 1e3)
            out["clip"].append((cpu(metrics), cpu(gan_state[0])))
        for s in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *elbo_state, metrics = elbo(*elbo_state, prng.fold_in_key(key, 100 + s))
            torch.cuda.synchronize()
            out["walls_ms"]["elbo"].append((time.perf_counter() - t0) * 1e3)
            out["elbo"].append((cpu(metrics), cpu(elbo_state[0])))
    with mesh_ctx(DP_SRK_BATCH):
        _, _, metrics = srk()
        out["srk"] = cpu(metrics)
    torch.cuda.synchronize()
    out["launches"] = dict(ops.launch_counts())
    out["window_launches"] = dict(bk.WINDOW_LAUNCHES)
    return out


def _dp_sched(dev, shard_base: int) -> dict:
    """Phase 22d's drain: DP_SCHED's requests (every fourth a terminal one)
    through ``Scheduler(shard_base=...)`` with CUDA-graph pools -> rank 0's
    samples and converged flags by request id (None on a follower)."""
    from repro_torch.distributed import compat
    from repro_torch.serving import LoadedModel, ModelRegistry, Scheduler
    from repro_torch.serving.types import synthetic_requests

    cfg, params = _sched_model(dev, 31)
    reg = ModelRegistry()
    reg.register(LoadedModel("default", "sde-gan", cfg, params))
    sched = Scheduler(reg, max_batch=DP_SCHED["max_batch"], chunks=DP_SCHED["chunks"],
                      collect=True, shard_base=shard_base, atol=1e-3, max_steps=512)
    sched.warm("default")
    if compat.rank() != 0:
        sched.follow()
        return None
    reqs = synthetic_requests(DP_SCHED["requests"], DP_SCHED["request_max"], 17)
    for i, r in enumerate(reqs):
        sched.submit(dataclasses.replace(r, kind="terminal") if i % 4 == 3 else r)
    results = sched.run()
    sched.close()
    return {r.rid: (r.samples.cpu(), torch.as_tensor(r.converged)) for r in results}


def _dp_rank() -> dict:
    """One gloo rank of phase 22b and 22d (spawned by compat.launch, sharing
    the card): the training run and the scheduler's drain.  The library was
    built by the parent; a rank only loads it."""
    from repro_torch.distributed import compat
    from repro_torch.kernels import build

    prebuilt = build.library_path().exists()
    build.load()
    dev = torch.device("cuda")
    out = {"prebuilt": prebuilt, "rank": compat.rank(), "note": compat.backend_note(dev)}
    out["train"] = _dp_train(dev)
    out["sched"] = _dp_sched(dev, DP_RANKS)
    return out


def _max_rel(got, want) -> float:
    """max |got − want| over the largest |want|, over matching leaves."""
    from repro_torch import tree

    worst = 0.0
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def dp_checks(ops, dev, label: str) -> dict:
    """Phase 22: data parallelism.  (a) world size 1 over NCCL: the
    collectives are identities; (b) DP_RANKS gloo ranks on the one card at
    the global batch DP_BATCH: DP_STEPS clip steps and DP_STEPS ELBO steps
    held to the one-rank card run within the CPU tests' float32 bound, the
    ranks' parameters bitwise equal, rows 5, 7 and 12 launched with windows;
    (c) the windowed kernels (dp_window_checks); (d) a DP_SCHED drain of
    ``Scheduler(shard_base=DP_RANKS)`` bitwise the one-rank drain.  Returns
    the windows' timings and errors and each rank's launches."""
    from repro_torch import tree
    from repro_torch.distributed import compat

    world1 = dp_world1_checks(dev)
    windows, window_errs = dp_window_checks(ops, dev)
    t0 = time.perf_counter()
    one = _dp_train(dev)
    one_sched = _dp_sched(dev, 1)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = compat.launch(_dp_rank, DP_RANKS, device="cuda", timeout=600)
    t_ranks = time.perf_counter() - t0
    print(f"{DP_RANKS} ranks ({ranks[0]['note']}): {t_ranks:.1f} s with the spawn, one rank "
          f"in this process {t_one:.1f} s", flush=True)
    for r in ranks:
        check(r["prebuilt"], f"rank {r['rank']} found no built library (it would rebuild)")
    worst = {}
    for kind in ("clip", "elbo"):
        for s in range(DP_STEPS):
            m1, p1 = one[kind][s]
            (ma, pa), (mb, pb) = (r["train"][kind][s] for r in ranks)
            check(all(torch.equal(a, b) for a, b in zip(tree.leaves(pa), tree.leaves(pb))),
                  f"{kind} step {s}: the ranks' parameters differ")
            rel = max(_max_rel(pa, p1), _max_rel([ma[k] for k in m1], [m1[k] for k in m1]))
            worst[kind] = max(worst.get(kind, 0.0), rel)
            check(rel <= DP_REL, f"{kind} step {s}: {DP_RANKS} ranks vs one, rel {rel:.3g} "
                                 f"> {DP_REL}")
    srk = ranks[0]["train"]["srk"]
    worst["srk"] = _max_rel([srk[k] for k in one["srk"]], [one["srk"][k] for k in one["srk"]])
    check(worst["srk"] <= DP_REL, f"srk step: {DP_RANKS} ranks vs one, rel {worst['srk']:.3g}")
    for r in ranks:
        for name in DP_WINDOW_KERNELS:
            check(r["train"]["window_launches"][name] > 0,
                  f"rank {r['rank']}: {name} never launched with a window")
    check(all(v == 0 for v in one["window_launches"].values()),
          f"the one-rank run launched windows: {one['window_launches']}")
    print(f"{DP_RANKS} ranks vs one, B {DP_BATCH}, float32: max rel {worst} (limit "
          f"{DP_REL}); the ranks' parameters bitwise equal after every step [card: {label}]",
          flush=True)
    for kind in ("clip", "elbo"):
        print(f"{kind} wall per step, ms: one rank {[round(x, 1) for x in one['walls_ms'][kind]]}"
              + "".join(f"; rank {r['rank']} "
                        f"{[round(x, 1) for x in r['train']['walls_ms'][kind]]}"
                        for r in ranks) + f" [card: {label}]", flush=True)
    sched = ranks[0]["sched"]
    check(ranks[1]["sched"] is None and sorted(sched) == sorted(one_sched)
          and len(sched) == DP_SCHED["requests"], "the sharded drain served other requests")
    for rid, (samples, conv) in one_sched.items():
        check(torch.equal(sched[rid][0], samples) and torch.equal(sched[rid][1], conv),
              f"request {rid}: the {DP_RANKS}-rank drain != the one-rank drain")
    print(f"Scheduler(shard_base={DP_RANKS}) drain of {DP_SCHED['requests']} requests: "
          f"bitwise the one-rank drain", flush=True)
    dp_launches = {name: [r["train"]["launches"].get(name, 0) for r in ranks]
                   for name in KERNEL_SOURCES}
    window_launches = {name: [r["train"]["window_launches"][name] for r in ranks]
                       for name in DP_WINDOW_KERNELS}
    print(f"launches per rank (the whole run): {dp_launches}; of them windowed: "
          f"{window_launches}", flush=True)
    return {"world1": world1, "windows": windows, "window_errs": window_errs,
            "dp_launches": dp_launches, "window_launches": window_launches,
            "walls_ms": {"one": one["walls_ms"],
                         "ranks": [r["train"]["walls_ms"] for r in ranks]},
            "max_rel": worst, "one_rank_launches": one["launches"]}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall kept in PHASE_S and printed as a ``[phase]`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"[phase] {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs the GPU",
              file=sys.stderr)
        return 2
    label = gpu_label()
    print(f"card: {label}", flush=True)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f}s", flush=True)
    ptxas = start_ptxas_report()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    xent_rows, xent_errs = timed("fused_xent", xent_checks, ops, dev)
    rows, errs = timed("solver kernels", kernel_checks, ops, dev)
    pdl = timed("dependent launch graph", pdl_graph_checks, ops, dev)
    floor = timed("launch floor", launch_floor)
    errs.update(xent_errs)
    mlp_rows, mlp_errs = timed("fused_mlp", mlp_checks, ops, dev)
    errs["fused_mlp"] = max(mlp_errs.values())
    mlp_bwd_rows, mlp_bwd_errs = timed("fused_mlp_bwd", mlp_bwd_checks, ops, dev,
                                       floor["launch_floor_ms"])
    errs["fused_mlp_bwd"] = max(mlp_bwd_errs.values())
    host_costs = timed("launcher costs", launcher_costs, dev)
    value_rows, errs["brownian_value"] = timed("brownian_value", value_checks, ops, dev)
    timed("identities", identity_checks, ops, dev)
    timed("adjoint", adjoint_checks, dev)
    train_launches = timed("elbo train", train_checks, ops, dev, label)
    timed("memory", memory_checks, dev, label)
    serve = timed("serve", serve_checks, ops, dev, label)
    sched_serve = timed("sched serve", sched_serve_checks, ops, dev, label)
    adaptive_serve = timed("adaptive serve", serve_adaptive_checks, ops, dev, label)
    adaptive_launches = timed("adaptive grad", adaptive_grad_checks, ops, dev, label)
    gan = timed("sde-gan", gan_checks, ops, dev, label)
    baselines = timed("baselines", baseline_checks, ops, dev, label)
    dp = timed("data parallel", dp_checks, ops, dev, label)
    levy = timed("levy", levy_checks, ops, dev, label)
    errs.update(levy["errs"])
    attn_rows, errs["flash_attention"], attn_rel = timed("flash_attention",
                                                          attention_checks, ops, dev)
    zoo_rows, zoo_err, zoo_rel = timed("flash_attention zoo", attention_zoo_checks, ops, dev)
    errs["flash_attention"] = max(errs["flash_attention"], zoo_err)
    attn_rel = max(attn_rel, zoo_rel)
    timed(f"lm parity {LM_ARCH}", lm_parity_checks, dev, label, LM_ARCH)
    lm_serve = timed(f"lm serve {LM_ARCH}", lm_serve_checks, ops, dev, label, LM_ARCH)
    ssd_row, errs["ssd_chunk"] = timed("ssd_chunk", ssd_checks, ops, dev)
    timed(f"lm parity {SSM_ARCH}", lm_parity_checks, dev, label, SSM_ARCH)
    ssm_serve = timed(f"lm serve {SSM_ARCH}", lm_serve_checks, ops, dev, label, SSM_ARCH)
    timed("lm grad", lm_grad_checks, ops, dev, label)
    timed("lm train parity", lm_train_parity_checks, ops, dev, label)
    train_lm_launches = timed("lm train", lm_train_checks, ops, dev, label)
    timed("ssm train", ssm_train_checks, ops, dev, label)
    moe_parity = timed("moe parity", moe_parity_checks, ops, dev, label)
    moe_serve = timed("moe serve", moe_serve_checks, ops, dev, label)
    moe_train = timed("moe train", moe_train_checks, ops, dev, label)
    zoo_parity = timed("zoo parity", zoo_parity_checks, ops, dev, label)
    zoo_serve = timed("zoo serve", zoo_serve_checks, ops, dev, label)
    zoo_train = timed("zoo train", zoo_train_checks, ops, dev, label)
    ptxas_usage = ptxas_report(ptxas)
    check_no_spills(ptxas_usage, (*DEPENDENT_KERNELS.values(), *WINDOW_KERNELS,
                                  *ATTN_D96_KERNELS))

    print(f"kernels: {', '.join(KERNEL_SOURCES)} (route cuda; bitwise = plain except "
          f"flash_attention, within {ATTN_TOL}, ssd_chunk, within {SSD_TOL} and the "
          f"state within {SSD_STATE_RTOL} of its largest, fused_mlp and fused_mlp_bwd, "
          f"within {MLP_TOL}, and "
          f"fused_xent, within {XENT_TOL} (its backward within 1e-5 / one bf16 ulp); "
          f"decodes: {serve['decodes']})", flush=True)
    entries = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        if name in ("fused_xent", "fused_xent_bwd"):  # timed at 8192 × 32000, f32
            r = xent_rows[name]["float32"]
            launches = train_lm_launches[name]  # per training step of phase 20
            serve_launches = 0
            extra = {"bf16": xent_rows[name]["bfloat16"], "launches_per": "training step"}
        elif name == "flash_attention":  # timed at the prefill shape, bf16 causal
            r = attn_rows["bf16 prefill"]
            launches = serve_launches = lm_serve["launches"]
            extra = {"f32_train": dict(attn_rows["f32 training"], shape=list(ATTN_TRAIN),
                                       launches_per_training_step=ATTN_TRAIN_LAUNCHES),
                     "bf16_train": dict(attn_rows["bf16 training"], shape=list(ATTN_TRAIN)),
                     "max_rel_err_bf16": attn_rel, "rel_limit_bf16": ATTN_REL_TOL,
                     "copies_saved_per_layer": lm_serve["copies_saved_per_layer"],
                     "ptxas_f32": {k: v for k, v in ptxas_usage.items() if "f32" in k},
                     **{f"bf16_{arch}_prefill": dict(attn_rows[f"bf16 {arch} prefill"],
                                                      shape=list(shape))
                        for arch, shape in ATTN_MOE_PREFILLS.items()},
                     # phase 12b: D = 96 and a key length of its own, both dtypes
                     "zoo_timed": zoo_rows,
                     "ptxas_d96": {k: v for k, v in ptxas_usage.items() if "ILi96E" in k},
                     # phases 26-28: per prefill (f32 2 layers; bf16 full depth)
                     # and per training step (smoke configs)
                     "zoo_prefill_launches": {
                         **{f"{arch} f32 2 layers": v["launches"]
                            for arch, v in zoo_parity.items()},
                         **{f"{arch} bf16 full depth": v["launches"]
                            for arch, v in zoo_serve.items()}},
                     "zoo_train_launches_per_step": {
                         arch: v["flash_attention"] for arch, v in zoo_train["launches"].items()},
                     "reversible_gradient_launches": zoo_train["rev_launches"]}
        elif name == "ssd_chunk":  # timed at the mamba2 prefill shape, bf16
            r = ssd_row
            launches = serve_launches = ssm_serve["launches"]
            extra = {k: r[k] for k in ("cuda_core_bound_ms", "shape", "blocks",
                                       "ms_by_slices", "batch1", "jamba_prefill", "sass")}
            extra["ptxas"] = {k: v for k, v in ptxas_usage.items() if "ssd_chunk" in k}
        elif name == "fused_mlp":  # timed at the training batch (1024, 17 -> 32 -> 16)
            r = mlp_rows["train/serve B1024"]
            launches = train_launches[name]
            serve_launches = serve["launches"][name]
            extra = {"max_abs_err_by_dtype": {str(k)[6:]: v for k, v in mlp_errs.items()},
                     "layers_ms": r["layers_ms"], "layers_host_ms": r["layers_host_ms"],
                     "timed": {tag: {k: v for k, v in row.items() if k != "library_ms"}
                               for tag, row in mlp_rows.items()},
                     "launcher_host_us": host_costs,
                     "ptxas": {k: v for k, v in ptxas_usage.items()
                               if "fused_mlp_fixed" in k and "Li17ELi32ELi16E" in k},
                     "device_kernels_per_elbo_step": train_launches["device_kernels"],
                     "device_kernels_per_adaptive_gradient":
                         adaptive_launches["device_kernels"],
                     "gan_step": {"timing": gan["timing"], "peak_mib": gan["peak_mib"]},
                     "baselines": {k: baselines[k] for k in ("timing", "peak_mib",
                                                             "readings")}}
        elif name == "fused_mlp_bwd":  # timed at the training batch, as fused_mlp
            r = mlp_bwd_rows["train/serve B1024"]
            launches = train_launches[name]
            serve_launches = serve["launches"][name]
            extra = {"max_abs_err_by_dtype": {str(k)[6:]: v for k, v in mlp_bwd_errs.items()},
                     "plain_is": "the plain VJP (kernels/vjp.py:plain_vjp of ref.fused_mlp)",
                     "launch_floor_ms": floor["launch_floor_ms"],
                     "plan_by_rows": {tag: row["plan"] for tag, row in mlp_bwd_rows.items()},
                     "ptxas": {k: v for k, v in ptxas_usage.items() if "fused_mlp_bwd" in k},
                     "timed": {tag: {k: v for k, v in row.items() if k != "library_ms"}
                               for tag, row in mlp_bwd_rows.items()}}
        elif name == "brownian_value":  # timed at the adaptive gradient's shape
            r = value_rows["grad"]
            launches = adaptive_launches[name]
            serve_launches = adaptive_serve["launches"][name]
            extra = {"serve_ms": value_rows["serve"]["ms"],
                     "serve_plain_ms": value_rows["serve"]["plain_ms"],
                     "serve_bound_ms": value_rows["serve"]["bound_ms"],
                     "serve_chain_floor_ms": value_rows["serve"]["chain_floor_ms"],
                     "chain_floor_ms": r["chain_floor_ms"],
                     "chain_step_ms": r["chain_step_ms"],
                     "blocks": {tag: row["blocks"] for tag, row in value_rows.items()},
                     "ptxas": {k: v for k, v in ptxas_usage.items() if "brownian_value" in k}}
        elif name in ("space_time_increment", "space_time_value"):
            r = levy["timed"][name]  # the srk ELBO's draws / the adaptive srk queries
            if name == "space_time_increment":  # per srk ELBO step (discretise)
                launches = levy["launches"]["srk/discretise"][name]
            else:  # per adaptive srk gradient at bridge depth 10
                launches = levy["adaptive"][10]["launches"][name]
            serve_launches = 0
            extra = {k: r[k] for k in r if k not in ("ms", "plain_ms", "bound_ms",
                                                     "bound_by", "host_ms",
                                                     "plain_host_ms")}
            extra["ptxas"] = {k: v for k, v in ptxas_usage.items() if name + "_kernel" in k}
            if name in DEPENDENT_KERNELS:
                extra["dependent_launch_graph"] = pdl
            extra["launches_per"] = ("srk ELBO step (discretise)"
                                     if name == "space_time_increment"
                                     else "adaptive srk gradient, depth 10")
            extra["srk_order"] = {k: levy["order"][k] for k in ("slope", "sample_kernels",
                                                                 "sample_dispatched")}
            extra["srk_step_timing"] = levy["timing"]
            extra["table2_ms"] = levy["table2"]
        else:
            r = rows[(name, torch.float32, 1024, 17)]  # the training timing batch
            launches = train_launches[name]
            serve_launches = serve["launches"][name]
            extra = dict(floor)
            if name == "brownian_increment":  # the ELBO step draws in phase1_gen
                launches = gan["launches"][name]
                extra["launches_per"] = "SDE-GAN clip step (an ELBO step: 0)"
            if name in DEPENDENT_KERNELS:
                extra["dependent_launch_graph"] = pdl
                extra["ptxas"] = {k: v for k, v in ptxas_usage.items()
                                  if _mangled(DEPENDENT_KERNELS[name]) in k}
        if name in DP_WINDOW_KERNELS:  # the rank's windows of a one-key draw
            extra["window"] = dict(dp["windows"][name], launches_per_rank=dp[
                "window_launches"][name], launches_per="data-parallel run (phase 22b)")
            errs[name] = max(errs[name], dp["window_errs"][name])
        extra["dp_launches"] = {f"rank{i}": n for i, n in enumerate(dp["dp_launches"][name])}
        if name in LM_PATH_KERNELS:  # per prefill of each MoE / hybrid model run
            extra["moe_prefill_launches"] = {
                **{f"{arch} f32 {MOE_PARITY_LAYERS[arch]} layers": v["launches"][name]
                   for arch, v in moe_parity.items()},
                **{f"{arch} bf16 {MOE_SERVE_LAYERS[arch]} layers": v["launches"][name]
                   for arch, v in moe_serve.items()}}
        if name in (*LM_PATH_KERNELS, "fused_xent", "fused_xent_bwd"):
            extra["moe_train_launches_per_step"] = {arch: v["launches"][name]
                                                    for arch, v in moe_train.items()}
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": errs[name],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "host_ms": r["host_ms"], "plain_host_ms": r["plain_host_ms"],
                        "adaptive_launches": adaptive_launches.get(name, 0),
                        "gan_launches": gan["launches"].get(name, 0),
                        "baseline_launches": {tag: counts.get(name, 0) for tag, counts
                                              in baselines["launches"].items()},
                        "srk_launches": {tag: counts.get(name, 0) for tag, counts
                                         in levy["launches"].items()},
                        "serve_launches": serve_launches,
                        "sched_chunk_launches": sched_serve["chunk_launches"].get(name, 0),
                        "posterior_decode_launches":
                            sched_serve["posterior_decode"].get(name, 0), **extra})
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"card: {label}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
