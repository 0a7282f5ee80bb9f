"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels under
``src/repro_torch/csrc`` at first use.  Phases:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off for
   the plain versions;
2. build — every ``csrc/*.cu`` by its own ``nvcc``, in parallel; the
   register and spill report of ``ptxas``;
3. kernels against plain versions — every LB kernel × site function, VVL
   1, 2, 4 and 8, on the same inputs as the plain PyTorch version, at the
   tests' tolerances: the stencil site functions of both executors at
   128³, at a ragged 67 × 45 × 70 (every ``fused`` tile cut) and there with
   caller ghost planes in one, two and three dimensions (``LB_HALOS``; the
   last as a block decomposition reads them), the windowed ``fused``
   at the default ``plane_block`` and at 8; the pointwise ones at 128³
   and at 128³ + 37 sites;
   then the LM kernels at ``rtol=2e-4, atol=2e-4`` (the reference's own,
   ``tests/test_kernels.py``): ``flash_attention`` on the reference tests'
   shapes, the smoke shape (Dh 16), a ragged Sq = Sk = 1000, rows with no
   live key, the full-width gemma2 prefill shapes (``local`` and
   ``attn``), Sq and Sk that cut the query and key tiles at Dh 64 and 128,
   a query tile with no live key, the dense archs' full-width layers at Dh
   128 without softcap (gemma3's window 1024 and global GQA 32/16,
   qwen2-vl's 12/2, nemotron's 48/8, phi3's 40/10) and GQA group 6 over
   ragged tiles, granite-moe-1b-a400m's layer at Dh 64 (GQA 16/8, 2 ×
   4096), zamba2's shared block at Dh 80 and deepseek-v3's MLA at Dh 192
   over ragged tiles, with a window and softcap and with GQA, and (B, S,
   H, Dh) tensors seen as (B, H,
   S, Dh) (``ATTN_VIEW_CASES``); ``rmsnorm`` at VVL 1, 2, 4 and 8 at gemma2's and
   falcon-mamba-7b's prefill and decode shapes, a ragged (37, 64) and the
   dense archs' prefills (d 5376, 1536, 5120), granite's, zamba2's and
   deepseek-v3's prefill, decode and training step (d 1024, 2560, 7168),
   the
   ``gated``/``act`` site functions (all five kinds) at VVL 1, 2, 4 and 8
   at full width and on operands at a storage offset of one element (the
   unaligned path, a ragged extent), and qwen2-vl's SwiGLU and nemotron's
   squared ReLU at their prefills' sizes and granite's SwiGLU over its
   prefill's packed expert rows (81 920, 512), zamba2's GeGLU (8192,
   10 240) and deepseek-v3's SwiGLU (8192, 18 432) and (81 920, 2048)
   (``DENSE_EW_CHECKS``); the ``mamba`` site function
   (``ops.mamba_scan``, every batch row in one launch) at VVL 1, 2, 4 and 8
   on the reference tests' shapes, a ragged 1000 channels, falcon-mamba-7b's
   full-width prefill shape (2, 4096, 8192, 16) and shapes that cut the
   chunks and channel blocks at batch 1 and 3; the calibration kernels (``calibrate.add``
   exactly, ``calibrate.fma`` at ``FMA_RTOL``) on the reference's (16384,)
   shape at k = 8, on a misaligned view and at the calibration sizes;
4. main path — ``BinaryFluidSim`` 20 steps at 128³ in the unfused,
   ``one_launch`` and ``two_launch`` regimes from one spinodal state, then
   ``ops.lb_collision`` and ``ops.lb_fused_step`` (windowed and gathered)
   on its result; then gemma2-2b served at full width (seeded random
   weights, 2 prompts × 4608 tokens, 16 greedy decode steps) through
   ``build_serve_steps`` on the kernels, and an ungated ``ops.gated_act``;
   then falcon-mamba-7b served at full width (64 Mamba-1 layers, seeded
   random weights, 29.1 GB, 2 prompts × 4096 tokens, 16 greedy decode
   steps) the same way; the tuning path at full size: ``calibrate()`` on the
   card, ``predict`` for every stage of the three LB regimes, ``autotune``
   of the 128³ fused program (then again from its cache, with no
   measurement), 20 ``one_launch`` steps under the tuned target against the
   default target's, and ``autotune`` of rmsnorm at gemma2's prefill shape;
   the tdp surface (``tdp_surface``) at Ludwig's 128³: the paper's §III-C
   sequence through ``repro_torch.tdp`` (``target_malloc``,
   ``copy_to_target``, ``copy_constant_to_target``, the ``scale``,
   ``saxpy`` and ``site_pos`` site functions of kernel 2 at VVL 1, 2, 4
   and 8 on a (3, 128³) field, each against its plain body: bit-exact,
   ``saxpy`` at ``rtol=1e-6``; ``sync_target``, ``copy_from_target``),
   ``reduce`` sum / max / min on the card, one launch each of the one-pass
   map-and-reduce kernel (max and min exact, the sum within 1e-5·Σ|x| of
   numpy's float64 sum), ``launch_stencil`` of
   ``stream`` and ``grad6`` on the card, the masked copies of the
   19-component f over the grid's six faces (4.6 % of the sites) against a
   full copy, ``target_free`` (``memory_allocated`` drops by the field's
   bytes; a later copy raises), the paper's Fig. 1 (``collide_aos`` /
   ``stream_aos``, plain PyTorch on AoS (128, 128, 128, 19), against the
   SoA kernel-2 ``collide`` / ``stream`` and the plain SoA body; times
   printed as ``{"fig1_128cubed_ms": ...}``) and
   ``repro_torch.examples.lb_spinodal`` at 128³, 200 steps in chunks of
   50, unfused and in both fused regimes (mass drift ≤ 1e-5, φ variance
   grows, φ total conserved and the regimes' φ totals within 1e-5·Σ|φ| and
   φ variances within 1e-3 relative), printed as ``{"tdp_surface": ...}``;
   each path with every launch counter set to 0 just before it and read
   just after.  Checks NaN-free states, float64 mass conservation, pairwise
   agreement of the regimes, a 16³ trajectory against the plain path on
   the CPU, a launch of every kernel × site function, the serving path's
   launch counts per prefill and per decode step, and the served logits
   and greedy tokens against the same weights and prompts through the
   plain path (``backend="torch"``) on the card, for both models;
5. times — each LB kernel × site function at 128³ (the windowed ``fused``
   at each ``PLANE_BLOCKS`` value too; beside each, its per-launch time
   before the redesign, ``EARLIER_MS``) and each LM kernel at its
   full-width shapes (``flash_attention`` and ``mamba`` beside their times
   before their redesign, ``EARLIER_LM_MS``, kept in the record, not in the
   kernels line), held once more to its plain version, then timed
   (median of 20 launches, CUDA events) beside its plain version, its
   bound and, where one PyTorch call computes the same function
   (``library_call``, ``lm_library_call``), that call, itself held to the
   plain version first (the ``mamba`` site function's plain version, a
   host-bound Python loop over 4096 steps, is timed by wall clock over
   ``MAMBA_PLAIN_REPS`` calls); ``rmsnorm`` also at the decode shapes
   (2304, 2), (4096, 2) and falcon-mamba-7b's prefill (4096, 8192); the
   ``rmsnorm``, ``gated``, ``act`` and ``mamba`` kernels also at VVL 2, 4
   and 8 (``ms_by_vvl``); the dense archs' shapes (``dense_rows``:
   ``DENSE_RMS_ROWS``, ``DENSE_EW_ROWS``, ``DENSE_ATTN_ROWS``, kernel 4
   beside ``scaled_dot_product_attention`` with ``is_causal`` or, for
   gemma3's window, a boolean band mask) and granite's (``MOE_*_ROWS``:
   rmsnorm at (1024, 8192) beside ``F.rms_norm``, SwiGLU over the packed
   expert rows (81 920, 512), kernel 4 at (2, 16 / 8, 4096, Dh 64) beside
   SDPA) and zamba2's (``SSD_*_ROWS``: rmsnorm at (2560, 8192), GeGLU at
   (8192, 10 240), kernel 4 at (2, 32 / 32, 4096, Dh 80) beside SDPA and
   beside the route that would pad q, k, v to Dh 128, timed for the
   record) and deepseek-v3's (``mla_rows``: rmsnorm at (7168, 8192),
   SwiGLU over the dense FFN (8192, 18 432) and the packed expert rows
   (81 920, 2048), kernel 4 at (2, 128 / 128, 4096, Dh 192) on V padded
   from 128, held to the chunked plain version and beside SDPA in float32
   on the same padded inputs, the V pad and the output slice timed, and
   kernel 4 raising ``ValueError`` at Dh 96);
   MLUPS per regime; prefill ms, decode ms per step and
   tokens/s of both serving paths, on the kernels and on the plain path;
   the calibration kernels at the calibration sizes beside ``torch.add``;
   the example site functions at (3, 128³), each held to its plain body
   bit for bit at every VVL and on operands at a storage offset of one
   float (the scalar path), beside ``torch.mul`` / ``torch.add(y, x,
   alpha=a)`` (at every VVL too), and the one-pass ``reduce`` (sum, max,
   min; the sum at every VVL) beside ``x.sum(-1)`` / ``amax`` / ``amin``
   and beside the map plus ``torch.sum`` it replaces; their times before
   the redesign (``EARLIER_EXAMPLE_MS``) go to the record and the log, not
   to the kernels line;
6. the AoSoA layout (``Target(layout="aosoa")``, ``aosoa_phase``): every
   LB site function of both executors at 128³ and the example sites at (3,
   128³) at AoSoA widths 8, 32 and 128, ``rmsnorm`` at both prefill shapes
   (W 32), ``gated``/``act`` at 84.9 M elements (W 96) and one
   falcon-mamba-7b layer's ``mamba`` (W 16), each held to the SoA launch of
   its executor (its difference printed where it is not bit-equal) and to
   its plain version (the transforms plus the plain body); its main path,
   each path with the counters at 0: ``BinaryFluidSim`` at 128³, 20 steps,
   the three regimes at W 32 on their own executors, held to the SoA runs
   (``rtol=2e-4, atol=2e-5``, Σf and Σg to 1e-5 of Σ|f| and Σ|g|), MLUPS
   beside SoA's, ``ops.lb_fused_step``, ``stencil.gradients``,
   ``tdp.launch`` of the examples, ``ops.rmsnorm``/``gated_act``/
   ``mamba_scan``; the example sites also on AoSoA operands at a storage
   offset of one float (one lane a thread: the same bits) and timed at
   every width; a row per AoSoA kernel: ms on operands already in AoSoA,
   ms with the boundary transforms, the plain version, the bound, the SoA
   row's ms and library call; the phase's seconds.  Then the same LM
   kernels in bfloat16 (``aosoa_bf16``): rmsnorm (W 32), GeGLU and GELU
   (W 96) and the scan (W 16, and W 12 where a bfloat16 block's 4 channels
   are 8 bytes) each held to the bits of its bfloat16 SoA twin and within
   one bfloat16 step of its plain version against a control that must
   fail that bar, driven through ``ops`` under AoSoA (its paths counted)
   and timed beside its SoA twin, plain version, bound and bfloat16
   library call; ``python3 chip_smoke.py --only aosoa_bf16`` runs phases
   1, 2 and this part alone.  Phase 4's ``one_launch`` tune sweeps the
   AoSoA axis too (candidate and pruned counts printed);
7. the domain decompositions (``decomposition_phase``): a one-rank NCCL
   process group over a file store in a temporary directory, then
   ``BinaryFluidSim`` at 128³, 20 steps from phase 4's state, in the three
   regimes × slab ``(1,)``, pencil ``(1, 1)`` and block ``(1, 1, 1)``
   meshes × overlap off and on, each path with the counters at 0: every
   field's ghost planes filled by the rank's own collectives (one
   ``all_to_all_single`` per exchange, counted) and read by the kernels
   where the no-mesh run wraps.  Each run is held to phase 4's no-mesh
   state (its max |difference| printed, bit-equality expected; the run
   fails past ``rtol=1e-5, atol=1e-6``), its collectives to
   ``comm_stats()`` (over the run and a step of the hot loop), its kernel
   launches to the no-mesh run's; printed as one ``{"decomposition": ...}``
   line a run with ``exchanged_bytes_per_step``, MLUPS beside the no-mesh
   MLUPS of this process, and the exchange round's and the hot loop
   step's device ms (CUDA events) beside the no-mesh step's.

8. fleets (``fleet_phase``, ``tdp.fleet``): the ensemble entries of
   kernels 1 and 2 (``tdp_gathered_ensemble_launch``,
   ``tdp_windowed_ensemble_launch``: every member in one launch, the member
   on ``blockIdx.y``, its physics from a device table) checked site
   function by site function at 3 members with NaN between them, at 16³
   and at phase 3's ragged shape and ghost planes, against the plain
   version and each member's single launch; a 4-member ``tau_phi`` sweep
   at 16³, 20 steps, bit-equal to batch-1 fleets and to solo runs with the
   value static, and the fused regimes' fleets to solo runs; a fleet
   step's launches against one member's; aggregate MLUPS of 64 members of
   32³ (the sites of one 128³ run) per regime beside the same members run
   one after another and phase 4's 128³ MLUPS, device ms a fleet step, and
   512 members of 16³; the driver drill at 16³ (16 tickets, 40 steps: a
   restore mid-run and a poisoned ticket quarantined, every other ticket
   bit-equal to an uninterrupted run; a snapshot's seconds); a row per
   ensemble entry at 64 × 32³ (printed as one ``{"fleet": ...}`` line).

9. training (``training_phase``): the four kernel ``Function``s of
   ``kernels/ops.py`` (``_RMSNormFn``, ``_GatedActFn``, ``_FlashFn``,
   ``_MambaScanFn``) at the training path's full-width shapes
   (``TRAIN_GRAD_SHAPES``), each output and every input's gradient held to
   the plain version's at ``LM_TOL``, kernel 4's log-sum-exp to the plain
   ``logsumexp`` (and its output with the store bit-equal to the one
   without), each timed forward, forward + backward and plain; gemma2-2b
   at full width and depth through ``launch.train`` (``TRAIN_ARGS``: 6
   steps of 8 × 256 tokens in two microbatches on the ``"cuda"`` context),
   the loss falling (the mean of the last 3 steps below that of the first
   3, as the reference's trainer test holds it), then one more step under ``torch.profiler`` (device
   ms by the port's kernels, matrix products and the rest; the share in
   the plain backward passes), then the same first step on the plain
   path (``--backend torch``), one after the other, step 1's loss, global
   gradient norm and worst leaf's gradient norm held at ``TRAIN_TOL``; a resume (gemma2's smoke config on
   the kernels: 3 steps, a checkpoint, a fresh trainer runs to 6) held bit
   for bit to 6 uninterrupted steps; falcon-mamba-7b at full width cut to
   ``FALCON_LAYERS`` layers, 3 steps, step 1 held to the plain path; step
   ms, tokens/s and peak memory (printed as one ``{"training": ...}``
   line); each path counted, the kernel rows of the kernels line naming
   their ``Function`` and carrying its checks and times.  ``python3
   chip_smoke.py --only training`` runs phases 1, 2 and 9 alone (no
   kernels line).

10. the dense archs (``dense_archs_phase``): gemma3-27b (6 layers),
   qwen2-vl-2b (whole; 256 vision slots a prompt on a 16 × 16 (t, h, w)
   M-RoPE grid), phi3-medium-14b (10 layers) and nemotron-4-15b (8
   layers) at full width from seeded random float32 weights
   (``DENSE_SERVE``), each served through ``build_serve_steps`` on the
   kernels (2 prompts of 4096 or 2048 tokens, 16 greedy decode steps), on
   the plain path and warm, as phase 4 serves gemma2: logits within 1e-3,
   greedy tokens equal, the launches of a prefill and of the decode steps
   counted and held to ``dense_expected``, prefill ms, decode ms a step
   and peak memory; gemma3 once more on ring caches for its local layers,
   its tokens equal to the full caches'; training through
   ``launch.train`` (``DENSE_TRAIN``): qwen2-vl-2b whole, 6 steps (the
   loss falling), gemma3-27b one 5:1 group with 8-bit moments, 3 steps,
   each with step 1 held to the plain path at ``TRAIN_TOL``; the LM
   examples: ``train_lm`` at its 22m preset, ``EXAMPLE_STEPS`` (150)
   steps, then ``serve_lm``
   from its checkpoint (the restore reported, the probability its served
   logits put on the bigram table's successors ``SERVE_LM_Z`` standard
   errors above chance); printed as one ``{"dense_archs": ...}``
   line, the phase's paths merged into the LM kernel rows.  ``python3
   chip_smoke.py --only dense`` runs phases 1, 2 and 10 alone.

11. Mixture-of-Experts (``moe_phase``): granite-moe-1b-a400m (24
   ``attn_moe`` layers, 32 experts of 512, top 8) whole at full width
   from seeded random float32 weights.  One MoE layer alone on 8192
   tokens: ``backend="cuda"`` against ``"torch"`` (``LM_TOL``), ``ragged``
   against ``capacity`` at the dropless factor E/K
   (``MOE_DROPLESS_TOL``), the choices dropped at the config's 1.25, each
   timed; the model served through ``build_serve_steps`` (2 prompts of
   4096 tokens, 16 greedy steps) on the kernels, on the plain path and
   warm, with every ``models.moe._route`` call's experts and margins
   recorded on both paths (``recorded_routes``): a route that differs is
   reported with the plain path's margin (the gap between its k-th and
   (k+1)-th router probability) and is a fault at ``MOE_ROUTE_MARGIN`` or
   more; logits are held at 1e-3 and tokens to equality on the sequences
   whose routes and kept choices agree so far (``RouteHold``), and on
   every sequence once more with the kernels run on the plain path's
   routes (``forced_routes``); the
   choices dropped in the prefill counted by layer; launches of a prefill
   and of the decode steps held to ``dense_expected``; training through
   ``launch.train`` (``MOE_TRAIN_ARGS``: 6 steps of 8 × 256 tokens in one
   microbatch), step 1's batch at a lower loss through the trained
   weights, step 1's routes recorded and held the same way and step 1 held to the plain path at ``TRAIN_TOL`` (the loss
   alone where a near-tie route differs); printed as one ``{"moe": ...}``
   line, the phase's paths merged into the LM kernel rows.  ``python3
   chip_smoke.py --only moe`` runs phases 1, 2 and 11 alone, with phase
   5's rows at granite's shapes counting this phase's paths.

12. Mamba-2 SSD and the weight-tied block (``ssd_phase``): zamba2-2.7b
   whole at full width (45 ``mamba2`` layers, one ``shared_attn`` block
   run at 9 positions, Dh 80; 1.98e9 float32 parameters) from seeded
   random weights, served through ``build_serve_steps`` (2 prompts of 4096
   tokens, 16 greedy steps) on the kernels, on the plain path and warm
   (``serve_model``): logits within 1e-3, tokens equal, the launches of a
   prefill (64 rmsnorm, 9 GeGLU, 9 kernel 4) and of a decode step (64
   rmsnorm, 9 GeGLU) held to ``ssd_expected``; then trained through
   ``launch.train`` (``SSD_TRAIN_ARGS``: 6 steps of 8 × 256 tokens in one
   microbatch, block remat, dense AdamW), the tied block one set of tensors
   in the parameters and both moments, step 1's batch at a lower loss
   through the trained weights, step 1 held to the plain path at
   ``TRAIN_TOL``, the launches held, the peak memory; printed as one
   ``{"ssd": ...}`` line, the phase's paths merged into the LM kernel rows.
   ``python3 chip_smoke.py --only ssd`` runs phases 1, 2 and 12 alone,
   with phase 5's rows at zamba2's shapes counting this phase's paths.

13. Multi-head Latent Attention and multi-token prediction
   (``mla_phase``): deepseek-v3-671b at full width from seeded random
   float32 weights, served at its first 4 layers (3 ``attn_dense`` + 1
   ``attn_moe`` of 256 experts, top 8, one shared; 15.11e9 parameters)
   without the MTP module, which serving never reads, through
   ``build_serve_steps`` (2 prompts of 4096 tokens, 16 greedy steps) as
   phase 11 serves granite (``moe_serve``: routes recorded and held by
   ``RouteHold``, logits at 1e-3, tokens equal), the plain path on the
   chunked attention oracle; the launches of a prefill (9 rmsnorm, 5
   SwiGLU, 4 kernel 4) and of a decode step (9 rmsnorm, 5 SwiGLU) held to
   ``deepseek_expected``; then trained at its first 3 layers and its MTP
   module (an ``attn_dense`` block at that cut; 4.29e9 parameters) through
   ``launch.train`` (``MLA_TRAIN_ARGS``: 3 steps of 8 × 256 tokens in two
   microbatches, block remat, 8-bit moments), step 1's loss, ``ce``,
   ``mtp``, gradient norm and worst leaf held to the plain path at
   ``TRAIN_TOL``, the launches held; printed as one ``{"mla": ...}`` line,
   the phase's paths merged into the LM kernel rows.  ``python3
   chip_smoke.py --only mla`` runs phases 1, 2, phase 5's rows at
   deepseek's shapes (before the weights) and 13 alone.

14. the encoder, cross-attention and learned positions
   (``whisper_phase``): whisper-medium whole at full width (24 ``enc`` +
   24 ``xattn`` layers, Dh 64; 793 073 664 float32 parameters) from
   seeded random weights, served through ``build_serve_steps`` (4
   requests of 1500 random audio frames and a 432-token prompt, 16 greedy
   steps: to whisper's trained context of 448) on the kernels, on the
   plain path and warm (``serve_model``): logits within 1e-3, tokens
   equal, the launches of a prefill (72 kernel 4: 24 encoder, 24 causal
   self, 24 cross; 48 GELU) and of a decode step (24 GELU) held to
   ``whisper_expected``, then once more under the profiler (the device's
   busy share of the prefill and of the decode steps); then trained
   through ``runtime.steps.build_train_step`` (``WHISPER_TRAIN_*``: 4
   steps of 8 × 448 tokens and 8 × 1500 frames in two microbatches,
   block remat, dense AdamW), step 1's batch at a lower loss through the
   trained weights, step 1 held to the plain path at ``TRAIN_TOL`` leaf by
   leaf (the encoder's and both position tables' among them), the
   launches held, ms a step, tokens/s and peak memory; printed as one
   ``{"whisper": ...}`` line, the phase's paths merged into the LM kernel
   rows.  Phase 5's rows at whisper's shapes (``whisper_rows``): kernel 4
   at the encoder's (4, 16 / 16, 1500 × 1500), non-causal, the decoder's
   (4, 16 / 16, 432 × 432), causal, and the cross-attention's (4, 16 / 16,
   432 × 1500), non-causal, each beside SDPA; the GELU at (6000, 4096) and
   (1728, 4096) beside ``F.gelu(approximate="tanh")``.  ``python3
   chip_smoke.py --only whisper`` runs phases 1, 2, those rows and 14
   alone.

15. bfloat16 parameters and caches (``bf16_phase``, ROADMAP A7.1): the
   bfloat16 refusals first named on the card — bfloat16 into an example
   site function (``scale``) under AoSoA raises ``NotImplementedError``
   (A7.1c.4), into an LB ensemble launch (A5), kernel 4 at a head dim it
   is not instantiated for (48) ``ValueError``;
   gemma3-27b cut to 12 layers from seeded
   bfloat16 weights served on the kernels and on the plain path, and the
   same weights upcast to float32 on the float32 kernels: the kernels'
   bfloat16 logits no further from the float32 run than
   ``BF16_VS_F32_RATIO`` × the plain path's; gemma3-27b whole (62 layers,
   54.0 GB of bfloat16 weights) served on the kernels with ring caches for
   the local layers (2 × 4096 prompts, 16 greedy steps; launches held to
   ``dense_expected``; once more under the profiler: the busy share) and
   on the plain path (``attn_impl="chunked"``), the logits within
   ``BF16_SERVE_BAR`` of the plain path's largest, greedy tokens equal
   wherever the plain path's top-2 margin exceeds the logits' distance
   (the exceptions counted); gemma2-2b whole trained through
   ``Trainer(param_dtype="bfloat16")`` (``BF16_TRAIN_*``: 8 × 256 tokens
   in two microbatches, layer remat), the loss falling, step 1 held to the
   plain path at ``BF16_TRAIN_TOL`` leaf by leaf with the floor of
   ``hold_leaves_to_floor`` (``BF16_LEAF_FLOOR``), ms a step, tokens/s,
   the peak, one step under the profiler (``profile_train_step``); a
   bfloat16 checkpoint (gemma2 SMOKE on the plain path, its Dh 16 having
   no bfloat16 kernel 4; 3 steps) restored bit for bit.  The control of
   these bars is the plain path with P rounded to bfloat16, as SDPA and
   FlashAttention compute it (``p_rounded_attention``): it must fail step
   1's loss bar and, at 12 layers, the hold of every kernel call on the
   served model's own activations (``held_calls``), which the kernels
   pass; the float32 run must fail the 12-layer logits bar.  Then
   phase 5's rows in bfloat16 through ``dense_rows`` (``BF16_*_ROWS``:
   rmsnorm, GeGLU and GELU at gemma3's and gemma2's shapes, kernel 4 at
   gemma3's local and global layers, Dh 128, and gemma2's, Dh 256, softcap
   50), each held to its plain version on the same bfloat16 inputs
   (``bf16_close``: within one bfloat16 step, at most ``BF16_SHARE_BAR``
   of the elements apart) against a control that must fail that bar
   (``bf16_control``, ``p_rounded_attention``), timed beside it, its bound
   (kernel 4's at ``BF16_ATTN_PER_FLOP``), the library call in bfloat16
   (``F.rms_norm``, SDPA, which rounds P to bfloat16; recorded, not held)
   and its registers and spills; their launches are the phase's.  Printed
   as one ``{"bf16": ...}`` line.  ``python3 chip_smoke.py --only bf16``
   runs phases 1, 2 and 15 alone.

16. bfloat16 for the Mamba, MoE, MLA and whisper families
   (``bf16_families_phase``, ROADMAP A7.1b), each family from seeded
   bfloat16 weights at full width (``BF16F_SERVE``): falcon-mamba-7b (held
   at 8 layers, then served whole, 64 layers), zamba2-2.7b, granite-moe-
   1b-a400m and whisper-medium whole, deepseek-v3-671b at phase 13's 4 of
   61 layers; each served on the kernels with every kernel call held to
   its plain version on the model's own activations (``held_calls``: the
   ``mamba`` scan, kernel 4 and kernel 2a) and its logits to the plain
   path's within ``BF16F_SERVE_BAR`` of the largest (the plain scan fed dt
   rounded as the kernels take it, ``dt_rounded_scan``), greedy tokens
   equal wherever the margin exceeds the distance; prefill ms, decode ms a
   step, the busy share (``serve_busy``) and the peak; each path's
   launches held to the family's float32 count.  Then each family trained
   in bfloat16 at its float32 phase's depth and shape (``BF16F_TRAINS``:
   falcon-mamba-7b × 4, zamba2 and granite whole, deepseek-v3 × 3 with its
   MTP module and 8-bit moments through ``Trainer(param_dtype=
   "bfloat16")``, whisper-medium whole through ``build_train_step``),
   step 1 held to the plain path at ``BF16_TRAIN_TOL`` leaf by leaf with
   the floor of ``hold_leaves_to_floor`` (the norms rounded once more:
   ``rounded_rmsnorm``, ``rounded_layernorm``; widened only for
   ``BF16F_TRAIN_WIDE``'s families; zamba2's gradient at 12 layers, its
   54-layer loss whole), the plain path on the
   kernels' MoE routes (``forced_routes``; the routes it would have taken
   reported), ms a step, tokens/s and the peak (``bf16_family_train``);
   before the models, kernel 4's bfloat16 gradient alone at each family's
   training microbatch (``BF16F_ATTN_GRADS``, ``chunked_backward`` its
   control).
   Then the rows in
   bfloat16 (``bf16_family_rows``): the ``mamba`` site function at
   falcon-mamba-7b's layer (2, 4096, 8192, 16) at every VVL, kernel 4 at
   granite's, whisper's three, zamba2's and deepseek's attentions
   (``BF16F_ATTN_ROWS``), each held to its plain version by ``bf16_close``
   against a control that must fail it (the scan's state rounded to
   bfloat16 each step, ``mamba_state_rounded``; ``p_rounded_attention``),
   timed beside it, its bound and SDPA in bfloat16 (recorded, not held),
   with its registers and spills.  Printed as one ``{"bf16_families":
   ...}`` line.  ``python3 chip_smoke.py --only bf16_families`` runs phases
   1, 2 and 16 alone.

17. bfloat16 in the LB and example kernels (``lb_bf16_phase``, ROADMAP
   A7.1c.3): ``BinaryFluidSim(dtype=torch.bfloat16)`` at 128³, 20 steps, in
   the unfused, ``one_launch`` and ``two_launch`` regimes through kernels
   1, 2 and 3 (NaN-free, bfloat16 states), ``ops.lb_collision`` and
   ``ops.lb_fused_step`` (windowed and gathered, bit-equal to each other)
   on its state, ``tdp.launch`` of ``scale`` / ``saxpy`` / ``site_pos``
   (a = ``LB_BF16_A``) and ``reduce``, each path counted; each regime held
   to the plain path on the card at ``LB_BF16_CHECK_GRID``; MLUPS in
   bfloat16 beside float32, in turns in this process.  Then a row per
   bfloat16 kernel (``lb_bf16_rows``): every LB kernel × site function at
   128³ and on phase 3's ragged lattice with ghost planes at VVL 1, 2, 4
   and 8 (the windowed ``fused`` at plane_block 2 and 8), the example sites
   at (3, 128³) at every VVL and ``reduce`` (sum within one bfloat16 step
   of the float64 sum, max and min exact), each held to its plain version
   on the same bfloat16 inputs (bit for bit expected, ``bf16_close``
   held), timed beside it (the plain version over ``LB_BF16_PLAIN_REPS``
   launches), its bfloat16 bound and library call (``nn.Conv3d``,
   ``g.sum(0)``, ``torch.mul``, ``torch.add``, ``x.sum(-1)``: recorded, not
   held) and its registers and spills; its launches are the phase's.
   Printed as one ``{"lb_bf16": ...}`` line.  ``python3 chip_smoke.py
   --only lb_bf16`` runs phases 1, 2 and 17 alone.

Prints the kernels line (none under ``--only``) and, last, ``{"ok": true,
"device": {...}}``; exits
non-zero, printing no result, when anything fails or no card is present.
Long output goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM data-sheet peaks (dense): HBM3 bandwidth and float32 outside the
#: tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: TF32 on the tensor cores, dense (data sheet).
PEAK_TF32_PER_S = 495e12
#: Exponentials per second on the special-function units: 16 per clock per
#: SM (Hopper architecture white paper: 4 SFUs in each of an SM's four
#: partitions) × 132 SMs × the 1.98 GHz boost clock of the SXM part.
PEAK_SFU_PER_S = 16 * 132 * 1.98e9

#: Bytes each site function must move per site (inputs read once, outputs
#: written once, float32) and its float32 operations per site, counted by
#: hand from csrc/lb_sites.cuh.
BYTES_PER_SITE = {"collide": 324, "fused": 304, "fused_two": 308,
                  "stream": 152, "moment": 80, "phi_stream": 80, "grad6": 20}
FLOPS_PER_SITE = {"collide": 593, "fused": 732, "fused_two": 606,
                  "stream": 0, "moment": 18, "phi_stream": 18, "grad6": 13}

KERNELS = {
    "tdp_gathered": dict(source="src/repro_torch/csrc/tdp_gathered.cu",
                         replaces="src/repro/kernels/tdp_pointwise.py:76"),
    "tdp_gathered.rmsnorm": dict(
        source="src/repro_torch/csrc/tdp_gathered_lm.cu",
        replaces="src/repro/kernels/lm.py:54"),
    "tdp_gathered.gated": dict(
        source="src/repro_torch/csrc/tdp_gathered_lm.cu",
        replaces="src/repro/kernels/lm.py:89"),
    "tdp_gathered.act": dict(
        source="src/repro_torch/csrc/tdp_gathered_lm.cu",
        replaces="src/repro/kernels/lm.py:95"),
    "tdp_gathered.mamba": dict(
        source="src/repro_torch/csrc/tdp_gathered_lm.cu",
        replaces="src/repro/kernels/lm.py:120"),
    "flash_attention": dict(source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:94"),
    "tdp_windowed": dict(source="src/repro_torch/csrc/tdp_windowed.cu",
                         replaces="src/repro/kernels/tdp_windowed.py:77"),
    "lb_collision": dict(source="src/repro_torch/csrc/lb_collision.cu",
                         replaces="src/repro/kernels/lb_collision.py:136"),
    "calibrate.add": dict(source="src/repro_torch/csrc/calibrate.cu",
                          replaces="src/repro/core/costmodel.py:190"),
    "calibrate.fma": dict(source="src/repro_torch/csrc/calibrate.cu",
                          replaces="src/repro/core/costmodel.py:202"),
    "tdp_gathered.example": dict(
        source="src/repro_torch/csrc/tdp_gathered_example.cu",
        replaces="src/repro/kernels/tdp_pointwise.py:76"),
    # the reference's reduce: kernel 2's map, then jnp.sum outside it
    "tdp_gathered.reduce": dict(
        source="src/repro_torch/csrc/tdp_gathered_example.cu",
        replaces="src/repro/kernels/tdp_pointwise.py:76"),
    # the ensemble branches of TPU kernels 1 and 2 (the reference vmaps the
    # compiled step, which adds a grid axis to their pallas_calls)
    "tdp_gathered_ensemble": dict(
        source="src/repro_torch/csrc/tdp_gathered.cu",
        replaces="src/repro/kernels/tdp_pointwise.py:76"),
    "tdp_windowed_ensemble": dict(
        source="src/repro_torch/csrc/tdp_windowed.cu",
        replaces="src/repro/kernels/tdp_windowed.py:77"),
    # the AoSoA branches of TPU kernels 1 and 2
    "tdp_gathered_aosoa": dict(source="src/repro_torch/csrc/tdp_gathered.cu",
                               replaces="src/repro/kernels/tdp_pointwise.py:96"),
    "tdp_windowed_aosoa": dict(source="src/repro_torch/csrc/tdp_windowed.cu",
                               replaces="src/repro/kernels/tdp_windowed.py:102"),
    "tdp_gathered_aosoa.example": dict(
        source="src/repro_torch/csrc/tdp_gathered_example.cu",
        replaces="src/repro/kernels/tdp_pointwise.py:96"),
    "tdp_gathered_aosoa.lm": dict(
        source="src/repro_torch/csrc/tdp_gathered_lm.cu",
        replaces="src/repro/kernels/tdp_pointwise.py:96"),
}
STENCIL_SITES = ("stream", "grad6", "fused", "phi_stream", "fused_two")
#: LB checks of phase 3 besides 128³: a size that cuts every fused tile
#: (45 % 8, 70 % 32, 67 % plane_block) and ghost planes in one, two and
#: three dimensions there (a block decomposition's), each where it covers
#: the site function's stencil radius (``fused`` reads g at radius 2).
LB_RAGGED = (67, 45, 70)
LB_HALOS = ((2, 0, 0), (0, 2, 3), (1, 1, 1), (2, 2, 2))
#: Phase 7's meshes, one rank each: mesh axis k shards grid dim k.
DECOMPOSITIONS = {"slab": ("px",), "pencil": ("px", "py"),
                  "block": ("px", "py", "pz")}
#: Phase 7's timed launches and hold (about 0.25 s: longer than the host
#: takes to enqueue 10 decomposed steps, collectives included).
PHASE7_REPS, PHASE7_HOLD = 10, 500_000_000
#: plane_block values the windowed fused is timed at in phase 5
PLANE_BLOCKS = (1, 2, 4, 8)
#: Phase 8, fleets.  The ensemble checks: (tau, tau_phi) of each of their 3
#: members (a physics row each), FLEET_GAP floats of NaN between members.
FLEET_TAUS = ((0.8, 1.2), (0.9, 0.933), (1.0, 1.067))
FLEET_GAP = 61
FLEET_SMALL = (16, 16, 16)
#: tau_phi of the 4-member sweep held to batch-1 fleets and solo runs
FLEET_SWEEP = (0.8, 0.933, 1.067, 1.2)
#: the throughput fleet: 64 members of 32³, the sites of one 128³ run
#: (2 097 152), and a wide one of 512 members of 16³
FLEET_BIG = (64, (32, 32, 32))
FLEET_WIDE = (512, FLEET_SMALL)
FLEET_STEPS = 10
#: the driver drill: tickets, member steps, the pump round of the restored
#: snapshot and the member step the chaos drill poisons
DRILL_TICKETS, DRILL_STEPS, DRILL_SNAPSHOT, DRILL_POISON = 16, 40, 18, 20
#: Per-launch ms at 128³, VVL 1, of the LB kernels before their redesign
#: (PERF.md §6: this script's phase 5 on an NVIDIA H100 80GB HBM3 at 700 W),
#: printed beside this run's times; the prologue each of them needed (a
#: gather or a pad) is not in these figures.
EARLIER_MS = {
    "tdp_gathered.stream": 0.1163, "tdp_gathered.grad6": 0.0359,
    "tdp_gathered.moment": 0.0606, "tdp_gathered.collide": 0.2458,
    "tdp_gathered.fused": 0.5292, "tdp_gathered.phi_stream": 0.0608,
    "tdp_gathered.fused_two": 0.2484, "tdp_windowed.stream": 0.1191,
    "tdp_windowed.grad6": 0.0229, "tdp_windowed.fused": 0.4195,
    "tdp_windowed.phi_stream": 0.0625, "tdp_windowed.fused_two": 0.2381}
#: Per-launch ms at (3, 128³), VVL 1, of kernel 2's example entry and
#: reduce before their redesign (PERF.md §6: this script's phases 5 and 6
#: on an NVIDIA H100 80GB HBM3 at 700 W); reduce was the scale map plus
#: torch.sum.  Printed beside this run's times.
EARLIER_EXAMPLE_MS = {
    "tdp_gathered.scale": 0.0255, "tdp_gathered.saxpy": 0.0327,
    "tdp_gathered.site_pos": 0.0254, "tdp_gathered.reduce": 0.0375,
    "tdp_gathered_aosoa.scale": 0.0264, "tdp_gathered_aosoa.saxpy": 0.0335,
    "tdp_gathered_aosoa.site_pos": 0.0264}
#: AoSoA block widths of phase 6's LB and example checks (each divides the
#: 128² sites of an x-plane), and the widths of its main path: the LB
#: trajectories, rmsnorm and the timed LB and example rows; gated/act;
#: mamba (a multiple of 4).
AOSOA_WIDTHS = (8, 32, 128)
AOSOA_W, AOSOA_W_EW, AOSOA_W_MAMBA = 32, 96, 16
PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
PHYS = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1, gamma=0.8)
GRID = (128, 128, 128)
STEPS = 20
#: The most clock cycles the spin kernel of time_ms() holds the stream: about
#: a second at the H100's clocks, longer than the host takes to enqueue 20
#: launches of any function time_ms() times.  The mamba site function's plain version (a
#: Python loop of some 33 000 PyTorch calls per launch) is host-bound and is
#: timed by wall_ms() instead.
HOLD_CYCLES = 2_000_000_000
#: time_ms()'s spin is sized from the warm-up: HOLD_MARGIN times the
#: longest a warm-up call took to return, for every timed call, at the
#: H100's boost clock (a lower clock spins longer), and never under
#: HOLD_FLOOR cycles (~10 ms).
HOLD_MARGIN = 3
HOLD_FLOOR = 20_000_000
SPIN_CLOCK_HZ = 1.98e9
#: time_ms()'s timed loops, and those timed again under the full hold
TIMED = {"calls": 0, "retimed": 0}
#: The hold for the tdp surface's rows: about 0.1 s, longer than 20 launches
#: of any of them take to enqueue (the AoS collision is ~40 PyTorch calls).
SHORT_HOLD = 200_000_000
#: The tdp surface phase: a 3-component field of 128³ sites (the paper's
#: §III-C example at Ludwig's size a device), scaled by 2.0; the spinodal
#: example's steps and chunk.
TDP_NCOMP, TDP_A = 3, 2.0
SPINODAL_STEPS, SPINODAL_CHUNK = 200, 50

#: The LM kernels' bar against their plain versions: the reference's own
#: (tests/test_kernels.py:105).
LM_TOL = dict(rtol=2e-4, atol=2e-4)
#: gemma2-2b served at full width: 2 prompts of 4608 tokens (longer than the
#: 4096 window, so the local mask bites), 16 greedy decode steps.
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 2, 4608, 16
#: Served logits, kernels against the plain path on the card: float32
#: through 26 (gemma2) or 64 (falcon-mamba) layers, the two differing in
#: summation order only.
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)
#: falcon-mamba-7b served at full width: 2 prompts of 4096 tokens.
MAMBA_PROMPT = 4096
#: ops.mamba_scan checks, (batch, L, d_inner, N): the reference tests'
#: shapes (tests/test_kernels.py:140), a ragged channel count and the
#: full-width falcon-mamba-7b prefill.
MAMBA_CASES = [(1, 64, 32, 8), (2, 128, 64, 16), (1, 77, 1000, 16),
               (SERVE_BATCH, MAMBA_PROMPT, 8192, 16),
               # cutting the new tiles: L not a multiple of any chunk (32,
               # 16, 8 or 4 steps), batch 1 and 3, ragged channel blocks,
               # n not a multiple of 4 (the 4-byte copies)
               (3, 45, 300, 8), (1, 333, 520, 16), (3, 101, 301, 16)]
#: rmsnorm checks, (tokens, d): gemma2-2b's prefill and decode, a ragged
#: small case, falcon-mamba-7b's decode and prefill.
RMS_CHECKS = [(SERVE_BATCH * SERVE_PROMPT, 2304), (SERVE_BATCH, 2304), (37, 64),
              (SERVE_BATCH, 4096), (SERVE_BATCH * MAMBA_PROMPT, 4096),
              # the dense archs' prefills: gemma3, qwen2-vl (2 × 4096
              # tokens), phi3 (2 × 2048)
              (8192, 5376), (8192, 1536), (4096, 5120),
              # granite-moe-1b-a400m's prefill, decode and training step
              (8192, 1024), (2, 1024), (2048, 1024),
              # zamba2-2.7b's
              (8192, 2560), (2, 2560), (2048, 2560),
              # deepseek-v3-671b's prefill, decode and training microbatch
              (8192, 7168), (2, 7168), (1024, 7168)]
#: the dense archs' MLP activations, (kind, gated, tokens, d_ff): qwen2-vl's
#: SwiGLU and nemotron's ungated squared ReLU at their prefills' sizes
DENSE_EW_CHECKS = [("swiglu", True, 8192, 8960), ("relu2", False, 4096, 24576),
                   # granite's SwiGLU over the packed expert rows (32
                   # experts × 2560 slots) of its 2 × 4096-token prefill
                   ("swiglu", True, 81920, 512),
                   # zamba2's shared block's GeGLU at its prefill
                   ("geglu", True, 8192, 10240),
                   # deepseek-v3's dense FFN and packed expert rows (256
                   # experts × 320 slots) at its prefill
                   ("swiglu", True, 8192, 18432), ("swiglu", True, 81920, 2048)]
#: Elements of the unaligned gated/act check: not a multiple of 4.
UNALIGNED_N = 1_000_003
#: Calls the mamba site function's plain version (a Python loop over 4096
#: steps) is timed over, by wall clock; the kernel over 20 launches.
MAMBA_PLAIN_REPS = 3
#: flash_attention checks: (B, Hq, Hkv, Sq, Sk, Dh, causal, window, softcap)
ATTN_CASES = [(2, 4, 4, 128, 128, 32, c, 0, 0.0) for c in (True, False)] + [
    (2, 8, 2, 128, 128, 64, c, 0, 0.0) for c in (True, False)] + [
    (2, 4, 1, 256, 256, 32, c, 0, 0.0) for c in (True, False)] + [
    (1, 2, 2, 128, 128, 32, True, 16, 0.0),
    (1, 2, 2, 128, 128, 32, True, 64, 0.0),
    (1, 2, 2, 64, 64, 32, True, 0, 30.0),
    (2, 4, 2, 16, 16, 16, True, 8, 50.0),          # the smoke config
    (1, 8, 4, 1000, 1000, 256, True, 100, 50.0),   # ragged Sq = Sk
    (1, 2, 2, 40, 20, 32, False, 5, 0.0),          # rows with no live key
    (2, 8, 4, 4608, 4608, 256, True, 4096, 50.0),  # gemma2 local layer
    (2, 8, 4, 4608, 4608, 256, True, 0, 50.0),     # gemma2 global layer
    # Sq, Sk not multiples of the 128 query rows or the key tile (64 keys at
    # Dh 64, 32 at Dh 128)
    (1, 4, 2, 100, 100, 64, True, 0, 0.0),
    (2, 4, 1, 200, 333, 64, False, 0, 0.0),
    (1, 4, 2, 130, 130, 128, True, 50, 50.0),
    (1, 2, 2, 77, 300, 128, False, 0, 0.0),
    # query tiles 2 and 3 (rows 128..299) see no key: k > q - 30 >= 98, k < 40
    (1, 2, 2, 300, 40, 128, False, 30, 0.0),
    # the dense archs at full width, Dh 128, no softcap: gemma3's local
    # (window 1024: most key tiles of a row dead) and global layers (GQA
    # 32/16), qwen2-vl (12/2: group 6), nemotron (48/8: group 6), phi3
    # (40/10)
    (2, 32, 16, 4096, 4096, 128, True, 1024, 0.0),
    (2, 32, 16, 4096, 4096, 128, True, 0, 0.0),
    (2, 12, 2, 4096, 4096, 128, True, 0, 0.0),
    (2, 48, 8, 2048, 2048, 128, True, 0, 0.0),
    (2, 40, 10, 2048, 2048, 128, True, 0, 0.0),
    # GQA group 6 over ragged query and key tiles, with and without a window
    (1, 12, 2, 300, 300, 128, True, 70, 0.0),
    (1, 12, 2, 200, 333, 128, False, 0, 0.0),
    # granite-moe-1b-a400m at full width: Dh 64 (64-key tiles), GQA 16/8
    (2, 16, 8, 4096, 4096, 64, True, 0, 0.0),
    # zamba2's shared block at Dh 80 (V pairs of 16 dimensions): ragged
    # query and key tiles, a window with a softcap, GQA
    (1, 4, 4, 300, 300, 80, True, 0, 0.0),
    (1, 4, 2, 200, 333, 80, False, 50, 30.0),
    (2, 6, 3, 130, 130, 80, True, 37, 0.0),
    # deepseek-v3's MLA at Dh 192 (six V pairs of 32): ragged query and key
    # tiles, causal and not, a window with a softcap
    (1, 4, 4, 300, 300, 192, True, 0, 0.0),
    (1, 4, 4, 200, 333, 192, False, 0, 0.0),
    (1, 2, 2, 130, 130, 192, True, 50, 30.0),
]
#: ATTN_CASES entries also run on (B, S, H, Dh) tensors seen as (B, H, S,
#: Dh): the layout the model hands the kernel.
ATTN_VIEW_CASES = [(2, 8, 4, 300, 300, 256, True, 100, 50.0),
                   (1, 4, 2, 130, 130, 128, True, 0, 0.0),
                   (1, 4, 4, 130, 130, 80, True, 0, 0.0),
                   (1, 4, 4, 130, 130, 192, True, 0, 0.0)]
#: Per-launch ms of the LM kernels this PR redesigns, before it (PERF.md §6:
#: this script's phase 5 on an NVIDIA H100 80GB HBM3 at 700 W): flash at
#: gemma2-2b's prefill shape, and the mamba site function at falcon-mamba-7b's
#: full width, one launch per batch row then (4.768 ms each), so a layer's
#: two rows took twice that.  Printed beside this run's times.
EARLIER_LM_MS = {"flash_attention.local": 8.664, "flash_attention.attn": 8.786,
                 "flash_attention.causal": 8.614,
                 "tdp_gathered.mamba": 2 * 4.768}


#: Phase 9, training.  The kernel Functions' gradients are checked at the
#: training path's full-width shapes: rmsnorm at a microbatch's 1024 tokens
#: of gemma2-2b (d 2304) and falcon-mamba-7b (d 4096), GeGLU at gemma2's
#: FFN width, flash at a microbatch of 4 × 256 tokens (Dh 256, GQA 8/4),
#: the mamba scan at falcon-mamba-7b's d_inner and d_state.
TRAIN_GRAD_SHAPES = {"rmsnorm": [(1024, 2304), (1024, 4096)],
                     "gated": (1024, 9216),
                     "flash_attention": (4, 8, 4, 256, 256),
                     "mamba": (4, 256, 8192, 16)}
#: CUDA-event repetitions of each Function's timings
GRAD_REPS = 10
#: gemma2-2b's run through launch.train: 8 × 256 tokens a step in two
#: microbatches, a warmup of 2 steps (the default 50 would keep the rate near
#: 0 over a 6-step run), no checkpoint (one would be 31 GB), every step
#: logged.
TRAIN_WARMUP = 2
TRAIN_ARGS = ["--arch", "gemma2-2b", "--seq-len", "256", "--global-batch",
              "8", "--grad-accum", "2", "--warmup", str(TRAIN_WARMUP),
              "--ckpt-every", "0", "--log-every", "1"]
TRAIN_STEPS = 6
#: Step 1 on the kernels against step 1 on the plain path (backend "torch")
#: on the card, same weights and batch, relative: the loss (one float32
#: reduction after 26 layers, each kernel within LM_TOL of its plain
#: twin), the global gradient norm (the norm of 2.6e9 gradients through
#: the same layers' backward passes) and, leaf by leaf, each parameter's
#: gradient norm (the worst leaf is held: a wrong gradient on a few small
#: leaves barely moves the global norm).  Set from gemma2-2b's readings
#: (7.4e-8, 3.4e-6 and 5.2e-6 on an H100 80GB HBM3 at 700 W) with room of
#: about 15×.
TRAIN_TOL = {"loss": 1e-6, "grad_norm": 5e-5, "leaf_grad_norm": 8e-5}
#: the resume check (gemma2's smoke config: a full-width checkpoint would
#: be 31 GB): a checkpoint at step 3, a fresh trainer runs to 6
RESUME_STEPS = (3, 6)
#: falcon-mamba-7b at full width, cut to 4 of its 64 layers (0.95e9
#: parameters; the whole model's weights, gradients and moments would be
#: 116 GB)
FALCON_LAYERS, FALCON_STEPS = 4, 3
#: the kernels each training path launches, and how often a layer's
#: forward does (two norms, one MLP, one attention; one norm, one scan)
TRAIN_NEEDS = {"gemma2-2b": {("tdp_gathered", "rmsnorm"): 2,
                             ("tdp_gathered", "gated"): 1,
                             ("flash_attention", "flash_attention"): 1},
               "falcon-mamba-7b": {("tdp_gathered", "rmsnorm"): 1,
                                   ("tdp_gathered", "mamba"): 1}}
#: the port's kernels by name in a profiler trace, and what else counts as
#: a matrix product (cuBLAS / CUTLASS kernel names)
TRAIN_KERNEL_NAMES = {"rmsnorm": ("rms_tiled_kernel", "rms_few_kernel"),
                      "gated": ("ew_kernel",), "mamba": ("mamba_kernel",),
                      "flash_attention": ("flash_fwd_kernel",)}
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma")
#: the autograd nodes of the four kernel Functions (their plain backward)
BACKWARD_NODES = ("_RMSNormFnBackward", "_GatedActFnBackward",
                  "_MambaScanFnBackward", "_FlashFnBackward")
#: the Function each LM kernel row runs under when a gradient is wanted
ROW_FUNCTIONS = {"rmsnorm": "_RMSNormFn", "gated": "_GatedActFn",
                 "act": "_GatedActFn", "mamba": "_MambaScanFn",
                 "flash_attention": "_FlashFn"}


#: Phase 5's rows of the dense archs' shapes: rmsnorm (suffix, d, tokens)
#: at their prefills; the MLP activations (name, kind, gated, tokens, d_ff,
#: float32 operations an element); kernel 4 (name, B, Hq, Hkv, S, window,
#: Dh), causal, no softcap.
DENSE_RMS_ROWS = [(".gemma3_d5376", 5376, 8192), (".qwen2vl_d1536", 1536, 8192),
                  (".phi3_d5120", 5120, 4096)]
DENSE_EW_ROWS = [("tdp_gathered.gated.swiglu", "swiglu", True, 8192, 8960, 5),
                 ("tdp_gathered.act.relu2", "relu2", False, 4096, 24576, 2)]
DENSE_ATTN_ROWS = [("gemma3_local", 2, 32, 16, 4096, 1024, 128),
                   ("gemma3_attn", 2, 32, 16, 4096, 0, 128),
                   ("qwen2vl", 2, 12, 2, 4096, 0, 128),
                   ("nemotron", 2, 48, 8, 2048, 0, 128),
                   ("phi3", 2, 40, 10, 2048, 0, 128)]
#: The same rows at granite-moe-1b-a400m's prefill (phase 11): rmsnorm at d
#: 1024 over 2 × 4096 tokens, SwiGLU over the packed expert rows (32
#: experts × 2560 slots of 512), kernel 4 at Dh 64, GQA 16/8.
MOE_RMS_ROWS = [(".granite_d1024", 1024, 8192)]
MOE_EW_ROWS = [("tdp_gathered.gated.granite_experts", "swiglu", True, 81920,
                512, 5)]
MOE_ATTN_ROWS = [("granite", 2, 16, 8, 4096, 0, 64)]
#: Phase 10, the dense archs served at full width: (layers kept, prompt
#: length), 2 prompts each.  gemma3-27b's 62 layers (108 GB of float32
#: weights) exceed a card: 6 layers are one whole 5:1 group (15.5 GB; the
#: time budget took it down from 12 when phase 15 served the model whole
#: in bfloat16).  phi3 (58.6 GB) and nemotron (62.6 GB) would fit whole,
#: but the plain path's comparison and the time budget take 10 and 8
#: layers.
DENSE_SERVE = {"gemma3-27b": (6, 4096), "qwen2-vl-2b": (28, 4096),
               "phi3-medium-14b": (10, 2048), "nemotron-4-15b": (8, 2048)}
#: qwen2-vl's vision stub: a 16 × 16 patch grid (256 slots) a prompt, the
#: first prompt's at slot 0, the second's after 100 text tokens
DENSE_GRID, DENSE_VISION_AT = (16, 16), (0, 100)
#: Phase 10's training runs through launch.train, 8 × 256 tokens a step in
#: two microbatches, layer remat: qwen2-vl-2b whole (24.7 GB of weights,
#: gradients and moments), 6 steps; gemma3-27b at full width cut to one
#: 5:1 group (3.89e9 parameters) with 8-bit moments, 3 steps.
DENSE_TRAIN = {"qwen2-vl-2b": ([], 6),
               "gemma3-27b": (["--layers", "6", "--quant-moments"], 3)}
DENSE_TRAIN_ARGS = ["--seq-len", "256", "--global-batch", "8", "--grad-accum",
                    "2", "--warmup", str(TRAIN_WARMUP), "--ckpt-every", "0",
                    "--log-every", "1"]
#: the LM examples: train_lm's 22m preset for 150 steps (its default is
#: 300; at ~0.24 s a step on the card this is the phase's largest share),
#: then serve_lm from its checkpoint.  serve_lm's check holds either: the
#: mass on the bigram table's successors sat 26.7 standard errors above
#: chance after 300 steps on the card, 50.0 after 150 on the CPU
EXAMPLE_STEPS = 150
#: serve_lm's served probability on the bigram table's successors must lie
#: this many standard errors above chance.  After 150-300 steps the 22m
#: model is 0.06-0.15 nats better than uniform (loss 8.95-8.86 against
#: 9.01), so its greedy continuations follow the table by luck (1 or 0 of
#: 256 tokens, chance 0.25): the probability its logits put on the
#: successors measures what it learned.
SERVE_LM_Z = 3
#: Phase 12, zamba2-2.7b whole at full width (45 ``mamba2`` layers and 9
#: uses of one weight-tied attention block at Dh 80; 1.98e9 float32
#: parameters): 2 prompts of 4096 tokens served, 16 greedy steps, then 6
#: training steps of 8 × 256 tokens in one microbatch, block remat, dense
#: AdamW (31.7 GB of parameters, gradients and moments).
SSD_ARCH, SSD_PROMPT, SSD_TRAIN_STEPS = "zamba2-2.7b", 4096, 6
SSD_TRAIN_ARGS = ["--arch", SSD_ARCH, "--seq-len", "256", "--global-batch",
                  "8", "--grad-accum", "1", "--warmup", str(TRAIN_WARMUP),
                  "--ckpt-every", "0", "--log-every", "1"]
#: Phase 5's rows at zamba2's prefill (2 × 4096 tokens): rmsnorm at d 2560,
#: GeGLU at (8192, 10 240), kernel 4 at Dh 80 with 32 / 32 heads, causal;
#: beside kernel 4's row, for the record, the route that pads q, k and v to
#: ``SSD_PAD_DH`` (no path takes it)
SSD_RMS_ROWS = [(".zamba2_d2560", 2560, 8192)]
SSD_EW_ROWS = [("tdp_gathered.gated.zamba2_geglu", "geglu", True, 8192,
                10240, 10)]
SSD_ATTN_ROWS = [("zamba2", 2, 32, 32, 4096, 0, 80)]
SSD_PAD_DH = 128
#: Step 1's leaves in phase 12: the SSD's ``a_log``, ``dt_bias`` and
#: conv-bias gradients sum over every token, step and state with heavy
#: cancellation, so their norms move by ~1e-4 when the norms' outputs move
#: by a float32 rounding (the plain path itself is bit for bit
#: reproducible).  A leaf whose move from the plain path exceeds
#: ``TRAIN_TOL["leaf_grad_norm"]`` is held at this many times its move
#: when the plain path's RMSNorm outputs are rounded once more
#: (``rounded_rmsnorm``): the kernel's rounding (≤ 1.5 ulp from the plain
#: version) against a correct rounding (≤ 0.5 ulp from exact), plus the
#: other kernels' share.
SSD_LEAF_FLOOR = 4
#: Phase 11, granite-moe-1b-a400m whole at full width (24 attn_moe layers,
#: 32 experts of 512, top 8; 1.33e9 float32 parameters): 2 prompts of 4096
#: tokens served, then 6 training steps of 8 × 256 tokens in one
#: microbatch (2048 tokens: 640 slots an expert, 20 480 packed rows).
MOE_ARCH, MOE_PROMPT, MOE_TRAIN_STEPS = "granite-moe-1b-a400m", 4096, 6
MOE_TRAIN_ARGS = ["--arch", MOE_ARCH, "--seq-len", "256", "--global-batch",
                  "8", "--grad-accum", "1", "--warmup", str(TRAIN_WARMUP),
                  "--ckpt-every", "0", "--log-every", "1"]
#: A route may differ between the kernels and the plain path only where the
#: plain path's k-th and (k+1)-th router probabilities lie closer than this
#: (the paths differ by float32 rounding: rmsnorm by up to 3.8e-6).
MOE_ROUTE_MARGIN = 1e-5
#: ragged (dropless) against capacity at the dropless factor E/K, one MoE
#: layer on the kernels: the same products in other GEMM shapes
MOE_DROPLESS_TOL = dict(rtol=1e-5, atol=1e-5)
#: Phase 13, deepseek-v3-671b at full width.  Served at its first 4 layers
#: (3 ``attn_dense`` + 1 ``attn_moe``: every block type; 256 experts of
#: 2048, top 8, one shared expert; 15.11e9 float32 parameters, 60.4 GB)
#: without the MTP module, which serving never reads: 2 prompts of 4096
#: tokens, 16 greedy steps, the plain path on the chunked attention oracle
#: (the whole-score one would hold three (2, 128, 4096, 4096) float32
#: tensors, 17.2 GB each).  Trained at its first 3 layers with the MTP
#: module (an ``attn_dense`` block at that cut; 4.29e9 parameters)
#: through ``launch.train``: 3 steps of 8 × 256 tokens in two
#: microbatches, block remat, 8-bit moments (dense AdamW would need 68.6
#: GB before activations).
MLA_ARCH, MLA_SERVE_LAYERS, MLA_PROMPT = "deepseek-v3-671b", 4, 4096
MLA_TRAIN_STEPS, MLA_TRAIN_ACCUM = 3, 2
MLA_TRAIN_ARGS = ["--arch", MLA_ARCH, "--layers", "3", "--quant-moments",
                  "--seq-len", "256", "--global-batch", "8", "--grad-accum",
                  str(MLA_TRAIN_ACCUM), "--warmup", str(TRAIN_WARMUP),
                  "--ckpt-every", "0", "--log-every", "1"]
#: Phase 5's rows at deepseek-v3's prefill (2 × 4096 tokens): rmsnorm at d
#: 7168; SwiGLU over the dense FFN (8192, 18 432) and the packed experts
#: (256 experts × 320 slots at capacity 1.25, 2048); kernel 4 at (B, Hq,
#: Hkv, S, Dh) with V carrying ``MLA_V_DIM`` of its Dh dimensions (the rest
#: zero, as the model pads it)
MLA_RMS_ROWS = [(".deepseek_d7168", 7168, 8192)]
MLA_EW_ROWS = [("tdp_gathered.gated.deepseek_dense", "swiglu", True, 8192,
                18432, 5),
               ("tdp_gathered.gated.deepseek_experts", "swiglu", True,
                81920, 2048, 5)]
MLA_ATTN, MLA_V_DIM = ("deepseek", 2, 128, 128, 4096, 192), 128
#: a head_dim kernel 4 is not instantiated for: it must raise
MLA_BAD_DH = 96
#: Phase 14, whisper-medium whole at full width (24 ``enc`` + 24 ``xattn``
#: layers, d 1024, 16 heads of 64, 793 073 664 float32 parameters): 4
#: requests of 1500 random audio frames and a 432-token prompt served, 16
#: greedy steps (to position 447: whisper's trained decoder context of
#: 448); trained on 8 × 448 tokens (and 8 × 1500 frames) a step in two
#: microbatches, block remat, dense AdamW, through
#: ``runtime.steps.build_train_step`` (``launch.train`` refuses an
#: encoder–decoder arch: its synthetic stream carries no frames), the
#: successor stream's tokens with frames drawn from the step's seed.
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT = "whisper-medium", 4, 432
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_ACCUM = 8, 448, 2
WHISPER_TRAIN_STEPS = 4
#: Phase 5's rows at whisper's prefill (4 × 432 tokens, 4 × 1500 frames):
#: kernel 4 at its three attentions (tag, B, Hq, Hkv, Sq, Sk, causal) at
#: Dh 64 — the encoder's self-attention, the decoder's causal
#: self-attention and its cross-attention onto the frames — beside
#: ``scaled_dot_product_attention`` (``is_causal`` only for the causal
#: one); the ungated GELU over the encoder's and the decoder's MLP rows
#: (name, kind, gated, tokens, d_ff, float32 operations an element)
WHISPER_ATTN_ROWS = [("whisper_encoder", 4, 16, 16, 1500, 1500, False),
                     ("whisper_decoder", 4, 16, 16, 432, 432, True),
                     ("whisper_cross", 4, 16, 16, 432, 1500, False)]
WHISPER_EW_ROWS = [("tdp_gathered.act.gelu_whisper_encoder", "gelu", False,
                    6000, 4096, 9),
                   ("tdp_gathered.act.gelu_whisper_decoder", "gelu", False,
                    1728, 4096, 9)]


#: Phase 15 (bfloat16).  gemma3-27b whole (62 layers): 2 prompts of 4096
#: tokens, ring caches for the local layers; and cut to 12 layers (two 5:1
#: groups) for the float32 comparison.
BF16_ARCH, BF16_PROMPT, BF16_CMP_LAYERS = "gemma3-27b", 4096, 12
#: the kernels' bfloat16 logits against the plain path's, by depth: at each
#: step at most this share of the plain path's largest |logit|.  At 12
#: layers between the kernels' largest reading (0.00190) and the float32
#: run's (0.00259), which must fail it; at 62 layers 1.28 x the kernels'
#: (0.00977).  The plain path with P rounded to bfloat16 lands at the
#: kernels' distance at both depths (0.00167, 0.0100): the model's own
#: bfloat16 rounding hides a one-rounding change, which the rows and the
#: per-call holds (``held_calls``) reject instead (PERF.md §6)
BF16_SERVE_BAR = {12: 0.0022, 62: 0.0125}
#: decode steps traced for the whole model's busy share (each step of 62
#: layers adds some 3 s of trace processing)
BF16_BUSY_STEPS = 4
#: at 12 layers: the kernels' bfloat16 distance from the float32 kernels
#: on the same (upcast) weights, at most this times the plain path's
BF16_VS_F32_RATIO = 1.5
#: gemma2-2b whole trained in bfloat16 through the Trainer: steps, then
#: (seq_len, global batch, microbatches)
BF16_TRAIN_ARCH, BF16_TRAIN_STEPS, BF16_TRAIN_SHAPE = "gemma2-2b", 6, (256, 8, 2)
#: step 1 on the kernels against the plain path, both in bfloat16: the
#: loss between the kernels' reading (2.8e-5) and the control's (the plain
#: path with P rounded to bfloat16, 9.1e-5), which must fail it; the
#: gradient norm and the worst leaf a few times the kernels' (1.4e-5,
#: 1.2e-3), where the control reads no more (1.8e-6, 1.6e-3)
BF16_TRAIN_TOL = {"loss": 5e-5, "grad_norm": 5e-5, "leaf_grad_norm": 3e-3}
#: a leaf whose move exceeds the leaf bar is held at this many times its
#: move under the plain path with its norms rounded once more
#: (``rounded_rmsnorm``), as phase 12's ``SSD_LEAF_FLOOR``
BF16_LEAF_FLOOR = 4
#: below this, bfloat16 outputs are held absolutely (float32's own error
#: where a result cancels: gelu's tail)
BF16_ATOL = 1e-5
#: a bfloat16 kernel row: every element within one bfloat16 step of the
#: plain version and at most this share of them on another bfloat16 value.
#: A kernel that computes the plain version's float32 result up to a few
#: ulps rounds it to the same value but where it lies that close to a
#: rounding boundary (the rows: at most 7.0e-4 apart); a function one
#: rounding away (P rounded to bfloat16, 1 + w rounded, an activation in
#: bfloat16 arithmetic) moves 17.6-49 % of them (SDPA 40 %)
BF16_SHARE_BAR = 0.01
#: Phase 15's rows in bfloat16, as phase 5's (``dense_rows``): rmsnorm
#: (suffix, d, tokens) at gemma3's prefill and decode and gemma2's
#: prefill; GeGLU and GELU (name, kind, gated, tokens, d_ff, operations an
#: element) at gemma3's and gemma2's; kernel 4 (tag, B, Hq, Hkv, S,
#: window, Dh, softcap), causal: gemma3's local and global layers and
#: gemma2's
BF16_RMS_ROWS = [(".bf16_gemma3_d5376", 5376, 8192),
                 (".bf16_gemma3_decode", 5376, 2),
                 (".bf16_gemma2_d2304", 2304, 9216)]
BF16_EW_ROWS = [("tdp_gathered.gated.bf16_gemma3_geglu", "geglu", True, 8192,
                 21504, 10),
                ("tdp_gathered.gated.bf16_gemma2_geglu", "geglu", True, 9216,
                 9216, 10),
                ("tdp_gathered.act.bf16_gemma2_gelu", "gelu", False, 9216,
                 9216, 9)]
BF16_ATTN_ROWS = [("bf16_gemma3_local", 2, 32, 16, 4096, 1024, 128, 0.0),
                  ("bf16_gemma3_attn", 2, 32, 16, 4096, 0, 128, 0.0),
                  ("bf16_gemma2_local", 2, 8, 4, 4608, 4096, 256, 50.0),
                  ("bf16_gemma2_attn", 2, 8, 4, 4608, 0, 256, 50.0)]
#: bfloat16 peak of the tensor cores, dense (data sheet)
PEAK_BF16_PER_S = 989e12
#: kernel 4's bound in bfloat16: seconds an operation of (q·k, p·v).  q·k
#: on bfloat16 operands is exact in one bfloat16 ``mma``; p·v keeps P in
#: float32 (the reference casts P to V's float32 copy), at the cheaper
#: float32-faithful split: three bfloat16 pieces of P or two TF32 halves
BF16_ATTN_PER_FLOP = (1 / PEAK_BF16_PER_S,
                      min(3 / PEAK_BF16_PER_S, 2 / PEAK_TF32_PER_S))

#: the bfloat16 scan's absolute floor: its y sums N products h·c that can
#: be far larger than y, so near y = 0 the float32 results of the kernel
#: and its plain version lie a float32 error of those products apart (up to
#: ~1e-4), more than ``BF16_ATOL``; the float32 scan's row is held at
#: ``LM_TOL``'s atol, which this is
BF16_SCAN_ATOL = LM_TOL["atol"]
#: Phase 16 (bfloat16 for the Mamba, MoE, MLA and whisper families,
#: A7.1b), each family from seeded bfloat16 weights at full width: (arch,
#: layers served on the kernels, layers at which every kernel call and the
#: logits are held to the plain path, prompts, prompt tokens); None is the
#: model's own depth.  falcon-mamba's plain scan takes 0.93 s a layer, so
#: it is held at 8 of its 64 layers; zamba2 at 12 of 54 (two uses of the
#: tied block), where its bfloat16 roundings have not yet spread its
#: logits by a sixth as at 54; deepseek is served at phase 13's 4 of 61
#: (its first MoE layer among them)
BF16F_SERVE = [("falcon-mamba-7b", None, 8, SERVE_BATCH, MAMBA_PROMPT),
               ("zamba2-2.7b", None, 12, SERVE_BATCH, SSD_PROMPT),
               ("granite-moe-1b-a400m", None, None, SERVE_BATCH, MOE_PROMPT),
               ("deepseek-v3-671b", MLA_SERVE_LAYERS, MLA_SERVE_LAYERS,
                SERVE_BATCH, MLA_PROMPT),
               ("whisper-medium", None, None, WHISPER_BATCH, WHISPER_PROMPT)]
#: the kernels' bfloat16 logits against the plain path's at the held
#: depth, at each step a share of the plain path's largest |logit|: 1.4 ×
#: the kernels' largest reading (falcon-mamba × 8 0.0193, zamba2 × 12
#: 0.0537, granite 0.0601, deepseek × 4 0.0566, whisper 0.0119).  A
#: rounding placed elsewhere on the plain path lands as far (P rounded to
#: bfloat16: 0.0172 / 0.0449 / 0.0556 / 0.0119; falcon-mamba's dt not
#: rounded: 0.0212): these models' own bfloat16 noise hides it end to end,
#: as phase 15 found, so the per-call holds (``held_calls``) and the rows
#: are what reject such a kernel (PERF.md §6)
BF16F_SERVE_BAR = {"falcon-mamba-7b": 0.027, "zamba2-2.7b": 0.075,
                   "granite-moe-1b-a400m": 0.085, "deepseek-v3-671b": 0.08,
                   "whisper-medium": 0.017}
#: the families trained in bfloat16 from seeded bfloat16 weights, each at
#: its float32 phase's depth and shape: (arch, layers (None: the model's
#: own), layers at which step 1 is held to the plain path, (seq_len, global
#: batch, microbatches), 8-bit moments, steps).  zamba2 is held at 12 of
#: its 54 layers (two uses of the tied block), as phase 16 serves it: whole,
#: any one-rounding change of its plain path moves its bfloat16 step-1
#: leaves by up to 13-30 % and the global norm by 2-3.7 % (PERF.md §6).
#: falcon-mamba-7b at its first 4 layers (``BF16_TRAIN_SHAPE``); zamba2 and
#: granite whole (phases 12, 11); deepseek-v3 at its first 3 layers and its
#: MTP module with 8-bit moments (phase 13); whisper-medium whole through
#: ``build_train_step`` (phase 14).  At least 3 steps: a median from step 2
BF16F_TRAINS = [
    ("falcon-mamba-7b", 4, 4, BF16_TRAIN_SHAPE, False, 4),
    (SSD_ARCH, None, 12, (256, 8, 1), False, 3),
    (MOE_ARCH, None, None, (256, 8, 1), False, 3),
    (MLA_ARCH, 3, 3, (256, 8, MLA_TRAIN_ACCUM), True, 3),
    (WHISPER_ARCH, None, None, (WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH,
                                WHISPER_TRAIN_ACCUM), False, 3)]
#: the families whose step-1 hold is widened, and how: each because the
#: plain path with its norms rounded once more (``rounded_rmsnorm``,
#: ``rounded_layernorm``) moves its gradients further than the bars set on
#: gemma2 (phase 15) allow.  ``"grad_norm"``: the global gradient norm held at
#: ``BF16_LEAF_FLOOR`` × that move where this is above ``BF16_TRAIN_TOL``
#: (the move: zamba2 × 12 2.0e-3, granite 2.9e-4, whisper 1.06e-4; the
#: kernels 4.5e-3, 1.6e-4, 1.3e-4; the bar 5e-5).  ``"pooled"``: a leaf's
#: floor the largest move of its kind (``leaf_kind``) under that rounding,
#: not its own, one sample of a rounding that a chaotic backward scatters
#: over the layers (on their own floors zamba2 × 12 fails 26 leaves,
#: whisper 3 — wq/wk, at 1.1-1.8× their bars; granite none).  falcon-mamba
#: and deepseek keep the bars as set (PERF.md §6)
BF16F_TRAIN_WIDE = {SSD_ARCH: ("grad_norm", "pooled"),
                    MOE_ARCH: ("grad_norm",),
                    WHISPER_ARCH: ("grad_norm", "pooled")}
#: the families whose step-1 hold must reject kernel 4's gradient as the
#: reference's chunked oracle computes it (``chunked_backward``: the
#: softmax jacobian's diagonal term from the bfloat16 output), the route
#: the kernels took before their backward rounded as the plain version's
#: does: it puts 76 of whisper's leaves over the bar, up to 4.1 % apart.
#: zamba2's (× 12), granite's and deepseek's holds pass it (it moves their
#: global norms 4.5e-3, 1.1e-4, 3.1e-5 from the plain path's, the kernels
#: 4.5e-3, 1.6e-4, 3.9e-5): there ``BF16F_ATTN_GRADS`` rejects it
BF16F_TRAIN_CONTROL = (WHISPER_ARCH,)
#: kernel 4's bfloat16 gradient against the plain version's autograd at
#: each family's training microbatch (tag, B, Hq, Hkv, Sq, Sk, Dh, causal):
#: dq, dk, dv at most ``BF16_SHARE_BAR`` of their elements apart, where
#: ``chunked_backward`` must put more apart
BF16F_ATTN_GRADS = [("granite", 8, 16, 8, 256, 256, 64, True),
                    ("zamba2", 8, 32, 32, 256, 256, 80, True),
                    ("deepseek", 4, 128, 128, 256, 256, 192, True),
                    ("whisper_encoder", 4, 16, 16, 1500, 1500, 64, False),
                    ("whisper_decoder", 4, 16, 16, 448, 448, 64, True),
                    ("whisper_cross", 4, 16, 16, 448, 1500, 64, False)]
#: the bfloat16 ``mamba`` row: falcon-mamba-7b's layer (batch, L, d_inner,
#: d_state), both rows in one launch
BF16F_MAMBA = (SERVE_BATCH, MAMBA_PROMPT, 8192, 16)
#: kernel 4's bfloat16 rows (tag, B, Hq, Hkv, Sq, Sk, Dh, causal): granite's
#: layer, whisper's encoder, decoder and cross attentions, zamba2's shared
#: block, deepseek's MLA
BF16F_ATTN_ROWS = [("bf16_granite", 2, 16, 8, 4096, 4096, 64, True),
                   ("bf16_whisper_encoder", 4, 16, 16, 1500, 1500, 64, False),
                   ("bf16_whisper_decoder", 4, 16, 16, 432, 432, 64, True),
                   ("bf16_whisper_cross", 4, 16, 16, 432, 1500, 64, False),
                   ("bf16_zamba2", 2, 32, 32, 4096, 4096, 80, True),
                   ("bf16_deepseek", 2, 128, 128, 4096, 4096, 192, True)]
#: launches of the plain version timed a row (deepseek's takes ~0.1 s)
BF16F_ATTN_PLAIN_REPS = 5
#: kernel 4's bfloat16 checks at every head dim: (B, Hq, Hkv, Sq, Sk,
#: keywords) — ragged tiles with GQA, a window with a softcap, non-causal
#: Sq ≠ Sk
BF16F_ATTN_CHECKS = [(2, 4, 2, 300, 300, dict(causal=True)),
                     (1, 4, 1, 200, 200, dict(causal=True, window=64,
                                              softcap=30.0)),
                     (1, 2, 2, 92, 348, dict(causal=False))]
#: the bfloat16 scan's checks (batch, L, d_inner, d_state): ragged chunks
#: and channel blocks, n a multiple of 8 (16-byte copies) and not
BF16F_MAMBA_CHECKS = [(1, 77, 1000, 16), (3, 45, 301, 8), (2, 64, 256, 16)]
#: Phase 17, bfloat16 in the LB and example kernels: the examples' a (not a
#: bfloat16: its weak rounding shows), the lattice and steps at which each
#: regime is held to the plain path on the card, and the timed launches of
#: the plain versions (their bfloat16 bodies are long sequences of
#: launches).
LB_BF16_A = 0.1
LB_BF16_CHECK_GRID, LB_BF16_CHECK_STEPS = (32, 32, 32), 10
LB_BF16_PLAIN_REPS = 5


#: the script's start: every log line carries the seconds since it, which
#: is how the phases' shares of the time limit are read
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def ptxas_report(logs: dict) -> list[dict]:
    """Registers and spills per compiled kernel, from ``-Xptxas -v``."""
    rows = []
    for lib, path in logs.items():
        entry = None
        for line in path.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                if lib == "flash_attention":
                    dh = re.search(r"flash_fwd_kernelILi(\d+)E", name)
                    entry = {"lib": lib, "site": "flash_attention",
                             "head_dim": int(dh.group(1)) if dh else None,
                             "dtype": "bf16" if "bf16" in name else "f32"}
                elif lib == "tdp_gathered_example":
                    site = re.search(r"ex\d+(\w+?)Site", name)
                    vvl = re.search(r"Li(\d+)E", name)
                    op = re.search(r"\d(Sum|Max|Min)Op", name)
                    entry = {"lib": lib, "site": site and site.group(1),
                             "vvl": int(vvl.group(1)) if vvl else None,
                             "mapping": "reduce" if op else "aosoa"
                             if "aosoa" in name else "soa",
                             "dtype": "bf16" if "bf16" in name else "f32"}
                    if op:
                        entry["op"] = op.group(1).lower()
                elif lib == "calibrate":
                    entry = {"lib": lib, "site": "add" if "stream_add" in name
                             else "fma"}
                elif lib == "tdp_gathered_lm":
                    m = re.search(r"lm\d+(\w+?)Site(?:ILi(\d+)EE)?ELi(\d+)E",
                                  name)
                    entry = {"lib": lib,
                             "dtype": "bf16" if "bf16" in name else "f32"}
                    # rmsnorm has two mappings: tiled (per VVL) and few-token
                    if "rms_few" in name:
                        entry.update({"site": "rmsnorm", "mapping": "few"})
                    elif "rms_tiled" in name:
                        entry["mapping"] = "tiled"
                    if m:
                        site = m.group(1).lower()
                        # the template argument is the activation, or the
                        # mamba site function's d_state
                        entry.update({"site": site,
                                      "nstate" if site == "mamba" else "act":
                                      int(m.group(2)) if m.group(2) else None,
                                      "vvl": int(m.group(3))})
                else:
                    site = re.search(r"tdp(?:\d+)(\w+?)Site", name)
                    vvl = re.search(r"Li(\d+)E", name)
                    entry = {"lib": lib,
                             "site": site.group(1) if site else "collide",
                             "vvl": int(vvl.group(1)) if vvl else None,
                             "dtype": "bf16" if "bf16" in name else "f32"}
                    if "fused_tile_kernel" in name:
                        entry.update({"site": "Fused", "mapping": "tile"})
                    elif "fused_tile_ensemble_kernel" in name:
                        entry.update({"site": "Fused",
                                      "mapping": "tile_ensemble"})
                    elif "ensemble_kernel" in name:
                        entry["mapping"] = "ensemble"
                rows.append(entry)
                continue
            if entry is None:
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                entry["spill_stores"] = int(m.group(1))
                entry["spill_loads"] = int(m.group(2))
    return rows


def time_ms(fn, reps: int = 20, warmup: int = 3,
            hold: int = HOLD_CYCLES) -> float:
    """Median device time of one launch of ``fn`` over ``reps`` launches,
    each between two CUDA events.

    A spin kernel holds the stream while the host enqueues every launch, so
    the events bracket device work only and not the Python dispatch of the
    wrapper (which, on an idle card, would otherwise land between an event
    and its kernel).  The spin lasts ``HOLD_MARGIN`` times the longest
    time a warm-up call took to return (the host's time a call, or more
    where it waited on the card) for all ``reps`` calls, at least
    ``HOLD_FLOOR`` and at most ``hold`` cycles.  If the host took longer to
    enqueue them than the spin can have lasted (at the boost clock), the
    launches are timed again under the full ``hold``."""
    host_s = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = hold
    if warmup:
        cycles = min(hold, max(HOLD_FLOOR, int(
            HOLD_MARGIN * reps * host_s * SPIN_CLOCK_HZ)))
    while True:
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(reps + 1)]
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        events[0].record()
        for i in range(reps):
            fn()
            events[i + 1].record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        TIMED["calls"] += 1
        if cycles >= hold or enqueue_s < cycles / SPIN_CLOCK_HZ:
            return statistics.median(a.elapsed_time(b)
                                     for a, b in zip(events, events[1:]))
        TIMED["retimed"] += 1
        cycles = hold


def wall_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Median wall time of one call of ``fn`` over ``reps`` calls, each
    between two ``torch.cuda.synchronize()``: for a host-bound function
    whose Python dispatch no spin kernel can cover."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous tensor at a storage offset of one
    float, as a slice of a larger buffer is: its rows fit no vector access,
    so a kernel takes its scalar path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def max_abs(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def compare(site: str, got, want, what: str, problems: list) -> None:
    """Kernel outputs against the plain version's: ``stream`` is a pure copy
    and must be bit-exact, every other site function is held at ``rtol=1e-5,
    atol=1e-6`` (FMA contraction and summation order differ)."""
    ok = all(torch.isfinite(g).all() and (
        torch.equal(g, w) if site == "stream"
        else torch.allclose(g, w, rtol=1e-5, atol=1e-6))
        for g, w in zip(got, want))
    if not ok:
        problems.append(f"{what}: max |kernel - plain| = {max_abs(got, want)}")


def bound(site: str, nsites: int) -> tuple[float, str]:
    t_bytes = BYTES_PER_SITE[site] * nsites / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_SITE[site] * nsites / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(site: str, prepared, n: int, batch: int | None = None):
    """One PyTorch call that computes ``site`` on the kernels' own inputs,
    as ``(call, split)``: ``call()`` is what is timed and ``split`` turns
    its result into the kernel's ``(ncomp, n)`` outputs for the comparison.
    ``None`` where no single call computes the function.

    Both executors take a stencil field as its ``(ncomp, X, Y, Z)`` grid,
    wrapped periodically: the stencil functions are 3×3×3 correlations with
    fixed one-hot or difference filters, one ``nn.Conv3d`` with circular
    padding each.  With ``batch``, the operands of an ensemble launch
    (``(batch, ncomp, ...)``): the convolution takes the members as its
    batch, ``moment`` sums over axis 1, and the outputs are ``(batch,
    ncomp, n)``.
    """
    from repro_torch.kernels.lb_collision import CV

    x = prepared[0]
    dev = x.device
    lead = () if batch is None else (batch,)
    if site == "moment":
        return (lambda: x.sum(len(lead))), (lambda o: (o.reshape(*lead, 1, n),))

    def conv(w, groups=1):
        m = torch.nn.Conv3d(w.shape[1] * groups, w.shape[0], 3, padding=1,
                            padding_mode="circular", bias=False,
                            groups=groups).to(dev, dtype=x.dtype)
        m.weight.data.copy_(torch.from_numpy(w))
        m.requires_grad_(False)
        return lambda: m(x if lead else x[None])

    if site == "grad6":
        # rows ∇φ_x, ∇φ_y, ∇φ_z, ∇²φ over the 6-point star
        w = np.zeros((4, 3, 3, 3), np.float32)
        for d in range(3):
            e = np.eye(3, dtype=int)[d]
            w[(d, *(1 + e))] = 0.5
            w[(d, *(1 - e))] = -0.5
            w[(3, *(1 + e))] = w[(3, *(1 - e))] = 1.0
        w[3, 1, 1, 1] = -6.0

        def split(o):
            o = o.reshape(*lead, 4, n)
            return o[..., :3, :], o[..., 3:, :]
        return conv(w[:, None]), split
    if site in ("stream", "phi_stream"):
        # population q at site x comes from x - c_q: tap 1 - c_q
        w = np.zeros((19, 3, 3, 3), np.float32)
        for q, c in enumerate(CV.astype(int)):
            w[(q, *(1 - c))] = 1.0
        if site == "stream":
            return conv(w[:, None], groups=19), (
                lambda o: (o.reshape(*lead, 19, n),))
        return conv(w[None]), (lambda o: (o.reshape(*lead, 1, n),))
    return None


def attn_live_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs live under the masks — the work the inputs need."""
    q = np.arange(sq)
    hi = np.minimum(q + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def attn_bound(b, hq, hkv, sq, sk, dh, causal, window, *, split=None,
               elem_bytes=4, per_flop=None) -> tuple[float, str]:
    """2·Dh operations per live pair for q·k and as many for p·v: against
    the float32 peak of the CUDA cores, with ``split`` as that many TF32
    products on the tensor cores (3 for 3xTF32), or at ``per_flop``
    (seconds an operation of q·k, of p·v); q/k/v read and o written once,
    ``elem_bytes`` an element, against the memory rate."""
    flops = 2 * dh * b * hq * attn_live_pairs(sq, sk, causal, window)
    if per_flop is None:
        c = 1 / PEAK_F32_PER_S if split is None else split / PEAK_TF32_PER_S
        per_flop = (c, c)
    nbytes = elem_bytes * dh * (2 * b * hq * sq + 2 * b * hkv * sk)
    t_ops = flops * sum(per_flop) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lm_library_call(name: str, xs, consts):
    """One PyTorch call computing the LM kernel ``name`` on the kernel's own
    inputs, as ``(call, to_kernel_layout)``; ``None`` where none does.
    ``F.rms_norm`` reduces over the last axis, so it takes the (tokens, d)
    view of the kernel's (d, tokens) input, with the weight ``w + offset``
    formed once outside the timed call."""
    import torch.nn.functional as F
    if name.startswith("tdp_gathered.rmsnorm"):
        x = xs[0]
        w1 = consts["weight"] + consts["scale_offset"]
        return ((lambda: F.rms_norm(x.T, (x.shape[0],), weight=w1,
                                    eps=consts["eps"])),
                (lambda o: (o.T,)))
    if name == "tdp_gathered.act" or name.startswith("tdp_gathered.act.gelu"):
        return ((lambda: F.gelu(xs[0], approximate="tanh")),
                (lambda o: (o,)))
    return None


def lm_checks(problems: list, max_err: dict) -> None:
    """Phase 3, LM half: each LM kernel against its plain version."""
    from repro_torch.kernels import flash_attention, ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    err = 0.0
    for case in ATTN_CASES + [("views", c) for c in ATTN_VIEW_CASES]:
        views = case[0] == "views"
        b, hq, hkv, sq, sk, dh, causal, window, softcap = case[-1] if views else case
        if views:   # (B, S, H, Dh) tensors seen as (B, H, S, Dh)
            q = torch.randn(b, sq, hq, dh, device=dev, generator=g).transpose(1, 2)
            k, v = (torch.randn(b, sk, hkv, dh, device=dev,
                                generator=g).transpose(1, 2) for _ in range(2))
        else:
            q = torch.randn(b, hq, sq, dh, device=dev, generator=g)
            k = torch.randn(b, hkv, sk, dh, device=dev, generator=g)
            v = torch.randn(b, hkv, sk, dh, device=dev, generator=g)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = flash_attention.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, **kw)
        e = float((got - want).abs().max())
        err = max(err, e)
        if not (torch.isfinite(got).all() and torch.allclose(got, want, **LM_TOL)):
            problems.append(f"flash_attention {case}: max |kernel - plain| = {e}")
        if got.stride() != q.stride():
            problems.append(f"flash_attention {case}: o has strides "
                            f"{got.stride()}, q {q.stride()}")
        log(f"phase 3: flash_attention {case} max_abs_err={e}")
        del q, k, v, got, want
    max_err["flash_attention"] = err
    torch.cuda.empty_cache()

    for n, d in RMS_CHECKS:
        x = torch.randn(n, d, device=dev, generator=g)
        w = torch.randn(d, device=dev, generator=g)
        want = ref.rmsnorm_ref(x, w, scale_offset=1.0)
        for vvl in (1, 2, 4, 8):
            got = ops.rmsnorm(x, w, vvl=vvl, scale_offset=1.0)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            max_err["tdp_gathered.rmsnorm"] = max(
                max_err.get("tdp_gathered.rmsnorm", 0.0), e)
            if not torch.allclose(got, want, **LM_TOL):
                problems.append(f"rmsnorm ({n}, {d}) vvl={vvl}: {e}")
    u = 3.0 * torch.randn(SERVE_BATCH * SERVE_PROMPT, 9216, device=dev, generator=g)
    v = torch.randn_like(u)
    for kind in ("swiglu", "silu", "geglu", "gelu", "relu2"):
        for gated in (True, False):
            name = "tdp_gathered.gated" if gated else "tdp_gathered.act"
            want = ref.gated_act_ref(u, v if gated else None, kind=kind)
            for vvl in (1, 2, 4, 8):
                got = ops.gated_act(u, v if gated else None, kind=kind, vvl=vvl)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                max_err[name] = max(max_err.get(name, 0.0), e)
                if not torch.allclose(got, want, **LM_TOL):
                    problems.append(f"{name} {kind} vvl={vvl}: {e}")
                del got
            del want
    del u, v
    # operands at a storage offset of one element (only 4-byte aligned) and
    # a ragged extent: the scalar path of the elementwise kernel
    n = UNALIGNED_N
    ub, vb = (torch.randn(n + 1, device=dev, generator=g) for _ in range(2))
    u, v = ub[1:].mul_(3.0), vb[1:]
    if u.data_ptr() % 16 == 0 or v.data_ptr() % 16 == 0:
        problems.append("the unaligned gated/act case is aligned")
    for kind in ("swiglu", "silu", "geglu", "gelu", "relu2"):
        for gated in (True, False):
            name = "tdp_gathered.gated" if gated else "tdp_gathered.act"
            want = ref.gated_act_ref(u, v if gated else None, kind=kind)
            for vvl in (1, 2, 4, 8):
                got = ops.gated_act(u, v if gated else None, kind=kind, vvl=vvl)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                max_err[name] = max(max_err.get(name, 0.0), e)
                if not torch.allclose(got, want, **LM_TOL):
                    problems.append(f"{name} {kind} unaligned n={n} "
                                    f"vvl={vvl}: {e}")
    del u, v, ub, vb
    for kind, gated, ntok, nff in DENSE_EW_CHECKS:
        name = "tdp_gathered.gated" if gated else "tdp_gathered.act"
        u = 3.0 * torch.randn(ntok, nff, device=dev, generator=g)
        v = torch.randn_like(u) if gated else None
        want = ref.gated_act_ref(u, v, kind=kind)
        for vvl in (1, 2, 4, 8):
            got = ops.gated_act(u, v, kind=kind, vvl=vvl)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            max_err[name] = max(max_err.get(name, 0.0), e)
            if not torch.allclose(got, want, **LM_TOL):
                problems.append(f"{name} {kind} ({ntok}, {nff}) vvl={vvl}: "
                                f"{e}")
            del got
        del u, v, want
    log(f"phase 3: LM site functions max_abs_err={max_err}")
    torch.cuda.empty_cache()

    err = 0.0
    for case in MAMBA_CASES:
        b, length, di, n = case
        x = torch.randn(b, length, di, device=dev, generator=g)
        dt = torch.nn.functional.softplus(
            torch.randn(b, length, di, device=dev, generator=g))
        bb, cc = (torch.randn(b, length, n, device=dev, generator=g)
                  for _ in range(2))
        a = -torch.exp(torch.randn(di, n, device=dev, generator=g))
        d = torch.ones(di, device=dev)
        want = ops.mamba_scan(x, dt, bb, cc, a, d, target="torch")
        for vvl in (1, 2, 4, 8):
            got = ops.mamba_scan(x, dt, bb, cc, a, d, vvl=vvl)
            torch.cuda.synchronize()
            e = max_abs(got, want)
            err = max(err, e)
            if not all(torch.isfinite(o).all() and torch.allclose(o, w, **LM_TOL)
                       for o, w in zip(got, want)):
                problems.append(f"mamba {case} vvl={vvl}: max |kernel - plain| "
                                f"= {e}")
            del got
        log(f"phase 3: mamba {case} max_abs_err={err}")
        del x, dt, bb, cc, a, d, want
    max_err["tdp_gathered.mamba"] = err
    torch.cuda.empty_cache()


def serve_run(params, cfg, backend: str, batch, drive=None, *,
              local_ring=False, tag="", attn_impl="ref"):
    """Prefill ``batch`` + ``SERVE_DECODE`` greedy decode steps through
    ``build_serve_steps`` (``local_ring``: window-sized ring caches for the
    ``local`` layers); returns tokens, the logits of every step, and the
    host times (each ending in ``torch.cuda.synchronize()``).  Under
    M-RoPE the decode steps continue the prompt's positions, one past its
    largest, in all three rows.  With ``drive``, the prefill and the decode
    steps each run as one counted path of the main path, named with
    ``tag``.  ``attn_impl``: the plain attention's oracle
    (``ExecContext.attn_impl``)."""
    from repro_torch.models.context import ExecContext
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.steps import build_serve_steps

    pre, dec = build_serve_steps(cfg, ExecContext(backend=backend,
                                                  attn_impl=attn_impl),
                                 max_len=int(batch["tokens"].shape[1])
                                 + SERVE_DECODE, local_ring=local_ring)
    drive = drive or (lambda path, fn: fn())
    out = {"tokens": [], "logits": []}
    last3 = (batch["positions3"][:, :, -1:].amax(0, keepdim=True)
             if "positions3" in batch else None)

    def prefill():
        return pre(params, batch)

    def decode(state):
        tok, caches, length = state
        for i in range(SERVE_DECODE):
            p3 = None if last3 is None else (last3 + 1 + i).expand(3, -1, -1)
            tok, caches, length, logits = dec(params, tok, caches, length,
                                              positions3=p3)
            out["tokens"].append(tok)
            out["logits"].append(logits[:, -1])
        return tok

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches, length, logits = drive(
            f"{cfg.name}{tag} prefill ({backend})", prefill)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["tokens"].append(tok)
        out["logits"].append(logits[:, -1])
        out["cache_dtypes"] = sorted({str(t.dtype)
                                      for t in tree_leaves(caches)})
        drive(f"{cfg.name}{tag} decode x{SERVE_DECODE} ({backend})",
              lambda: decode((tok, caches, length)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out["prefill_ms"] = (t1 - t0) * 1e3
    out["decode_ms_per_step"] = (t2 - t1) * 1e3 / SERVE_DECODE
    return out


def compare_serving(kern: dict, plain: dict, problems: list,
                    what: str) -> dict:
    """Logits of every step within ``SERVE_TOL`` while the token streams
    agree; greedy tokens equal wherever the plain path's top-2 margin
    exceeds the tolerance (a near-tie may go either way: random weights)."""
    steps = []
    for i, (lk, lp, tk, tp) in enumerate(zip(kern["logits"], plain["logits"],
                                             kern["tokens"], plain["tokens"])):
        top2 = torch.topk(lp.float(), 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu()
        diff = float((lk - lp).abs().max())
        # the largest difference the tolerance admits at this step
        tol = SERVE_TOL["atol"] + SERVE_TOL["rtol"] * float(lp.abs().max())
        same = (tk.cpu() == tp.cpu()).reshape(-1)
        steps.append({"step": i, "max_abs_logit_diff": diff,
                      "min_top2_margin": float(margin.min()),
                      "tokens_equal": bool(same.all())})
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            problems.append(f"{what} step {i}: non-finite logits")
        if not torch.allclose(lk, lp, **SERVE_TOL):
            problems.append(f"{what} step {i}: logits differ by {diff}")
        if bool((~same & (margin > 2 * tol)).any()):
            problems.append(f"{what} step {i}: greedy tokens differ where "
                            f"the margin exceeds {2 * tol}")
        if not bool(same.all()):
            break      # the streams parted at a near-tie: stop comparing
    return {"tolerance": SERVE_TOL, "steps": steps}


def vision_inputs(cfg, b: int, s: int, dev) -> dict:
    """The vision stub's inputs for ``b`` prompts of ``s`` tokens: a
    ``DENSE_GRID`` of random patch embeddings a prompt, prompt r's at slot
    ``DENSE_VISION_AT[r]``, and M-RoPE's (t, h, w) positions: text before
    the grid at t = h = w = its index p, the grid's patch (i, j) at (p0, p0
    + i, p0 + j), text after it from p0 + max(grid) on, all three rows
    equal (Qwen2-VL's scheme; three rows that differ, so a wrong section
    map shows)."""
    gh, gw = DENSE_GRID
    n = gh * gw
    pos = np.zeros((3, b, s), np.int64)
    slot = -np.ones((b, s), np.int64)
    i, j = np.divmod(np.arange(n), gw)
    for r in range(b):
        st = DENSE_VISION_AT[r % len(DENSE_VISION_AT)]
        pos[:, r, :st] = np.arange(st)
        pos[0, r, st:st + n] = st
        pos[1, r, st:st + n] = st + i
        pos[2, r, st:st + n] = st + j
        slot[r, st:st + n] = np.arange(n)
        pos[:, r, st + n:] = st + max(gh, gw) + np.arange(s - st - n)
    rng = np.random.default_rng(1)
    return {"vision_embed": torch.from_numpy(rng.standard_normal(
                (b, n, cfg.d_model), dtype=np.float32)).to(dev),
            "vision_slot": torch.from_numpy(slot).to(dev),
            "positions3": torch.from_numpy(pos).to(dev)}


def serve_busy(params, cfg, batch, steps=SERVE_DECODE) -> dict:
    """One more warm run on the kernels, its prefill and its ``steps``
    decode steps each traced by ``torch.profiler``: the
    host wall ms (ending in ``torch.cuda.synchronize()``), the device ms
    (its kernels summed; one stream) and the device's busy share of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.context import ExecContext
    from repro_torch.runtime.steps import build_serve_steps
    pre, dec = build_serve_steps(cfg, ExecContext(backend="cuda"),
                                 max_len=int(batch["tokens"].shape[1])
                                 + SERVE_DECODE)
    out = {}

    def traced(name, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        out[name] = {"wall_ms": wall_ms, "device_ms": us / 1e3,
                     "device_busy_share": us / 1e3 / wall_ms}
        return res

    def decode(tok, caches, length):
        for _ in range(steps):
            tok, caches, length, _ = dec(params, tok, caches, length)
        return tok

    with torch.inference_mode():
        tok, caches, length, _ = traced("prefill", lambda: pre(params, batch))
        traced(f"decode x{steps}",
               lambda: decode(tok, caches, length))
    return out


def serve_model(cfg, prompt_len: int, drive, problems: list, *,
                ring: bool = False, device="cuda", batch_size=SERVE_BATCH,
                busy: bool = False) -> dict:
    """Phase 4 (and 10, 12, 14) for one model: built at full width from
    seeded random float32 weights, served through the kernels (counted),
    again through the plain path (counted) and once more through the
    kernels, warm (timed); the logits and tokens compared; with ``ring``,
    served once more on ring caches for the ``local`` layers (counted), its
    tokens held to the first run's; with ``busy``, once more under the
    profiler (``serve_busy``); weights and caches freed after.
    ``batch_size`` prompts of ``prompt_len`` random token ids, for an
    encoder–decoder model each with ``n_frames`` random audio frames."""
    from repro_torch.models import params as model_params
    dev = torch.device(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mparams = model_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch_size, prompt_len))).to(dev)}
    if cfg.is_encdec:
        batch["audio_embed"] = torch.from_numpy(rng.standard_normal(
            (batch_size, cfg.encoder.n_frames, cfg.d_model),
            dtype=np.float32)).to(dev)
    if cfg.vision_stub:
        batch.update(vision_inputs(cfg, batch_size, prompt_len, dev))
    served = serve_run(mparams, cfg, "cuda", batch, drive=drive)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain_served = serve_run(mparams, cfg, "torch", batch, drive=drive)
    warm = serve_run(mparams, cfg, "cuda", batch)
    serving = compare_serving(served, plain_served, problems, cfg.name)
    serving.update(params=cfg.num_params(), layers=cfg.n_layers,
                   init_params_s=init_s, prompt=[batch_size, prompt_len],
                   decode_steps=SERVE_DECODE, peak_memory_gb_kernels=peak_gb)
    runs = [("kernels_first_run", served), ("kernels_warm", warm),
            ("plain", plain_served)]
    if ring:
        ringed = serve_run(mparams, cfg, "cuda", batch, drive=drive,
                           local_ring=True, tag=" ring")
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(ringed["logits"], served["logits"]))
        same = all(torch.equal(a, b) for a, b in zip(ringed["tokens"],
                                                     served["tokens"]))
        serving["ring_cache"] = {"tokens_equal": same,
                                 "max_abs_logit_diff_vs_full": diff}
        if not same:
            problems.append(f"{cfg.name}: decode on ring caches gave other "
                            f"tokens than on full caches")
        runs.append(("kernels_ring", ringed))
    for name, run in runs:
        serving[name] = {
            "prefill_ms": run["prefill_ms"],
            "prefill_tokens_per_s": batch_size * prompt_len / run["prefill_ms"] * 1e3,
            "decode_ms_per_step": run["decode_ms_per_step"],
            "decode_tokens_per_s": batch_size / run["decode_ms_per_step"] * 1e3}
    if warm["tokens"] and not all(torch.equal(a, b) for a, b in
                                  zip(warm["tokens"], served["tokens"])):
        problems.append(f"{cfg.name}: the warm run's tokens differ from the "
                        f"first")
    if busy:
        serving["device_busy"] = serve_busy(mparams, cfg, batch)
    del mparams, served, plain_served, warm, batch
    torch.cuda.empty_cache()
    print(json.dumps({"serving": {cfg.name: {k: v for k, v in serving.items()
                                             if k != "steps"}}}), flush=True)
    return serving


def lm_row(name, kernel_info, launch_key, kern, plain, lib, bound_ms_by,
           launches, launches_by_path, max_err, problems, record, *,
           max_err_key=None, plain_reps=20, plain_wall=False, close=None,
           readings=None, control=None, hold_library=True,
           hold=HOLD_CYCLES) -> dict:
    """Phase 5 for one LM kernel: held to its plain version (and the library
    call to the plain version), then timed beside both and its bound; the
    plain version over ``plain_reps`` launches, by device time or, with
    ``plain_wall``, by wall clock (``plain_timing`` in the row).  ``close``
    (got, want) → bool holds each output, by default finite and within
    ``LM_TOL``; ``readings`` (got, want) → dict is recorded for the kernel,
    the library call and ``control``: another function on the same inputs,
    which must fail ``close``.  ``hold_library=False`` records the library
    call's distance without holding it.  ``hold``: ``time_ms``'s spin."""
    def as_tuple(out):
        return (out,) if isinstance(out, torch.Tensor) else tuple(out)

    def held(outs, want):
        return all(close(a, b) for a, b in zip(outs, want))

    def measure(outs, want):
        if readings is None:
            return {}
        rs = [readings(a, b) for a, b in zip(outs, want)]
        return {k: max(r[k] for r in rs) for k in rs[0]}
    close = close or (lambda a, b: bool(torch.isfinite(a).all()
                                        and torch.allclose(a, b, **LM_TOL)))
    got, want = as_tuple(kern()), as_tuple(plain())
    torch.cuda.synchronize()
    err = max_abs(got, want)
    check = {"max_abs_err": err, **measure(got, want)}
    if not held(got, want):
        problems.append(f"{name} full width: max |kernel - plain| = {err} "
                        f"{check}")
    key = max_err_key or name
    max_err[key] = max(max_err.get(key, 0.0), err)
    del got
    library_ms = lib_err = None
    if lib is not None:
        lib_out = lib[1](lib[0]())
        torch.cuda.synchronize()
        lib_err = max_abs(lib_out, want)
        check["library"] = {"max_abs_err": lib_err, **measure(lib_out, want),
                            "held": held(lib_out, want)}
        if hold_library and not check["library"]["held"]:
            problems.append(f"library call for {name}: max |library - plain| "
                            f"= {lib_err}")
        del lib_out
    if control is not None:
        ctl = as_tuple(control())
        check["control"] = {"max_abs_err": max_abs(ctl, want),
                            **measure(ctl, want), "held": held(ctl, want)}
        if check["control"]["held"]:
            problems.append(f"{name}: the control passes the bar the kernel "
                            f"is held to ({check['control']})")
        del ctl
    del want
    torch.cuda.empty_cache()
    ms = time_ms(kern, hold=hold)
    plain_ms = (wall_ms(plain, reps=plain_reps) if plain_wall else
                time_ms(plain, reps=plain_reps, warmup=min(3, plain_reps),
                        hold=hold))
    if lib is not None:
        library_ms = time_ms(lib[0], hold=hold)
    b_ms, b_by = bound_ms_by
    record.setdefault("checks_full_width", {})[name] = {
        **check, "library_max_abs_err": lib_err}
    log(f"phase 5: {name} ms={ms:.4f} plain={plain_ms:.4f} library={library_ms}"
        f" bound={b_ms:.4f} {json.dumps(check)}")
    return {"name": name, "route": "cuda", **kernel_info,
            "launches": launches[launch_key],
            "launches_by_path": launches_by_path[launch_key],
            "max_abs_err": max_err[key], "ms": ms, "plain_ms": plain_ms,
            "plain_reps": plain_reps,
            "plain_timing": "wall" if plain_wall else "device",
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def fma_chain_rounded(x, k: int):
    """k rungs of fmaf with one rounding each: acc·v + v in float64 (exact
    for v in [1/4, 1): a 48-bit product plus v spans at most 50 bits), then
    rounded to float32."""
    acc, v = x, x.double()
    for _ in range(int(k)):
        acc = (acc.double() * v + v).float()
    return acc


def calibrate_checks(problems: list, max_err: dict) -> None:
    """Phase 3, calibration kernels: ``stream_add`` equal to ``x + y`` and
    ``fma_chain`` within ``FMA_RTOL`` of its plain version, on the
    reference's (16384,) shape at k = 8, on a misaligned view (the scalar
    path) and at the calibration sizes.  At the calibration size the chain
    also runs on v in [1 - 2⁻¹⁰, 1), where it has not converged by k = 1024:
    there it must equal the k-rung fmaf chain bit for bit while one rung
    fewer moves every element by more than ``FMA_RTOL``, so the profile's
    2·k·n flops were all done."""
    from repro_torch.core.costmodel import CUDA_SIZES
    from repro_torch.kernels import calibrate as cal
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    err = 0.0
    for n in (1 << 14, CUDA_SIZES["add_n"]):
        x, y = (torch.empty(n, device=dev).uniform_(0.25, 0.75, generator=g)
                for _ in range(2))
        for a, b in ((x, y), (x[1:], y[1:])):
            got = cal.stream_add(a, b)
            torch.cuda.synchronize()
            want = cal.stream_add_plain(a, b)
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                problems.append(f"calibrate.add n={a.numel()}: not equal to "
                                f"x + y")
        del x, y, got, want
    max_err["calibrate.add"] = err
    err = 0.0
    for n, k in ((1 << 14, 8), (CUDA_SIZES["fma_n"], CUDA_SIZES["fma_k"])):
        x = torch.empty(n, device=dev).uniform_(0.25, 0.75, generator=g)
        got = cal.fma_chain(x, k)
        torch.cuda.synchronize()
        want = cal.fma_chain_plain(x, k)
        err = max(err, float((got - want).abs().max()))
        if not (torch.isfinite(got).all()
                and torch.allclose(got, want, rtol=cal.FMA_RTOL, atol=0)):
            problems.append(f"calibrate.fma n={n} k={k}: max |kernel - plain|"
                            f" = {err}")
    n, k = CUDA_SIZES["fma_n"], CUDA_SIZES["fma_k"]
    x = torch.empty(n, device=dev).uniform_(1 - 2.0 ** -10, 1.0, generator=g)
    got = cal.fma_chain(x, k)
    torch.cuda.synchronize()
    fewer = fma_chain_rounded(x, k - 1)
    want = (fewer.double() * x.double() + x.double()).float()  # rung k
    step = float(((want - fewer).abs() / want.abs()).min())
    if not torch.equal(got, want):
        problems.append(f"calibrate.fma n={n} k={k} near 1: kernel differs "
                        f"from the k-rung fmaf chain by "
                        f"{float((got - want).abs().max())}")
    if not step > cal.FMA_RTOL:
        problems.append(f"calibrate.fma near 1: one rung fewer moves the "
                        f"result by only {step} (relative)")
    log(f"phase 3: calibrate.fma near 1 equals the {k}-rung chain; one rung "
        f"fewer moves it by >= {step:.3g} (relative)")
    del x, got, want, fewer
    max_err["calibrate.fma"] = err
    log(f"phase 3: calibration kernels max_abs_err add="
        f"{max_err['calibrate.add']} fma={max_err['calibrate.fma']}")
    torch.cuda.empty_cache()


def tuning_path(drive, sims, st0, final_default, params, problems) -> dict:
    """Phase 4, the tuning path at full size: calibrate the card, predict
    every stage of the three LB regimes, tune the 128³ fused program (then
    hit the cache with no measurement), step 20 ``one_launch`` steps under
    the tuned target against the default target's, and tune rmsnorm at
    gemma2's prefill shape.  Returns the record printed as ``{"tuning":
    ...}``."""
    import shutil
    import tempfile
    from repro_torch.core import Lattice, Target, autotune, costmodel, predict
    from repro_torch.core.autotune import wall_clock_timer
    from repro_torch.kernels import lm
    from repro_torch.lb.sim import BinaryFluidSim
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    prof = drive("costmodel.calibrate", costmodel.calibrate)
    sheet = costmodel.MachineProfile.default(prof.device)
    out = {"profile": prof.as_dict(), "data_sheet": sheet.as_dict(),
           "hbm_bw_of_data_sheet": prof.hbm_bw / sheet.hbm_bw,
           "peak_flops_of_data_sheet": prof.peak_flops / sheet.peak_flops}
    log(f"phase 4: calibrated {prof.hbm_bw / 1e12:.3f} TB/s, "
        f"{prof.peak_flops / 1e12:.2f} TFLOP/s")
    out["predictions"] = {
        f"fused={regime}/{name}": predict(exe, profile=prof).as_dict()
        for regime, sim in sims.items() for name, exe in sim.programs.items()}

    def reduce(rep):
        return {"best": rep.best.label, "cache_hit": rep.cache_hit,
                "default_median_s": rep.default_median_s,
                "rank_correlation": rep.rank_correlation,
                "candidates": [{"label": r.candidate.label,
                                "median_s": r.median_s,
                                "predicted_s": r.predicted_s,
                                "predicted_vs_measured":
                                    r.predicted_vs_measured}
                               for r in rep.results],
                "pruned": [{"label": lab, "reason": why}
                           for lab, why in rep.pruned]}

    calls = {"n": 0}

    def counting_timer(tgt, run):
        calls["n"] += 1
        return wall_clock_timer(tgt, run)

    fused = sims["one_launch"].programs["fused"]
    state = {"f": st0.f, "g": st0.g}
    cache = tempfile.mkdtemp(prefix="tuning-")
    try:
        def tune_fused():
            return autotune(fused, example_state=state, top_k=6,
                            measure_steps=1, reps=3, warmup=1,
                            timer=counting_timer, profile=prof,
                            cache_dir=cache)

        tuned, rep = drive("autotune lb_fused_one 128^3", tune_fused)
        measured = calls["n"]
        tuned2, rep2 = drive("autotune lb_fused_one 128^3 (cache)", tune_fused)
        if not rep2.cache_hit or calls["n"] != measured or tuned2 != tuned:
            problems.append(f"autotune cache: hit={rep2.cache_hit}, timer "
                            f"calls {measured} then {calls['n']}")
        space = {"candidates": len(rep.results) + len(rep.pruned),
                 "measured": len(rep.results), "pruned": len(rep.pruned),
                 "aosoa_candidates": sum(
                     "layout=aosoa" in lab for lab in
                     [r.candidate.label for r in rep.results]
                     + [lab for lab, _ in rep.pruned])}
        log(f"phase 4: lb_fused_one space {space}")
        out["lb_fused_one"] = {**reduce(rep), "tuned_target": repr(tuned),
                               "layout": tuned.layout, "space": space,
                               "timer_calls": measured,
                               "second_call": {"cache_hit": rep2.cache_hit,
                                               "timer_calls": calls["n"]
                                               - measured}}
        # how many measured candidates step bit-identically to the base
        ref = fused.run(state, 1)
        same = []
        for r in rep.results:
            exe = fused.program.compile(r.candidate.target_from(fused.target),
                                        grid_shape=GRID)
            got = exe.run(state, 1)
            same.append(all(torch.equal(got[k], ref[k]) for k in ref))
        out["lb_fused_one"]["bit_identical_to_base"] = sum(same)
        log(f"phase 4: tuned {tuned}; {sum(same)} of {len(same)} measured "
            f"candidates bit-identical to the base")
        del ref, got

        if tuned.executor != fused.target.executor:
            problems.append(f"tuned target {tuned} leaves the "
                            f"{fused.target.executor!r} kernels")
        sim_t = BinaryFluidSim(GRID, params, fused="one_launch", target=tuned)
        st_t = drive("BinaryFluidSim one_launch tuned",
                     lambda: sim_t.run(st0, STEPS))
        obs_t, obs_d = (sim_t.observables(s) for s in (st_t, final_default))
        err = max(float((getattr(st_t, k) - getattr(final_default, k))
                        .abs().max()) for k in ("f", "g"))
        out["tuned_vs_default_max_abs"] = err
        if obs_t["nan"] or not all(
                torch.allclose(getattr(st_t, k), getattr(final_default, k),
                               rtol=2e-4, atol=2e-5) for k in ("f", "g")):
            problems.append(f"tuned one_launch run differs from the default's "
                            f"by {err}")
        if not np.isclose(obs_t["mass"], obs_d["mass"], rtol=1e-5, atol=0):
            problems.append(f"tuned run mass {obs_t['mass']} vs "
                            f"{obs_d['mass']}")
        # MLUPS in turns: default, tuned, tuned, default
        nsites = int(np.prod(GRID))
        mlups = {"default": [], "tuned": []}
        for which in ("default", "tuned", "tuned", "default"):
            sim = sims["one_launch"] if which == "default" else sim_t
            sim.run(st0, 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sim.run(st0, STEPS)
            torch.cuda.synchronize()
            mlups[which].append(nsites * STEPS / (time.perf_counter() - t) / 1e6)
        out["mlups_one_launch"] = mlups
        del st_t, sim_t

        # rmsnorm over "cuda" x VVL at gemma2's prefill shape
        d, ntok = 2304, SERVE_BATCH * SERVE_PROMPT
        g = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn(d, ntok, device=dev, generator=g)
        consts = {"weight": torch.randn(d, device=dev, generator=g),
                  "eps": 1e-6, "scale_offset": 1.0}
        rtuned, rrep = drive("autotune rmsnorm_d2304", lambda: autotune(
            lm.rmsnorm_spec(d), Target("cuda", vvl=1), [x],
            lattice=Lattice((ntok,)), consts=consts, executors=("cuda",),
            measure_steps=10, reps=5, warmup=1, profile=prof,
            cache_dir=cache))
        out["rmsnorm_d2304"] = {**reduce(rrep), "tuned_target": repr(rtuned)}
        del x
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 4: the tuning path {out['phase_s']:.1f} s")
    return out


def calibrate_rows(launches, launches_by_path, max_err, problems) -> list:
    """Phase 5, calibration kernels at the calibration sizes: held to their
    plain versions (and ``torch.add`` to the add's), then timed beside
    both and the bound."""
    from repro_torch.core.costmodel import CUDA_SIZES
    from repro_torch.kernels import calibrate as cal
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    n, nf, k = CUDA_SIZES["add_n"], CUDA_SIZES["fma_n"], CUDA_SIZES["fma_k"]
    x, y = (torch.empty(n, device=dev).uniform_(0.25, 0.75, generator=g)
            for _ in range(2))
    v = torch.empty(nf, device=dev).uniform_(0.25, 0.75, generator=g)
    rows = []
    for name, kern, plain, lib, nbytes, flops, plain_reps in (
            ("calibrate.add", lambda: cal.stream_add(x, y),
             lambda: cal.stream_add_plain(x, y), lambda: torch.add(x, y),
             12 * n, n, 20),
            ("calibrate.fma", lambda: cal.fma_chain(v, k),
             lambda: cal.fma_chain_plain(v, k), None, 8 * nf, 2 * k * nf, 5)):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = (torch.equal(got, want) if name == "calibrate.add" else
              torch.allclose(got, want, rtol=cal.FMA_RTOL, atol=0))
        if not ok:
            problems.append(f"{name} calibration size: max |kernel - plain| "
                            f"= {err}")
        max_err[name] = max(max_err.get(name, 0.0), err)
        if lib is not None and not torch.equal(lib(), want):
            problems.append(f"library call for {name} differs from plain")
        del got, want
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=plain_reps, warmup=1)
        library_ms = time_ms(lib) if lib is not None else None
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_PER_S * 1e3
        b_ms, b_by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        key = ("calibrate", name.split(".")[1])
        rows.append({"name": name, "route": "cuda", **KERNELS[name],
                     "launches": launches[key],
                     "launches_by_path": launches_by_path[key],
                     "max_abs_err": max_err[name], "ms": ms,
                     "plain_ms": plain_ms, "plain_reps": plain_reps,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        log(f"phase 5: {name} ms={ms:.4f} plain={plain_ms:.4f} "
            f"library={library_ms} bound={b_ms:.4f} err={err}")
    del x, y, v
    torch.cuda.empty_cache()
    return rows


def face_mask(n: int) -> np.ndarray:
    """The six boundary faces of an n³ grid, flattened: n³ - (n-2)³ sites,
    the halo a decomposed run exchanges (the paper's masked-copy use)."""
    m = np.ones((n,) * 3, bool)
    m[1:-1, 1:-1, 1:-1] = False
    return m.reshape(-1)


def tdp_surface(drive, problems: list) -> dict:
    """Phase 4, the tdp surface at Ludwig's 128³ a device: the paper's
    §III-C call sequence through ``repro_torch.tdp`` (``scale`` at every
    VVL, ``saxpy``, ``site_pos``), ``reduce``, ``launch_stencil`` on the
    card, the masked copies of the 19-component f over the grid's six
    faces, ``target_free``, the Fig. 1 comparison (AoS ``collide_aos`` /
    ``stream_aos`` in plain PyTorch against the SoA kernels and plain
    bodies) and the spinodal example in its three regimes.  Returns the
    record printed as ``{"tdp_surface": ...}``."""
    from repro_torch import tdp
    from repro_torch.examples import lb_spinodal
    from repro_torch.kernels import example_sites as ex
    from repro_torch.lb import baseline, programs, stencil
    from repro_torch.lb.params import LBParams
    from repro_torch.core.target import CUDA_VVLS
    n = int(np.prod(GRID))
    lat = tdp.Lattice(GRID)
    rng = np.random.default_rng(31)
    out: dict = {}

    # the §III-C sequence: target_malloc → copy_to_target →
    # copy_constant_to_target → TARGET_LAUNCH(scale) → sync_target →
    # copy_from_target
    host_x = tdp.Field(lat, TDP_NCOMP, np.float32)
    host_x.data[...] = rng.standard_normal(host_x.array_shape,
                                           dtype=np.float32)
    host_y = tdp.field_like(host_x, rng.standard_normal(
        host_x.array_shape, dtype=np.float32))
    idx = torch.arange(n, dtype=torch.int32, device="cuda")

    def sequence():
        t_out = tdp.target_malloc((TDP_NCOMP, n))
        t_x, t_y = tdp.copy_to_target(host_x), tdp.copy_to_target(host_y)
        a = tdp.copy_constant_to_target(TDP_A)
        errs = {"saxpy": 0.0}
        for vvl in CUDA_VVLS:
            tgt = tdp.Target("cuda", vvl=vvl)
            tdp.launch(ex.SCALE_SPEC, tgt, t_x, lattice=lat, a=a, out=t_out)
            tdp.sync_target(t_out)
            if not torch.equal(t_out, ex.scale_site(t_x, TDP_A)):
                problems.append(f"tdp scale vvl={vvl}: not the plain body's "
                                f"bits")
            s = tdp.launch(ex.SAXPY_SPEC, tgt, t_x, t_y, a=a)
            want = ex.saxpy_site(t_x, t_y, TDP_A)
            errs["saxpy"] = max(errs["saxpy"], max_abs((s,), (want,)))
            if not torch.allclose(s, want, rtol=1e-6, atol=0):
                problems.append(f"tdp saxpy vvl={vvl}: max |kernel - plain| "
                                f"= {max_abs((s,), (want,))}")
            pos = tdp.launch(ex.SITE_POS_SPEC, tgt, t_x)
            if not torch.equal(pos, ex.site_pos_site(t_x, idx)):
                problems.append(f"tdp site_pos vvl={vvl}: not the plain "
                                f"body's bits")
        back = tdp.copy_from_target(t_out)
        if not np.array_equal(back, TDP_A * host_x.data):
            problems.append("tdp copy_from_target: not 2·x")
        return t_x, t_y, t_out, errs

    t_x, t_y, t_out, errs = drive("tdp surface: III-C sequence", sequence)
    out["saxpy_max_abs_err"] = errs["saxpy"]

    def reductions():
        return {op: tdp.reduce(ex.SCALE_SPEC, lat, [t_x],
                               consts={"a": TDP_A}, op=op,
                               target=tdp.Target("cuda"))
                for op in ("sum", "max", "min")}

    red = drive("tdp surface: reduce", reductions)
    y64 = (TDP_A * host_x.data).astype(np.float64)
    for op, want in (("max", y64.max(-1)), ("min", y64.min(-1))):
        if not np.array_equal(red[op].cpu().numpy().astype(np.float64), want):
            problems.append(f"tdp reduce {op}: {red[op].tolist()} vs {want}")
    s_err = np.abs(red["sum"].cpu().numpy() - y64.sum(-1))
    out["reduce_sum_err_of_sum_abs"] = (s_err / np.abs(y64).sum(-1)).tolist()
    if not (s_err <= 1e-5 * np.abs(y64).sum(-1)).all():
        problems.append(f"tdp reduce sum: error {s_err.tolist()}")

    # launch_stencil on the card goes through kernel 2
    f_soa = torch.from_numpy(1.0 / 19.0 + 0.01 * rng.standard_normal(
        (19, n), dtype=np.float32)).cuda()
    phi = f_soa[:1].contiguous()

    def legacy_stencils():
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            st = tdp.launch_stencil(stencil.stream_site_kernel, lat, [f_soa],
                                    stencil=tdp.STENCIL_D3Q19_PULL,
                                    out_ncomp=19, backend="cuda")
            gr = tdp.launch_stencil(stencil.grad6_site_kernel, lat, [phi],
                                    stencil=tdp.STENCIL_GRAD_6PT,
                                    out_ncomp=(3, 1), backend="cuda")
        return st, gr

    st_k, gr_k = drive("tdp surface: launch_stencil", legacy_stencils)
    if not torch.equal(st_k, tdp.launch(stencil.STREAM_SPEC, "torch", f_soa,
                                        lattice=lat)):
        problems.append("tdp launch_stencil stream: not the plain bits")
    for got, want in zip(gr_k, tdp.launch(stencil.GRAD6_SPEC, "torch", phi,
                                          lattice=lat)):
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            problems.append("tdp launch_stencil grad6 differs from plain")
    del st_k, gr_k, phi

    # masked copies of f over the six faces against a full copy
    mask = face_mask(GRID[0])
    nsel = int(mask.sum())
    t_f = tdp.copy_to_target(f_soa.cpu().numpy())
    full = tdp.copy_from_target(t_f)
    packed = tdp.copy_from_target_masked(t_f, mask)
    if not np.array_equal(packed, full[:, mask]):
        problems.append("copy_from_target_masked: not the selected columns")
    upd = rng.standard_normal((19, n), dtype=np.float32)
    tdp.copy_to_target_masked(t_f, upd, mask)
    after = tdp.copy_from_target(t_f)
    if not (np.array_equal(after[:, mask], upd[:, mask])
            and np.array_equal(after[:, ~mask], full[:, ~mask])):
        problems.append("copy_to_target_masked: unselected sites changed or "
                        "selected ones not written")
    del after
    out["masked"] = {
        "sites": nsel, "share": nsel / n,
        "packed_bytes": 19 * nsel * 4, "full_bytes": 19 * n * 4,
        "copy_from_target_ms": wall_ms(lambda: tdp.copy_from_target(t_f)),
        "copy_from_target_masked_ms": wall_ms(
            lambda: tdp.copy_from_target_masked(t_f, mask)),
        "copy_to_target_ms": wall_ms(lambda: tdp.copy_to_target(full)),
        "copy_to_target_masked_ms": wall_ms(
            lambda: tdp.copy_to_target_masked(t_f, upd, mask))}
    log(f"phase 4: tdp masked copies {out['masked']}")

    # target_free gives the block back
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tdp.target_free(t_f)
    freed = before - torch.cuda.memory_allocated()
    out["target_free_bytes"] = freed
    if not 19 * n * 4 <= freed < 19 * n * 4 + 2 ** 21:
        problems.append(f"target_free released {freed} bytes, not "
                        f"{19 * n * 4}")
    try:
        tdp.copy_from_target(t_f)
        problems.append("copy_from_target of a freed target did not raise")
    except RuntimeError:
        pass
    for t in (t_x, t_y, t_out):
        tdp.target_free(t)
    del full, packed, upd

    # Fig. 1: the AoS baseline (plain PyTorch) against the SoA kernel-2
    # collide and stream and their plain bodies, on one state
    params = LBParams(**PHYS)
    consts = programs.collision_consts(**PHYS)
    r2 = np.random.default_rng(32)
    f_a = torch.from_numpy(1.0 / 19.0 + 0.01 * r2.standard_normal(
        (*GRID, 19), dtype=np.float32)).cuda()
    g_a = torch.from_numpy(0.05 * r2.standard_normal(
        (*GRID, 19), dtype=np.float32)).cuda()
    phi_a = g_a.sum(-1)
    gp_a, d2_a = (torch.from_numpy(0.01 * r2.standard_normal(
        shape, dtype=np.float32)).cuda() for shape in ((*GRID, 3), GRID))

    def soa(x):
        return x.reshape(n, -1).T.contiguous()

    soa_in = [soa(x) for x in (f_a, g_a, phi_a, gp_a, d2_a)]
    f_s = soa(f_a).reshape(19, *GRID)

    def aos_collide():
        return baseline.collide_aos(f_a, g_a, phi_a, gp_a, d2_a, params)

    def soa_collide(backend):
        return tdp.launch(stencil.COLLIDE_SPEC, backend, *soa_in, **consts)

    fk = drive("tdp surface: Fig. 1 SoA kernels", lambda: (
        soa_collide("cuda"), stencil.stream(f_s, target="cuda")))
    fa = aos_collide()
    fp = soa_collide("torch")
    fig1_err = 0.0
    for got, base, plain in zip(fk[0], fa, fp):
        base_soa = soa(base)
        fig1_err = max(fig1_err, max_abs((got,), (base_soa,)))
        if not (torch.allclose(got, base_soa, rtol=1e-5, atol=1e-6)
                and torch.allclose(got, plain, rtol=1e-5, atol=1e-6)):
            problems.append(f"Fig. 1 collide: SoA kernel vs AoS baseline "
                            f"{max_abs((got,), (base_soa,))}")
    if not torch.equal(torch.movedim(baseline.stream_aos(f_a), -1, 0), fk[1]):
        problems.append("Fig. 1 stream: AoS baseline and SoA kernel differ")
    del fk, fa, fp
    torch.cuda.empty_cache()
    out["fig1"] = {
        "collide_max_abs_err": fig1_err,
        "collide_aos_ms": time_ms(aos_collide, hold=SHORT_HOLD),
        "collide_soa_kernel_ms": time_ms(lambda: soa_collide("cuda"),
                                         hold=SHORT_HOLD),
        "collide_soa_plain_ms": time_ms(lambda: soa_collide("torch"),
                                        hold=SHORT_HOLD),
        "stream_aos_ms": time_ms(lambda: baseline.stream_aos(f_a),
                                 hold=SHORT_HOLD),
        "stream_soa_kernel_ms": time_ms(
            lambda: stencil.stream(f_s, target="cuda"), hold=SHORT_HOLD)}
    print(json.dumps({"fig1_128cubed_ms": out["fig1"]}), flush=True)
    del f_a, g_a, phi_a, gp_a, d2_a, soa_in, f_s, f_soa
    torch.cuda.empty_cache()

    # the spinodal example, three regimes
    runs = {}
    for regime, flags in (("cuda", []),
                          ("one_launch", ["--backend", "cuda_windowed",
                                          "--fused", "one_launch"]),
                          ("two_launch", ["--backend", "cuda_windowed",
                                          "--fused", "two_launch"])):
        argv = ["--grid", str(GRID[0]), "--steps", str(SPINODAL_STEPS),
                "--chunk", str(SPINODAL_CHUNK), *flags]
        r = drive(f"tdp surface: lb_spinodal {regime}",
                  lambda argv=argv: lb_spinodal.main(argv))
        phi_end = r["state"].g.double().sum(0)
        runs[regime] = {"mass_drift": r["mass_drift"],
                        "phi_total": r["last"]["phi_total"],
                        "phi_total_0": r["first"]["phi_total"],
                        "phi_abs": float(phi_end.abs().sum()),
                        "phi_var_0": r["first"]["phi_var"],
                        "phi_var": r["last"]["phi_var"],
                        "msites_per_s": r["msites_per_s"],
                        "executors": r["executors"]}
        run = runs[regime]
        if run["mass_drift"] > 1e-5 or r["last"]["nan"]:
            problems.append(f"lb_spinodal {regime}: mass drift "
                            f"{run['mass_drift']} or NaN")
        if not run["phi_var"] > run["phi_var_0"]:
            problems.append(f"lb_spinodal {regime}: φ variance did not grow")
        if abs(run["phi_total"] - run["phi_total_0"]) > 1e-5 * run["phi_abs"]:
            problems.append(f"lb_spinodal {regime}: φ total drifted")
        del r, phi_end
    base = runs["cuda"]
    for regime, run in runs.items():
        if (abs(run["phi_total"] - base["phi_total"]) > 1e-5 * base["phi_abs"]
                or abs(run["phi_var"] - base["phi_var"])
                > 1e-3 * base["phi_var"]):
            problems.append(f"lb_spinodal {regime} vs unfused: φ total "
                            f"{run['phi_total']} / {base['phi_total']}, φ "
                            f"variance {run['phi_var']} / {base['phi_var']}")
    out["lb_spinodal"] = runs
    torch.cuda.empty_cache()
    return out


def tdp_rows(launches, launches_by_path, max_err, problems) -> list:
    """Phase 5, kernel 2's example entry at (3, 128³): each site function
    held to its plain body bit for bit at every VVL, also on operands at a
    storage offset of one float (the scalar path), and the library call to
    the plain body; then timed at VVL 1 and every VVL beside both, the bound
    and its time before the redesign.  Then the one-pass reduce of ``scale``
    (a = 1): max and min exact against the plain route (``reduce(...,
    target="torch")``); the sum, which accumulates in double, within
    ``rtol=1e-6, atol=1e-6`` of the float64 sum of the plain map's values
    and, as the plain route and ``x.sum(-1)`` are, within 1e-5·Σ|x| of it;
    the same bits on the offset operand and from call to call; timed per op
    and, the sum, at every VVL, beside ``x.sum(-1)`` (the library call),
    ``x.sum(-1, dtype=torch.float64)``, ``amax`` / ``amin`` and beside the
    map plus ``torch.sum`` it replaces (``map_sum_ms``)."""
    import dataclasses
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.core.execute import _map_reduce, reduce
    from repro_torch.core.target import CUDA_VVLS
    from repro_torch.kernels import example_sites as ex
    from repro_torch.kernels import tdp_pointwise
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(33)
    n = int(np.prod(GRID))
    x, y = (torch.randn(TDP_NCOMP, n, device=dev, generator=g)
            for _ in range(2))
    x_off, y_off = offset_copy(x), offset_copy(y)
    ins = {"scale": [x], "saxpy": [x, y], "site_pos": [x]}
    libs = {"scale": lambda: torch.mul(x, TDP_A),
            "saxpy": lambda: torch.add(y, x, alpha=TDP_A), "site_pos": None}
    rows = []
    for site in ex.SPECS:
        spec = dataclasses.replace(ex.SPECS[site], out=TDP_NCOMP)
        consts = {} if site == "site_pos" else {"a": TDP_A}
        plans = {v: launch_plan(spec, Target("cuda", vvl=v), consts=consts)
                 for v in CUDA_VVLS}
        xs = ins[site]
        xs_off = [x_off, y_off][:len(xs)]

        def kern(p=plans[1], xs=xs):
            return tdp_pointwise.cuda_execute(p, xs)[0]

        def plain(p=plans[1], xs=xs):
            return torch_executor(p, xs)[0]

        want = plain()
        key = ("tdp_gathered", site)
        for v, p in plans.items():
            for operands, what in ((xs, ""), (xs_off, " offset by a float")):
                got = tdp_pointwise.cuda_execute(p, operands)[0]
                torch.cuda.synchronize()
                err = max_abs((got,), (want,))
                max_err[key] = max(max_err.get(key, 0.0), err)
                if not torch.equal(got, want) and not (
                        site == "saxpy" and torch.allclose(got, want,
                                                           rtol=1e-6, atol=0)):
                    problems.append(f"tdp_gathered.{site} (3, 128^3) vvl={v}"
                                    f"{what}: max |kernel - plain| = {err}")
                del got
        lib = libs[site]
        if lib is not None and not torch.allclose(lib(), want, rtol=1e-6,
                                                  atol=1e-6):
            problems.append(f"library call for tdp_gathered.{site} differs "
                            f"from plain")
        del want
        nbytes = (8 + 4 * (len(xs) - 1)) * TDP_NCOMP * n
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        name = f"tdp_gathered.{site}"
        row = {"name": name, "route": "cuda",
               **KERNELS["tdp_gathered.example"],
               "launches": launches[key],
               "launches_by_path": launches_by_path[key],
               "max_abs_err": max_err[key],
               "ms": time_ms(kern, hold=SHORT_HOLD),
               "plain_ms": time_ms(plain, hold=SHORT_HOLD),
               "bound_ms": b_ms, "bound_by": "bytes",
               "library_ms": (None if lib is None
                              else time_ms(lib, hold=SHORT_HOLD)),
               "shape": [TDP_NCOMP, n],
               "ms_by_vvl": {v: time_ms(
                   lambda p=p, xs=xs: tdp_pointwise.cuda_execute(p, xs),
                   hold=SHORT_HOLD) for v, p in plans.items()}}
        rows.append(row)
        log(f"phase 5: {name} ms={row['ms']:.4f} (before the redesign "
            f"{EARLIER_EXAMPLE_MS[name]}) plain={row['plain_ms']:.4f} library="
            f"{row['library_ms']} bound={b_ms:.4f} by VVL {row['ms_by_vvl']} "
            f"err={max_err[key]}")

    # the one-pass reduce of scale with a = 1
    spec = dataclasses.replace(ex.SCALE_SPEC, out=TDP_NCOMP)

    def red(op, backend="cuda", vvl=None, field=x):
        return reduce(spec, None, [field], consts={"a": 1.0}, op=op,
                      target=Target(backend, vvl=vvl))

    key = ("tdp_gathered", "reduce")
    # the kernel's sum accumulates in double and rounds once: it is held to
    # the float64 sum of the plain map's values; the plain route's
    # torch.sum and the library call x.sum(-1) are float32 throughout and
    # held to 1e-5·Σ|x| of that sum, as the kernel is
    map64 = torch_executor(launch_plan(spec, Target("torch"),
                                       consts={"a": 1.0}), [x])[0].double()
    sum64, abs64 = map64.sum(-1), map64.abs().sum(-1)
    del map64
    libs = {"sum": lambda: x.sum(-1), "max": lambda: x.amax(-1),
            "min": lambda: x.amin(-1)}
    err, sum_err, route_err = 0.0, None, None
    for op, lib in libs.items():
        got, want = red(op), red(op, "torch")
        again, off = red(op), red(op, field=x_off)
        if op == "sum":
            s_err = (got.double() - sum64).abs()
            sum_err = (s_err / abs64).tolist()
            route_err = max_abs((got,), (want,))
            err = max(err, float(s_err.max()))
            ok = (torch.allclose(got.double(), sum64, rtol=1e-6, atol=1e-6)
                  and all(bool(((v.double() - sum64).abs()
                                <= 1e-5 * abs64).all())
                          for v in (got, want, lib())))
        else:
            err = max(err, max_abs((got,), (want,)))
            ok = torch.equal(got, want) and torch.equal(lib(), want)
        if not (ok and torch.equal(again, got) and torch.equal(off, got)):
            problems.append(f"reduce({op}) of scale: kernel {got.tolist()} "
                            f"(again {again.tolist()}, offset operand "
                            f"{off.tolist()}), plain route {want.tolist()}, "
                            f"float64 sum {sum64.tolist()}, library "
                            f"{lib().tolist()}")
    max_err[key] = max(max_err.get(key, 0.0), err)
    ms_by_op = {op: time_ms(lambda op=op: red(op), hold=SHORT_HOLD)
                for op in libs}
    row = {"name": "tdp_gathered.reduce", "route": "cuda",
           **KERNELS["tdp_gathered.reduce"], "site": "scale", "op": "sum",
           "launches": launches[key],
           "launches_by_path": launches_by_path[key],
           "max_abs_err": max_err[key], "ms": ms_by_op["sum"],
           "plain_ms": time_ms(lambda: red("sum", "torch"), hold=SHORT_HOLD),
           "bound_ms": 4 * TDP_NCOMP * n / PEAK_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": time_ms(libs["sum"], hold=SHORT_HOLD),
           "library_float64_ms": time_ms(
               lambda: x.sum(-1, dtype=torch.float64), hold=SHORT_HOLD),
           "map_sum_ms": time_ms(lambda: _map_reduce(
               spec, Target("cuda"), [x], None, {"a": 1.0}, "sum"),
               hold=SHORT_HOLD),
           "ms_by_op": ms_by_op,
           "library_ms_by_op": {op: time_ms(lib, hold=SHORT_HOLD)
                                for op, lib in libs.items()},
           "ms_by_vvl": {v: time_ms(lambda v=v: red("sum", vvl=v),
                                    hold=SHORT_HOLD) for v in CUDA_VVLS},
           "sum_err_of_sum_abs": sum_err,
           "max_abs_err_sum_vs_plain_route": route_err,
           "shape": [TDP_NCOMP, n]}
    rows.append(row)
    log(f"phase 5: {row['name']} sum ms={row['ms']:.4f} (before the redesign, "
        f"map + torch.sum: {EARLIER_EXAMPLE_MS['tdp_gathered.reduce']}; this "
        f"run's map + torch.sum {row['map_sum_ms']:.4f}) library="
        f"{row['library_ms']:.4f} (x.sum(-1, dtype=torch.float64) "
        f"{row['library_float64_ms']:.4f}) by op {ms_by_op} by VVL "
        f"{row['ms_by_vvl']} err={err} sum vs the plain route's float32 "
        f"torch.sum {route_err}")
    del x, y, x_off, y_off
    torch.cuda.empty_cache()
    return rows


def aosoa_phase(drive, by_path, make_inputs, prepare, soa_finals, st0,
                soa_rows, params, problems) -> tuple[list, dict]:
    """Phase 6, the AoSoA layout (``Target(layout="aosoa")``) on the card:
    every AoSoA kernel checked against the SoA launch of its executor and
    its plain version (the transforms plus the plain body) — the LB site
    functions at 128³ on both executors and the example sites at (3, 128³)
    at each ``AOSOA_WIDTHS`` width, ``rmsnorm`` at both prefill shapes,
    ``gated``/``act`` at 84.9 M elements, one falcon-mamba-7b layer's
    ``mamba``; then its main path, each path driven with the counts at 0:
    ``BinaryFluidSim`` 128³, 20 steps, three regimes at W = ``AOSOA_W``
    held to the SoA runs with Σf and Σg conserved, ``ops.lb_fused_step``,
    ``stencil.gradients``, ``tdp.launch`` of the examples and the LM ops;
    MLUPS beside SoA's in the same call; and one row per AoSoA kernel: ms
    on operands already in AoSoA, ms with the boundary transforms, the
    plain version, the bound and the SoA row's library call.  Returns
    ``(rows, record)``."""
    import dataclasses
    from repro_torch import tdp
    from repro_torch.core import Lattice, Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import _build, lm, ops
    from repro_torch.kernels import example_sites as ex
    from repro_torch.kernels import tdp_pointwise as tp
    from repro_torch.kernels import tdp_windowed as tw
    from repro_torch.lb import programs, stencil
    from repro_torch.lb.sim import BinaryFluidSim
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    nsites = int(np.prod(GRID))
    soa_by_name = {r["name"]: r for r in soa_rows}
    out: dict = {"bit_equal_to_soa": {}, "max_abs_vs_soa": {}}
    rows = []

    def hold(kind, got, soa, plain, what, tol=None):
        """Held to the SoA launch (bit-equal expected; the difference is
        printed and must lie within the tolerance where it is not) and to
        the plain version."""
        got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
        soa = (soa,) if isinstance(soa, torch.Tensor) else tuple(soa)
        plain = (plain,) if isinstance(plain, torch.Tensor) else tuple(plain)
        torch.cuda.synchronize()
        bit = all(torch.equal(a, b) for a, b in zip(got, soa))
        d = max_abs(got, soa)
        out["bit_equal_to_soa"][what] = bit
        if not bit:
            out["max_abs_vs_soa"][what] = d
            log(f"phase 6: {what} differs from SoA by {d}")
        for ref, against in ((soa, "SoA"), (plain, "plain")):
            if tol is None:
                compare(kind, got, ref, f"{what} vs {against}", problems)
            elif not all(torch.isfinite(a).all() and torch.allclose(a, b, **tol)
                         for a, b in zip(got, ref)):
                problems.append(f"{what} vs {against}: max diff "
                                f"{max_abs(got, ref)}")
        return max_abs(got, plain), bit

    def row(name, kind, err, bit, alone, with_t, plain, b_ms_by, soa_name,
            **extra):
        b_ms, b_by = b_ms_by
        soa = soa_by_name.get(soa_name, {})
        r = {"name": name, "route": "cuda", **KERNELS[kind],
             "launches": 0, "max_abs_err": err, "ms": alone,
             "ms_with_transforms": with_t, "plain_ms": plain,
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": soa.get("library_ms"), "soa_ms": soa.get("ms"),
             "bit_equal_to_soa": bit, **extra}
        log(f"phase 6: {name} ms={alone:.4f} with transforms={with_t:.4f} "
            f"(SoA {r['soa_ms']}) plain={plain:.4f} bound={b_ms:.4f} "
            f"err={err} bit-equal to SoA: {bit}")
        rows.append(r)

    def quick(fn, reps=10):
        return time_ms(fn, reps=reps, warmup=2, hold=SHORT_HOLD)

    # -- LB site functions at 128^3, both executors --------------------------
    for kernel in ("tdp_gathered", "tdp_windowed"):
        windowed = kernel == "tdp_windowed"
        backend = "cuda_windowed" if windowed else "cuda"
        execute = tw.windowed_execute if windowed else tp.cuda_execute
        launch_fn = tw._aosoa_launch if windowed else tp._aosoa_launch
        for site in (STENCIL_SITES if windowed else _build.SITES):
            spec = stencil.SPECS[site]
            shape = GRID if spec.has_stencil else (nsites,)
            halo = (0,) * len(shape)
            xs = make_inputs(spec, shape, halo, seed=300 + _build.SITE_ID[site])
            prepared = prepare(spec, xs, shape, halo)
            consts = programs.collision_consts(**PHYS) if spec.consts else {}
            kw = dict(lattice=Lattice(shape) if spec.has_stencil else None,
                      halo=halo if spec.has_stencil else None, consts=consts)
            soa_plan = launch_plan(spec, Target(backend), **kw)
            soa = execute(soa_plan, prepared)
            plain = tp.fields_plain(soa_plan, prepared)
            err, bits = 0.0, True
            for w in AOSOA_WIDTHS:
                plan = launch_plan(spec, Target(backend, vvl=w,
                                                layout="aosoa"), **kw)
                e, bit = hold(site, execute(plan, prepared), soa, plain,
                              f"{kernel}_aosoa.{site} W={w}")
                err, bits = max(err, e), bits and bit
            del soa, plain
            plan = launch_plan(spec, Target(backend, vvl=AOSOA_W,
                                            layout="aosoa"), **kw)
            blocks = tp.aosoa_operands(plan, prepared, windowed)
            geom = tp.lb_geometry(plan, prepared)
            row(f"{kernel}_aosoa.{site}", f"{kernel}_aosoa", err, bits,
                quick(lambda: launch_fn(plan, site, blocks, nsites, geom)),
                quick(lambda: execute(plan, prepared)),
                quick(lambda: tp.aosoa_plain(plan, tp.aosoa_operands(
                    plan, prepared, windowed), nsites, windowed), reps=3),
                bound(site, nsites), f"{kernel}.{site}", W=AOSOA_W)
            del xs, prepared, blocks
            torch.cuda.empty_cache()

    # -- the example site functions at (3, 128^3) ----------------------------
    g = torch.Generator(device=dev).manual_seed(34)
    x, y = (torch.randn(TDP_NCOMP, nsites, device=dev, generator=g)
            for _ in range(2))
    for site in ex.SPECS:
        spec = dataclasses.replace(ex.SPECS[site], out=TDP_NCOMP)
        xs = [x, y] if site == "saxpy" else [x]
        consts = {} if site == "site_pos" else {"a": TDP_A}
        soa = tp.cuda_execute(launch_plan(spec, Target("cuda"),
                                          consts=consts), xs)
        err, bits = 0.0, True
        for w in AOSOA_WIDTHS:
            plan = launch_plan(spec, Target("cuda", vvl=w, layout="aosoa"),
                               consts=consts)
            got = tp.cuda_execute(plan, xs)
            e, bit = hold("stream" if site != "saxpy" else site, got, soa,
                          torch_executor(plan, xs),
                          f"tdp_gathered_aosoa.{site} W={w}")
            err, bits = max(err, e), bits and bit
        by_width = {}
        for w in AOSOA_WIDTHS:
            plan = launch_plan(spec, Target("cuda", vvl=w, layout="aosoa"),
                               consts=consts)
            blocks = tp.aosoa_operands(plan, xs)
            # the same blocks at a storage offset of one float: one lane a
            # thread instead of 4, the same bits
            off = tp._aosoa_launch(plan, site, [offset_copy(b) for b in blocks],
                                   nsites, None)[0]
            if not torch.equal(tp.aosoa_to_soa(off, nsites), soa[0]):
                problems.append(f"tdp_gathered_aosoa.{site} W={w} on operands "
                                f"offset by a float: not the SoA bits")
            by_width[w] = quick(lambda: tp._aosoa_launch(plan, site, blocks,
                                                         nsites, None))
            del off
        plan = launch_plan(spec, Target("cuda", vvl=AOSOA_W, layout="aosoa"),
                           consts=consts)
        blocks = tp.aosoa_operands(plan, xs)
        nbytes = (8 + 4 * (len(xs) - 1)) * TDP_NCOMP * nsites
        name = f"tdp_gathered_aosoa.{site}"
        row(name, "tdp_gathered_aosoa.example", err,
            bits, quick(lambda: tp._aosoa_launch(plan, site, blocks, nsites,
                                                 None)),
            quick(lambda: tp.cuda_execute(plan, xs)),
            quick(lambda: torch_executor(plan, xs)),
            (nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
            f"tdp_gathered.{site}", W=AOSOA_W, ms_by_width=by_width)
        log(f"phase 6: {name} before the redesign {EARLIER_EXAMPLE_MS[name]}")
        del soa
    del x, y, blocks

    # -- the LM site functions at the serving shapes -------------------------
    def lm_case(name, spec, xs, consts, w, soa_vvl, nbytes, flops,
                plain_wall=False, more_widths=(), sfu_ops=0):
        plan = launch_plan(spec, Target("cuda", vvl=w, layout="aosoa"),
                           consts=consts)
        soa = tp.cuda_execute(launch_plan(spec, Target("cuda", vvl=soa_vvl),
                                          consts=consts), xs)
        t0 = time.perf_counter()
        plain = torch_executor(plan, xs)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err, bit = hold(name, tp.cuda_execute(plan, xs), soa, plain, name,
                        tol=LM_TOL)
        del soa, plain
        blocks = tp.aosoa_operands(plan, xs)
        n = int(xs[0].shape[-1])
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        t_o = max(flops / PEAK_F32_PER_S, sfu_ops / PEAK_SFU_PER_S) * 1e3
        site = spec.fn.__cuda_site__
        by_width = {}
        for w2 in more_widths:
            p2 = launch_plan(spec, Target("cuda", vvl=w2, layout="aosoa"),
                             consts=consts)
            b2 = tp.aosoa_operands(p2, xs)
            by_width[w2] = quick(lambda: tp._aosoa_launch(p2, site, b2, n,
                                                           None))
            del b2
        row(f"tdp_gathered_aosoa.{name}", "tdp_gathered_aosoa.lm", err, bit,
            quick(lambda: tp._aosoa_launch(plan, site, blocks, n, None)),
            quick(lambda: tp.cuda_execute(plan, xs)),
            plain_s * 1e3 if plain_wall else quick(
                lambda: torch_executor(plan, xs), reps=3),
            max((t_b, "bytes"), (t_o, "operations")),
            f"tdp_gathered.{name}", W=w, plain_timing="wall, one call"
            if plain_wall else "device", shape=list(xs[0].shape),
            ms_by_width=by_width)
        del blocks
        torch.cuda.empty_cache()

    cfg_d, mcfg_d = 2304, 4096
    for suffix, d, ntok in (("rmsnorm", cfg_d, SERVE_BATCH * SERVE_PROMPT),
                            ("rmsnorm.prefill_d4096", mcfg_d,
                             SERVE_BATCH * MAMBA_PROMPT)):
        xs = [torch.randn(d, ntok, device=dev, generator=g)]
        consts = {"weight": torch.randn(d, device=dev, generator=g),
                  "eps": 1e-6, "scale_offset": 1.0}
        lm_case(suffix, lm.rmsnorm_spec(d), xs, consts, AOSOA_W, 1,
                8 * d * ntok + 4 * d, 5 * d * ntok)
    nel = SERVE_BATCH * SERVE_PROMPT * 9216
    u = 3.0 * torch.randn(1, nel, device=dev, generator=g)
    v = torch.randn(1, nel, device=dev, generator=g)
    lm_case("gated", lm.gated_act_spec("geglu", True), [u, v], {},
            AOSOA_W_EW, 1, 12 * nel, 10 * nel)
    lm_case("act", lm.gated_act_spec("gelu", False), [u], {}, AOSOA_W_EW, 1,
            8 * nel, 9 * nel)
    del u, v
    length, nstate, n = MAMBA_PROMPT, 16, 8192
    rws = SERVE_BATCH * length
    xs = [torch.randn(rws, n, device=dev, generator=g),
          torch.nn.functional.softplus(torch.randn(rws, n, device=dev,
                                                   generator=g)),
          -torch.exp(torch.randn(nstate, n, device=dev, generator=g)),
          torch.ones(1, n, device=dev)]
    consts = {"b": torch.randn(rws, nstate, device=dev, generator=g),
              "c": torch.randn(rws, nstate, device=dev, generator=g)}
    nbytes = 4 * (3 * rws * n + nstate * n + n
                  + SERVE_BATCH * (nstate * n + 2 * length * nstate))
    lm_case("mamba", lm.mamba_scan_spec(length, nstate, SERVE_BATCH), xs,
            consts, AOSOA_W_MAMBA, tp.MAMBA_AOSOA_VVL, nbytes,
            (6 * nstate + 3) * rws * n, plain_wall=True, more_widths=(64,),
            sfu_ops=rws * n * nstate)
    del xs, consts
    torch.cuda.empty_cache()

    # -- the main path under AoSoA --------------------------------------------
    paths = []

    def adrive(path, fn):
        paths.append(path)
        return drive(path, fn)

    sims, finals, mlups = {}, {}, {}
    # Σf and Σg conserved to 1e-5 of Σ|f| and Σ|g| (Σg is near 0)
    mass0 = {k: (float(getattr(st0, k).double().sum()),
                 float(getattr(st0, k).double().abs().sum()))
             for k in ("f", "g")}
    for regime in (False, "one_launch", "two_launch"):
        backend = "cuda_windowed" if regime else "cuda"
        sims[regime] = BinaryFluidSim(
            GRID, params, fused=regime,
            target=Target(backend, vvl=AOSOA_W, layout="aosoa"))
        finals[regime] = adrive(f"AoSoA BinaryFluidSim fused={regime}",
                                lambda: sims[regime].run(st0, STEPS))
        for k in ("f", "g"):
            a, b = getattr(finals[regime], k), getattr(soa_finals[regime], k)
            if not torch.allclose(a, b, rtol=2e-4, atol=2e-5):
                problems.append(f"AoSoA regime {regime}: {k} differs from "
                                f"SoA by {float((a - b).abs().max())}")
            m = float(a.double().sum())
            if abs(m - mass0[k][0]) > 1e-5 * mass0[k][1]:
                problems.append(f"AoSoA regime {regime}: sum of {k} {m} vs "
                                f"{mass0[k][0]}")
        out.setdefault("max_abs_vs_soa_128cubed", {})[str(regime)] = max(
            float((getattr(finals[regime], k) - getattr(soa_finals[regime], k))
                  .abs().max()) for k in ("f", "g"))
        soa_sim = BinaryFluidSim(GRID, params, fused=regime)
        mlups[str(regime)] = {}
        for which, sim in (("soa", soa_sim), ("aosoa", sims[regime])):
            sim.run(st0, 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sim.run(st0, STEPS)
            torch.cuda.synchronize()
            mlups[str(regime)][which] = (nsites * STEPS
                                         / (time.perf_counter() - t) / 1e6)
    out["mlups_128cubed_20_steps"] = mlups
    f2 = soa_finals["two_launch"].f.reshape(19, -1)
    g2 = soa_finals["two_launch"].g.reshape(19, -1)
    for mode in ("one_launch", "two_launch"):
        for backend in ("cuda_windowed", "cuda"):
            want = ops.lb_fused_step(f2, g2, grid_shape=GRID, mode=mode,
                                     target=Target(backend),
                                     **params.as_kwargs())
            got = adrive(f"AoSoA ops.lb_fused_step {mode} {backend}",
                         lambda: ops.lb_fused_step(
                             f2, g2, grid_shape=GRID, mode=mode,
                             target=Target(backend, vvl=AOSOA_W,
                                           layout="aosoa"),
                             **params.as_kwargs()))
            compare("fused", got, want, f"AoSoA lb_fused_step {mode} "
                    f"{backend}", problems)
    phi = g2.sum(0).reshape(GRID)
    want = stencil.gradients(phi, target=Target("cuda_windowed"))
    got = adrive("AoSoA stencil.gradients cuda_windowed",
                 lambda: stencil.gradients(phi, target=Target(
                     "cuda_windowed", vvl=AOSOA_W, layout="aosoa")))
    compare("grad6", got, want, "AoSoA gradients", problems)
    x, y = (torch.randn(TDP_NCOMP, nsites, device=dev, generator=g)
            for _ in range(2))
    t_ex = Target("cuda", vvl=AOSOA_W, layout="aosoa")
    for site, args, kw in (("scale", [x], {"a": TDP_A}),
                           ("saxpy", [x, y], {"a": TDP_A}),
                           ("site_pos", [x], {})):
        got = adrive(f"AoSoA tdp.launch {site}",
                     lambda: tdp.launch(ex.SPECS[site], t_ex, *args, **kw))
        want = tdp.launch(ex.SPECS[site], Target("cuda"), *args, **kw)
        if not torch.equal(got, want):
            problems.append(f"AoSoA tdp.launch {site} differs from SoA")
    del x, y, f2, g2, phi
    h = torch.randn(SERVE_BATCH * 64, cfg_d, device=dev, generator=g)
    wgt = torch.randn(cfg_d, device=dev, generator=g)
    got = adrive("AoSoA ops.rmsnorm", lambda: ops.rmsnorm(
        h, wgt, scale_offset=1.0, target=Target("cuda", vvl=AOSOA_W,
                                                layout="aosoa")))
    if not torch.allclose(got, ops.rmsnorm(h, wgt, scale_offset=1.0),
                          **LM_TOL):
        problems.append("AoSoA ops.rmsnorm differs from SoA")
    t_ew = Target("cuda", vvl=AOSOA_W_EW, layout="aosoa")
    for kind, gate in (("geglu", h), ("gelu", None)):
        got = adrive(f"AoSoA ops.gated_act {kind}", lambda: ops.gated_act(
            h, gate, kind=kind, target=t_ew))
        if not torch.equal(got, ops.gated_act(h, gate, kind=kind)):
            problems.append(f"AoSoA ops.gated_act {kind} differs from SoA")
    bm, lm_, dm, nm = 2, 64, 1024, 16
    args = [torch.randn(bm, lm_, dm, device=dev, generator=g),
            torch.nn.functional.softplus(torch.randn(bm, lm_, dm, device=dev,
                                                     generator=g)),
            torch.randn(bm, lm_, nm, device=dev, generator=g),
            torch.randn(bm, lm_, nm, device=dev, generator=g),
            -torch.exp(torch.randn(dm, nm, device=dev, generator=g)),
            torch.randn(dm, device=dev, generator=g)]
    got = adrive("AoSoA ops.mamba_scan", lambda: ops.mamba_scan(
        *args, target=Target("cuda", vvl=AOSOA_W_MAMBA, layout="aosoa")))
    want = ops.mamba_scan(*args, target=Target("cuda",
                                                vvl=tp.MAMBA_AOSOA_VVL))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        problems.append("AoSoA ops.mamba_scan differs from SoA")
    del h, args, finals, sims
    torch.cuda.empty_cache()

    # launches per AoSoA kernel on its main path
    counts = {}
    for path in paths:
        for (k, s), c in by_path.get(path, {}).items():
            if k.endswith("_aosoa"):
                counts.setdefault((k, s), {})[path] = c
    for r in rows:
        k, s = r["name"].split(".", 1)
        s = {"rmsnorm.prefill_d4096": "rmsnorm"}.get(s, s)
        r["launches_by_path"] = counts.get((k, s), {})
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            problems.append(f"{k}.{s} was not launched on the AoSoA main path")
    out["launches_by_path"] = {path: {f"{k}.{s}": c for (k, s), c in
                                      by_path.get(path, {}).items()}
                               for path in paths}
    bf_rows, out["bf16"] = aosoa_bf16(drive, by_path, problems)
    rows += bf_rows
    out["phase_s"] = time.perf_counter() - t_start
    log(f"phase 6: AoSoA phase {out['phase_s']:.1f} s; MLUPS {mlups}")
    return rows, out


def aosoa_bf16(drive, by_path, problems, device="cuda") -> tuple[list, dict]:
    """Phase 6 in bfloat16: the AoSoA LM kernels on bfloat16 operands (the
    rmsnorm and scan pieces templated on the storage type, the elementwise
    kernel over bfloat16 blocks) at the float32 rows' shapes: rmsnorm at
    gemma2's prefill (W ``AOSOA_W``), GeGLU and GELU over its MLP
    activations (W ``AOSOA_W_EW``), one falcon-mamba-7b layer's scan (W
    ``AOSOA_W_MAMBA``: x, dt, b, c bfloat16, a, d float32).  Each is held
    to the bits of its bfloat16 SoA twin (rmsnorm the tiled kernel at VVL
    1, gated/act at VVL 1, the scan at ``MAMBA_AOSOA_VVL``) and within one
    bfloat16 step of its plain version (``bf16_close``; the scan's
    ``scan_close``), a control one rounding away failing that bar
    (``bf16_control``, ``mamba_state_rounded``); the scan also at W 12
    (8-byte copies of 4 values, not 16-byte ones), bit for bit.  Then each
    through its entry point under AoSoA in bfloat16, its path counted, held
    to the SoA call bit for bit.  Rows: ms on operands already in AoSoA,
    with the transforms, the SoA twin's, the plain version's, the bound
    (2 bytes an element) and the bfloat16 library call where one exists
    (``F.rms_norm``, ``F.gelu``).  Returns ``(rows, record)``."""
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import lm, ops
    from repro_torch.kernels import tdp_pointwise as tp
    t_start = time.perf_counter()
    dev, bf = torch.device(device), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(61)
    out: dict = {"bit_equal_to_soa": {}, "checks": {}}
    rows = []

    def as_tuple(o):
        return (o,) if isinstance(o, torch.Tensor) else tuple(o)

    def quick(fn, reps=10):
        return time_ms(fn, reps=reps, warmup=2, hold=SHORT_HOLD)

    def case(name, spec, xs, consts, w, soa_vvl, nbytes, ops_, control, *,
             lib=None, close=bf16_close, readings=bf16_readings,
             plain_wall=False, also_widths=()):
        site = spec.fn.__cuda_site__
        plan = launch_plan(spec, Target("cuda", vvl=w, layout="aosoa"),
                           consts=consts)
        soa_plan = launch_plan(spec, Target("cuda", vvl=soa_vvl),
                               consts=consts)
        soa = as_tuple(tp.cuda_execute(soa_plan, xs))
        got = as_tuple(tp.cuda_execute(plan, xs))
        t0 = time.perf_counter()
        plain = as_tuple(torch_executor(plan, xs))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        bits = {w: all(torch.equal(a, b) for a, b in zip(got, soa))}
        for w2 in also_widths:
            p2 = launch_plan(spec, Target("cuda", vvl=w2, layout="aosoa"),
                             consts=consts)
            bits[w2] = all(torch.equal(a, b) for a, b in
                           zip(as_tuple(tp.cuda_execute(p2, xs)), soa))
        ctl = as_tuple(control())
        check = {
            "dtypes": [str(a.dtype).removeprefix("torch.") for a in got],
            "bits_vs_soa_by_width": bits,
            "kernel": {k: max(readings(a, b)[k] for a, b in zip(got, plain))
                       for k in ("max_bf16_steps", "share_apart")},
            "held": all(close(a, b) for a, b in zip(got, plain)),
            "control": {k: max(readings(a, b)[k] for a, b in zip(ctl, plain))
                        for k in ("max_bf16_steps", "share_apart")},
            "control_held": all(close(a, b) for a, b in zip(ctl, plain))}
        err = max_abs(got, plain)
        out["bit_equal_to_soa"][name] = all(bits.values())
        out["checks"][name] = check
        if not all(bits.values()):
            problems.append(f"{name}: not the bits of its bfloat16 SoA twin "
                            f"(VVL {soa_vvl}): {bits}, max diff "
                            f"{max_abs(got, soa)}")
        if not check["held"] or [a.dtype for a in got] != [
                a.dtype for a in plain]:
            problems.append(f"{name} vs plain: {check}")
        if check["control_held"]:
            problems.append(f"{name}: the control passes the bar the kernel "
                            f"is held to ({check['control']})")
        del soa, got, plain, ctl
        blocks = tp.aosoa_operands(plan, xs)
        n = int(xs[0].shape[-1])
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms, b_by = max((t_b, "bytes"), ops_)
        r = {"name": name, "route": "cuda", **KERNELS["tdp_gathered_aosoa.lm"],
             "dtype": "bfloat16", "launches": 0, "max_abs_err": err,
             "ms": quick(lambda: tp._aosoa_launch(plan, site, blocks, n, None)),
             "ms_with_transforms": quick(lambda: tp.cuda_execute(plan, xs)),
             "soa_ms": quick(lambda: tp.cuda_execute(soa_plan, xs)),
             "plain_ms": plain_s * 1e3 if plain_wall else quick(
                 lambda: torch_executor(plan, xs), reps=3),
             "plain_timing": "wall, one call" if plain_wall else "device",
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": quick(lib) if lib is not None else None,
             "bit_equal_to_soa": all(bits.values()), "W": w,
             "soa_vvl": soa_vvl, "shape": list(xs[0].shape), **check}
        log(f"phase 6: {name} ms={r['ms']:.4f} with transforms="
            f"{r['ms_with_transforms']:.4f} (bf16 SoA {r['soa_ms']:.4f}) "
            f"plain={r['plain_ms']:.4f} library={r['library_ms']} "
            f"bound={b_ms:.4f} err={err} {json.dumps(check)}")
        rows.append(r)
        del blocks
        torch.cuda.empty_cache()

    d, ntok = 2304, SERVE_BATCH * SERVE_PROMPT
    x = torch.randn(d, ntok, device=dev, generator=g).to(bf)
    w = torch.randn(d, device=dev, generator=g).to(bf)
    w1 = (w.float() + 1.0).to(bf)
    case("tdp_gathered_aosoa.rmsnorm.bf16", lm.rmsnorm_spec(d), [x],
         {"weight": w, "eps": 1e-6, "scale_offset": 1.0}, AOSOA_W, 1,
         2 * (2 * d * ntok + d), (5 * d * ntok / PEAK_F32_PER_S * 1e3,
                                  "operations"),
         lambda: bf16_control("rmsnorm", x, w),
         lib=lambda: torch.nn.functional.rms_norm(x.T, (d,), weight=w1,
                                                  eps=1e-6))
    nel = ntok * 9216
    u = (3.0 * torch.randn(1, nel, device=dev, generator=g)).to(bf)
    v = torch.randn(1, nel, device=dev, generator=g).to(bf)
    case("tdp_gathered_aosoa.gated.bf16", lm.gated_act_spec("geglu", True),
         [u, v], {}, AOSOA_W_EW, 1, 6 * nel,
         (10 * nel / PEAK_F32_PER_S * 1e3, "operations"),
         lambda: bf16_control("geglu", u, v))
    case("tdp_gathered_aosoa.act.bf16", lm.gated_act_spec("gelu", False),
         [u], {}, AOSOA_W_EW, 1, 4 * nel,
         (9 * nel / PEAK_F32_PER_S * 1e3, "operations"),
         lambda: bf16_control("gelu", u),
         lib=lambda: torch.nn.functional.gelu(u, approximate="tanh"))
    del u, v
    batch, length, n, nstate = BF16F_MAMBA
    nr = batch * length
    xs = [torch.randn(nr, n, device=dev, generator=g).to(bf),
          torch.nn.functional.softplus(torch.randn(nr, n, device=dev,
                                                   generator=g)).to(bf),
          -torch.exp(torch.randn(nstate, n, device=dev, generator=g)),
          torch.ones(1, n, device=dev)]
    consts = {"b": torch.randn(nr, nstate, device=dev, generator=g).to(bf),
              "c": torch.randn(nr, nstate, device=dev, generator=g).to(bf)}
    nbytes = (2 * 3 * nr * n + 4 * (nstate * n + n)
              + batch * (4 * nstate * n + 2 * 2 * length * nstate))
    case("tdp_gathered_aosoa.mamba.bf16",
         lm.mamba_scan_spec(length, nstate, batch), xs, consts,
         AOSOA_W_MAMBA, tp.MAMBA_AOSOA_VVL, nbytes,
         max((nr * n * nstate / PEAK_SFU_PER_S * 1e3, "operations"),
             ((6 * nstate + 3) * nr * n / PEAK_F32_PER_S * 1e3,
              "operations")),
         lambda: mamba_state_rounded(*xs, consts["b"], consts["c"], batch,
                                     length),
         close=scan_close, readings=scan_readings, plain_wall=True,
         also_widths=(12,))
    del xs, consts

    # the entry points under AoSoA in bfloat16, each path counted
    paths = []

    def adrive(path, fn):
        paths.append(path)
        return drive(path, fn)
    h = torch.randn(SERVE_BATCH * 64, d, device=dev, generator=g).to(bf)
    t_rms = Target("cuda", vvl=AOSOA_W, layout="aosoa")
    got = adrive("AoSoA bf16 ops.rmsnorm", lambda: ops.rmsnorm(
        h, w, scale_offset=1.0, target=t_rms, device=dev))
    if not torch.equal(got, ops.rmsnorm(h, w, scale_offset=1.0, device=dev,
                                        target=Target("cuda", vvl=1))):
        problems.append("AoSoA bf16 ops.rmsnorm differs from SoA at VVL 1")
    t_ew = Target("cuda", vvl=AOSOA_W_EW, layout="aosoa")
    for kind, gate in (("geglu", h), ("gelu", None)):
        got = adrive(f"AoSoA bf16 ops.gated_act {kind}",
                     lambda: ops.gated_act(h, gate, kind=kind, target=t_ew,
                                           device=dev))
        if not torch.equal(got, ops.gated_act(h, gate, kind=kind,
                                              device=dev)):
            problems.append(f"AoSoA bf16 ops.gated_act {kind} differs from "
                            f"SoA")
    bm, lm_, dm, nm = 2, 64, 1024, 16
    args = [torch.randn(bm, lm_, dm, device=dev, generator=g).to(bf),
            torch.nn.functional.softplus(torch.randn(
                bm, lm_, dm, device=dev, generator=g)).to(bf),
            torch.randn(bm, lm_, nm, device=dev, generator=g).to(bf),
            torch.randn(bm, lm_, nm, device=dev, generator=g).to(bf),
            -torch.exp(torch.randn(dm, nm, device=dev, generator=g)),
            torch.randn(dm, device=dev, generator=g)]
    got = adrive("AoSoA bf16 ops.mamba_scan", lambda: ops.mamba_scan(
        *args, target=Target("cuda", vvl=AOSOA_W_MAMBA, layout="aosoa"),
        device=dev))
    want = ops.mamba_scan(*args, device=dev, target=Target(
        "cuda", vvl=tp.MAMBA_AOSOA_VVL))
    if not (got[0].dtype == bf and got[1].dtype == torch.float32
            and all(torch.equal(a, b) for a, b in zip(got, want))):
        problems.append("AoSoA bf16 ops.mamba_scan differs from SoA")
    del h, args, got, want
    torch.cuda.empty_cache()
    for r in rows:
        site = r["name"].split(".")[1]
        r["launches_by_path"] = {
            p: by_path[p][("tdp_gathered_aosoa", site)] for p in paths
            if by_path.get(p, {}).get(("tdp_gathered_aosoa", site))}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            problems.append(f"{r['name']} was not launched on the AoSoA "
                            f"bfloat16 main path")
    out["launches_by_path"] = {path: {f"{k}.{s}": c for (k, s), c in
                                      by_path.get(path, {}).items()}
                               for path in paths}
    out["paths"] = paths
    out["phase_s"] = time.perf_counter() - t_start
    log(f"phase 6: AoSoA bfloat16 {out['phase_s']:.1f} s")
    return rows, out


def decomposition_phase(drive, by_path, sims, finals, st0, params,
                        problems) -> dict:
    """Phase 7, the domain decompositions on one card: a one-rank NCCL
    process group (a file store under a temporary directory, no network),
    then ``BinaryFluidSim`` at 128³, 20 steps from phase 4's spinodal
    state, in each regime × slab ``(1,)``, pencil ``(1, 1)`` and block
    ``(1, 1, 1)`` meshes × overlap off and on, each run driven with the
    counts at 0.  The ranks' own exchanges fill every ghost plane, so a
    run launches the no-mesh run's kernels with ghosts read where they
    wrapped: its gathered state is held to phase 4's no-mesh state of the
    regime (its difference printed; bit-equal expected), its collectives
    counted to ``comm_stats()``, its kernel launches to the no-mesh run's
    (the same counts unsplit, every kernel under overlap).  Beside each:
    MLUPS and the no-mesh MLUPS of this process (host clock, median of
    three), the exchange round's device ms a step (CUDA events around
    ``CompiledProgram.exchange``) and the hot loop's step, decomposed and
    not.  One JSON line per run."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.lb.sim import BinaryFluidSim

    prog = importlib.import_module("repro_torch.core.program")
    t_start = time.perf_counter()
    nsites = int(np.prod(GRID))
    out: dict = {"runs": []}

    def mlups(sim):
        rates = []
        sim.run(st0, 2)
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sim.run(st0, STEPS)
            torch.cuda.synchronize()
            rates.append(nsites * STEPS / (time.perf_counter() - t) / 1e6)
        return statistics.median(rates)

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            meshes = {kind: make_mesh((1,) * len(axes), axes)
                      for kind, axes in DECOMPOSITIONS.items()}
            for regime in (False, "one_launch", "two_launch"):
                hot_name = "fused" if regime else "step"
                base = sims[regime]
                want = finals[regime]
                base_counts = by_path[f"BinaryFluidSim fused={regime}"]
                state = {"f": st0.f, "g": st0.g}
                base_mlups = mlups(base)
                kernels_ms = time_ms(
                    lambda: base.programs[hot_name].step(state),
                    reps=PHASE7_REPS, hold=PHASE7_HOLD)
                for kind, mesh in meshes.items():
                    for overlap in (False, True):
                        sim = BinaryFluidSim(
                            GRID, params, fused=regime, mesh=mesh,
                            shard_axis=mesh.mesh_dim_names, overlap=overlap)
                        path = (f"phase 7 BinaryFluidSim fused={regime} "
                                f"{kind} overlap={overlap}")
                        # drive() sets the collectives' count to 0 too
                        st = drive(path, lambda: sim.run(st0, STEPS))
                        counted = prog.collectives["all_to_all_single"]
                        pp = {k: exe.comm_stats()["ppermutes_per_step"]
                              for k, exe in sim.programs.items()}
                        expected = (pp["collide"] + (STEPS - 1) * pp["fused"]
                                    + pp["stream"] if regime
                                    else STEPS * pp["step"])
                        full = sim.gather(st)
                        diff = {k: float((getattr(full, k) - getattr(want, k))
                                         .abs().max()) for k in ("f", "g")}
                        same = all(torch.equal(getattr(full, k),
                                               getattr(want, k))
                                   for k in ("f", "g"))
                        hot = sim.programs[hot_name]
                        cs = hot.comm_stats()
                        prog.collectives["all_to_all_single"] = 0
                        hot.run(state, STEPS)
                        torch.cuda.synchronize()
                        per_step = (prog.collectives["all_to_all_single"]
                                    / STEPS)
                        row = {
                            "regime": str(regime), "decomposition": kind,
                            "mesh": list(mesh.shape), "overlap": hot.overlap,
                            "max_abs_vs_no_mesh": diff, "bit_equal": same,
                            "collectives": counted,
                            "collectives_expected": expected,
                            "collectives_per_step": per_step,
                            "ppermutes_per_step": cs["ppermutes_per_step"],
                            "exchanged_bytes_per_step":
                                cs["exchanged_bytes_per_step"],
                            "interior_fraction": cs["interior_fraction"],
                            "mlups": mlups(sim), "no_mesh_mlups": base_mlups,
                            "exchange_ms_per_step": time_ms(
                                lambda: hot.exchange(state),
                                reps=PHASE7_REPS, hold=PHASE7_HOLD),
                            "step_ms": time_ms(
                                lambda: hot.step(state), reps=PHASE7_REPS,
                                hold=PHASE7_HOLD),
                            "no_mesh_step_ms": kernels_ms,
                            "launches": {f"{k}.{s}": c for (k, s), c in
                                         by_path[path].items()},
                        }
                        out["runs"].append(row)
                        print(json.dumps({"decomposition": row}), flush=True)
                        what = f"phase 7 {regime} {kind} overlap={overlap}"
                        if (counted, per_step) != (
                                expected, cs["ppermutes_per_step"]):
                            problems.append(
                                f"{what}: {counted} collectives in the run, "
                                f"{per_step} a step; comm_stats says "
                                f"{expected}, {cs['ppermutes_per_step']}")
                        if not all(torch.allclose(getattr(full, k),
                                                  getattr(want, k),
                                                  rtol=1e-5, atol=1e-6)
                                   for k in ("f", "g")):
                            problems.append(f"{what}: differs from the "
                                            f"no-mesh run by {diff}")
                        counts = by_path[path]
                        if (counts != base_counts if not overlap else
                                set(counts) != set(base_counts)
                                or any(counts[e] < n
                                       for e, n in base_counts.items())):
                            problems.append(f"{what}: launches {counts}, the "
                                            f"no-mesh run {base_counts}")
                        del sim, st, full
                        torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_start
    log(f"phase 7: decompositions {out['phase_s']:.1f} s")
    return out


def fleet_phase(drive, by_path, make_inputs, prepare, lb_plan, lb_cases,
                params, mlups128, problems) -> tuple[list, dict]:
    """Phase 8, fleets (``tdp.fleet``): the ensemble branches of kernels 1
    and 2 and the fleet service on the card.

    Checks: every LB site function of both executors' ensemble entries at
    3 members, each with its own (tau, tau_phi) row, NaN between members in
    operands and outputs: at 16³ (VVL 1, 2, 4, 8) and at the ragged 67 × 45
    × 70 with phase 3's ghost planes (VVL 1, 4; the windowed ``fused`` at
    plane_block 2 and 8), each member held to its plain version and to its
    single launch at the phase-3 bars (the largest difference from the
    single launch printed by VVL), the gaps left NaN.  Bits, each path driven with the counts at 0: a 4-member unfused
    fleet with a ``tau_phi`` sweep at 16³, 20 steps, against batch-1 fleets
    and solo runs with ``tau_phi`` static; the ``one_launch`` and
    ``two_launch`` regimes (prologue, hot loop, epilogue) as fleets under
    ``cuda_windowed`` and ``cuda`` against solo runs; a fleet step's
    launches against one member's step.  Throughput: 64 members of 32³ per
    regime, aggregate MLUPS (host clock to a synchronize, median of three
    10-step runs), device ms a fleet step (CUDA events), the same members
    one after another through solo ``run``, and 512 members of 16³.  The
    driver drill at 16³: 16 tickets, 40 steps, a ``tau_phi`` sweep; a
    driver restored from a mid-run snapshot finishes every ticket bit-equal
    to an uninterrupted one; one ticket poisoned under
    ``HealthPolicy(fields=("g",), every=2)`` fails with a ``HealthError``
    while the others stay bit-equal; the seconds a snapshot costs.  Then a
    row per ensemble entry at 64 × 32³ for the kernels line."""
    import tempfile

    from repro_torch import tdp
    from repro_torch.core import Target, faults
    from repro_torch.core.api import Ensemble, member_by_member
    from repro_torch.kernels import _build, tdp_pointwise, tdp_windowed
    from repro_torch.lb import programs, stencil
    from repro_torch.lb.sim import BinaryFluidSim

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    out: dict = {"checks": {}}
    max_err: dict = {}
    entries = ([("tdp_gathered", s) for s in _build.SITES]
               + [("tdp_windowed", s) for s in STENCIL_SITES])
    run_ens = {"tdp_gathered": tdp_pointwise.cuda_execute,
               "tdp_windowed": tdp_windowed.windowed_execute}

    def ens_plan(kernel, site, shape, halo, vvl=1, pb=None,
                 taus=FLEET_TAUS):
        plan = lb_plan(kernel, site, shape, halo, vvl, pb)
        t = np.array(taus, np.float32)
        swept = ({"tau": t[:, 0].copy(), "tau_phi": t[:, 1].copy()}
                 if stencil.SPECS[site].consts else {})
        return plan.with_consts(plan.consts, ensemble=Ensemble(len(t),
                                                               swept))

    def gapped(members, gap=FLEET_GAP):
        """``(B, *shape)`` view of a buffer holding the members with
        ``gap`` floats of NaN after each; ``(view, buffer)``."""
        per = members[0].numel()
        buf = torch.full((len(members), per + gap), float("nan"),
                         device=dev)
        view = buf[:, :per].view(len(members), *members[0].shape)
        for i, m in enumerate(members):
            view[i].copy_(m)
        return view, buf

    def ens_fields(spec, shape, halo, nmembers, seed, gap=FLEET_GAP):
        per = [prepare(spec, make_inputs(spec, shape, halo, seed=seed + m),
                       shape, halo) for m in range(nmembers)]
        return tuple(gapped([p[i] for p in per], gap)[0]
                     for i in range(len(spec.fields)))

    # -- checks: every ensemble entry against its plain version ------------
    for kernel, site in entries:
        spec = stencil.SPECS[site]
        pbs = ((tdp_windowed.DEFAULT_PLANE_BLOCK, 8)
               if (kernel, site) == ("tdp_windowed", "fused") else (None,))
        if spec.has_stencil:
            cases = [(FLEET_SMALL, (0, 0, 0), (1, 2, 4, 8))] + [
                (shape, halo, (1, 4)) for shape, halo, _ in
                lb_cases(kernel, site) if shape == LB_RAGGED]
        else:
            cases = [((int(np.prod(FLEET_SMALL)),), (0,), (1, 2, 4, 8)),
                     ((int(np.prod(LB_RAGGED)),), (0,), (1, 4))]
        err, single = 0.0, {}
        for shape, halo, vvls in cases:
            B = len(FLEET_TAUS)
            fields = ens_fields(spec, shape, halo, B,
                                seed=200 + _build.SITE_ID[site])
            n = int(np.prod(shape))
            want = member_by_member(ens_plan(kernel, site, shape, halo),
                                    fields, None, tdp_pointwise.fields_plain)
            for vvl in vvls:
                for pb in pbs:
                    plan = ens_plan(kernel, site, shape, halo, vvl, pb)
                    obufs = [gapped([torch.full((c, n), float("nan"),
                                                device=dev)] * B)
                             for c in spec.out]
                    got = run_ens[kernel](plan, fields,
                                          tuple(v for v, _ in obufs))
                    torch.cuda.synchronize()
                    what = (f"phase 8 {kernel}_ensemble.{site} vvl={vvl} "
                            f"plane_block={pb} shape={shape} halo={halo}")
                    for _, buf in obufs:
                        if not buf[:, buf.shape[1] - FLEET_GAP:].isnan().all():
                            problems.append(f"{what}: wrote between members")
                    for m in range(B):
                        gm = [g[m] for g in got]
                        compare(site, gm, [w[m] for w in want],
                                f"{what} member {m}", problems)
                        err = max(err, max_abs(gm, [w[m] for w in want]))
                        one = run_ens[kernel](plan.member_plan(m),
                                              tuple(x[m] for x in fields))
                        compare(site, gm, one, f"{what} member {m} against "
                                f"its single launch", problems)
                        single[vvl] = max(single.get(vvl, 0.0),
                                          max_abs(gm, one))
            del fields, want
        max_err[(kernel, site)] = err
        out["checks"][f"{kernel}_ensemble.{site}"] = {
            "max_abs_err": err, "max_abs_vs_single_launch_by_vvl": single}
        log(f"phase 8: {kernel}_ensemble.{site} max_abs_err={err} "
            f"max |member - single launch| by VVL {single}")
    torch.cuda.empty_cache()

    # -- bits: fleets against batch-1 fleets and solo runs -----------------
    def build_unfused(tau_phi):
        phys = params.as_kwargs()
        phys["tau_phi"] = tau_phi
        return programs.unfused_step_program(
            programs.collision_consts(np.float32, **phys))

    def as_path(counts, suffix):
        """``{site: launches}`` of one executor family in ``counts``."""
        return {(k[:-len(suffix)] if k.endswith(suffix) else k, s): c
                for (k, s), c in counts.items()}

    sim16 = BinaryFluidSim(FLEET_SMALL, params)
    ms = [{"f": st.f, "g": st.g}
          for st in (sim16.init_spinodal(seed=s) for s in range(4))]
    sweep = np.array(FLEET_SWEEP, np.float32)
    cuda = Target("cuda")
    fleet = build_unfused(tdp.BatchedConst(sweep)).compile(
        cuda, grid_shape=FLEET_SMALL).vmap(4)
    path = "phase 8 fleet unfused tau_phi sweep 16^3"
    got = drive(path, lambda: fleet.run(tdp.ProgramState.stack(ms), STEPS))
    bits = {"sweep_vs_batch1": [], "sweep_vs_solo_static": []}
    for i in range(4):
        f1 = build_unfused(tdp.BatchedConst(sweep[i:i + 1])).compile(
            cuda, grid_shape=FLEET_SMALL).vmap(1)
        r1 = f1.run({k: v[None] for k, v in ms[i].items()}, STEPS)
        solo = build_unfused(tdp.TargetConst(sweep[i])).compile(
            cuda, grid_shape=FLEET_SMALL)
        spath = f"phase 8 solo unfused tau_phi={FLEET_SWEEP[i]} 16^3"
        rs = drive(spath, lambda: solo.run(dict(ms[i]), STEPS))
        bits["sweep_vs_batch1"].append(max(float(
            (got[f][i] - r1[f][0]).abs().max()) for f in ("f", "g")))
        bits["sweep_vs_solo_static"].append(max(float(
            (got[f][i] - rs[f]).abs().max()) for f in ("f", "g")))
        if as_path(by_path[path], "_ensemble") != by_path[spath]:
            problems.append(f"{path}: launches {by_path[path]}, a member's "
                            f"solo run {by_path[spath]}")
    for k, diffs in bits.items():
        if any(diffs):
            problems.append(f"phase 8 {k}: members differ by {diffs}")
    consts = programs.collision_consts(np.float32, **params.as_kwargs())
    for mode in ("one_launch", "two_launch"):
        for backend in ("cuda_windowed", "cuda"):
            tgt = Target(backend)
            seq = [programs.collide_program(consts),
                   programs.fused_program(mode, consts),
                   programs.stream_program()]
            cps = [p.compile(tgt, grid_shape=FLEET_SMALL) for p in seq]
            fleets = [cp.vmap(4) for cp in cps]
            steps = (1, STEPS - 1, 1)

            def regime_run(runs, state):
                for r, n_ in zip(runs, steps):
                    state = r.run(state, n_)
                return state

            path = f"phase 8 fleet {mode} {backend} 16^3"
            gf = drive(path, lambda: regime_run(
                fleets, tdp.ProgramState.stack(ms)))
            spath = f"phase 8 solo {mode} {backend} 16^3"
            diffs = []
            for i in range(4):
                rs = (drive(spath, lambda: regime_run(cps, dict(ms[i])))
                      if i == 0 else regime_run(cps, dict(ms[i])))
                diffs.append(max(float((gf[f][i] - rs[f]).abs().max())
                                 for f in ("f", "g")))
            bits[f"{mode}_{backend}_vs_solo"] = diffs
            if any(diffs):
                problems.append(f"{path}: members differ from solo runs by "
                                f"{diffs}")
            if as_path(by_path[path], "_ensemble") != by_path[spath]:
                problems.append(f"{path}: launches {by_path[path]}, a "
                                f"member's solo run {by_path[spath]}")
    out["bits"] = bits
    log(f"phase 8: bits {bits}")
    del fleet, got, fleets, gf
    torch.cuda.empty_cache()

    # -- throughput ----------------------------------------------------------
    def states(nmembers, grid):
        sim = BinaryFluidSim(grid, params)
        return tdp.ProgramState.stack([
            {"f": st.f, "g": st.g}
            for st in (sim.init_spinodal(seed=s) for s in range(nmembers))])

    def rate(fn, sites):
        rates = []
        fn()
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates.append(sites * FLEET_STEPS / (time.perf_counter() - t)
                         / 1e6)
        return statistics.median(rates)

    regimes = {"unfused": (programs.unfused_step_program(consts), "cuda"),
               "one_launch": (programs.fused_program("one_launch", consts),
                              "cuda_windowed"),
               "two_launch": (programs.fused_program("two_launch", consts),
                              "cuda_windowed")}
    thr = {}
    for label, (B, grid) in (("64x32^3", FLEET_BIG), ("512x16^3",
                                                      FLEET_WIDE)):
        st = states(B, grid)
        sites = B * int(np.prod(grid))
        for regime, (prog, backend) in regimes.items():
            cp = prog.compile(Target(backend), grid_shape=grid)
            fl = cp.vmap(B)
            row = {"members": B, "grid": list(grid), "sites": sites,
                   "fleet_mlups": rate(lambda: fl.run(st, FLEET_STEPS),
                                       sites),
                   "fleet_step_ms": time_ms(lambda: fl.step(st), reps=10,
                                            hold=SHORT_HOLD)}
            if label == "64x32^3":
                path = f"phase 8 fleet step {regime} {label}"
                drive(path, lambda: fl.step(st))
                spath = f"phase 8 solo step {regime} 32^3"
                member0 = st.member(0)
                drive(spath, lambda: cp.step(member0))
                row["launches_per_fleet_step"] = {
                    f"{k}.{s}": c for (k, s), c in by_path[path].items()}
                row["launches_per_member_step"] = {
                    f"{k}.{s}": c for (k, s), c in by_path[spath].items()}
                if as_path(by_path[path], "_ensemble") != by_path[spath]:
                    problems.append(f"{path}: launches {by_path[path]}, "
                                    f"one member's {by_path[spath]}")
                row["member_step_ms"] = time_ms(lambda: cp.step(member0),
                                                reps=10, hold=SHORT_HOLD)
                members = st.unstack()

                def solo_loop():
                    for m in members:
                        cp.run(m, FLEET_STEPS)
                row["solo_loop_mlups"] = rate(solo_loop, sites)
                row["mlups_128cubed_phase4"] = mlups128.get(
                    "False" if regime == "unfused" else regime)
            thr[f"{regime} {label}"] = row
            log(f"phase 8: throughput {regime} {label} {row}")
        del st
        torch.cuda.empty_cache()
    out["throughput"] = thr

    # -- the driver drill ----------------------------------------------------
    prog = build_unfused(tdp.TargetConst(np.float32(1.0)))
    taus = np.linspace(0.8, 1.2, DRILL_TICKETS).astype(np.float32)
    ms16 = [{"f": st.f, "g": st.g} for st in
            (sim16.init_spinodal(seed=100 + s) for s in range(DRILL_TICKETS))]

    def submit_all(drv):
        return [drv.submit(prog, {"state": ms16[i],
                                  "consts": {"tau_phi": taus[i]}},
                           DRILL_STEPS) for i in range(DRILL_TICKETS)]

    drill: dict = {}
    ref = tdp.FleetDriver(cuda, batch=DRILL_TICKETS)
    ref_ts = submit_all(ref)
    t = time.perf_counter()
    want = drive("phase 8 driver 16 tickets 40 steps", ref.drain)
    drill["uninterrupted_s"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as ck:
        a = tdp.FleetDriver(cuda, batch=DRILL_TICKETS, checkpoint_dir=ck,
                            checkpoint_every=4)
        submit_all(a)
        a.pump(DRILL_SNAPSHOT)
        a._ckpt.wait()
        t = time.perf_counter()
        a.checkpoint(blocking=False)
        drill["snapshot_host_copy_s"] = time.perf_counter() - t
        a._ckpt.wait()
        drill["snapshot_total_s"] = time.perf_counter() - t
        t = time.perf_counter()
        a.checkpoint(blocking=True)
        drill["snapshot_blocking_s"] = time.perf_counter() - t
        b = tdp.FleetDriver.restore(ck, prog, device=dev, target=cuda,
                                    batch=DRILL_TICKETS)
        steps_at = sorted({t_.step for t_ in b._tickets.values()})
        got = b.drain()
    drill["restored_at_steps"] = steps_at
    drill["restored_equal"] = all(
        torch.equal(got[t_.id][f], want[t_.id][f])
        for t_ in ref_ts for f in ("f", "g"))
    if not drill["restored_equal"] or steps_at != [DRILL_SNAPSHOT]:
        problems.append(f"phase 8 restore: steps {steps_at}, equal "
                        f"{drill['restored_equal']}")
    c = tdp.FleetDriver(cuda, batch=DRILL_TICKETS,
                        health=tdp.HealthPolicy(fields=("g",), every=2))
    cts = submit_all(c)
    c.inject(faults.nan_at_step(cts[1].id, "g", DRILL_POISON))
    got = c.drain()
    p = c.poll(cts[1])
    drill["quarantined"] = {"status": p["status"], "error": str(p["error"])}
    drill["others_equal"] = all(
        torch.equal(got[t_.id][f], want[t_.id][f])
        for t_ in cts if t_ is not cts[1] for f in ("f", "g"))
    if p["status"] != "failed" or not isinstance(p["error"],
                                                 tdp.HealthError) \
            or not drill["others_equal"]:
        problems.append(f"phase 8 chaos: {drill['quarantined']}, others "
                        f"equal {drill['others_equal']}")
    out["driver"] = drill
    log(f"phase 8: driver drill {drill}")
    del ref, a, b, c, got, want
    torch.cuda.empty_cache()

    # -- rows: each ensemble entry at 64 members of 32^3 ---------------------
    launches = {e: sum(p.get((e[0] + "_ensemble", e[1]), 0)
                       for name, p in by_path.items()
                       if name.startswith("phase 8"))
                for e in entries}
    launches_by_path = {
        e: {name: p[(e[0] + "_ensemble", e[1])] for name, p in by_path.items()
            if (e[0] + "_ensemble", e[1]) in p} for e in entries}
    B, grid = FLEET_BIG
    n = int(np.prod(grid))
    rows = []
    for kernel, site in entries:
        spec = stencil.SPECS[site]
        shape = grid if spec.has_stencil else (n,)
        halo = (0,) * len(shape)
        fields = ens_fields(spec, shape, halo, B, seed=300, gap=0)
        plan = ens_plan(kernel, site, shape, halo,
                        taus=[FLEET_TAUS[m % len(FLEET_TAUS)]
                              for m in range(B)])

        def kern():
            return run_ens[kernel](plan, fields)

        def plain():
            return member_by_member(plan, fields, None,
                                    tdp_pointwise.fields_plain)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        what = f"phase 8 {kernel}_ensemble.{site} {B}x{grid}"
        compare(site, got, want, what, problems)
        name = (kernel, site)
        max_err[name] = max(max_err[name], max_abs(got, want))
        lib = library_call(site, fields, n, batch=B)
        library_ms = None
        if lib is not None:
            lib_out = lib[1](lib[0]())
            compare("library", lib_out, want, f"library for {what}",
                    problems)
            library_ms = time_ms(lib[0], hold=SHORT_HOLD)
        del got, want
        b_ms, b_by = bound(site, B * n)
        rows.append({
            "name": f"{kernel}_ensemble.{site}", "route": "cuda",
            **KERNELS[f"{kernel}_ensemble"],
            "launches": launches[name],
            "launches_by_path": launches_by_path[name],
            "max_abs_err": max_err[name],
            "ms": time_ms(kern, hold=SHORT_HOLD),
            "plain_ms": wall_ms(plain, reps=1, warmup=0), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": library_ms, "members": B, "grid": list(shape)})
        log(f"phase 8: {rows[-1]['name']} ms={rows[-1]['ms']:.4f} "
            f"plain={rows[-1]['plain_ms']:.3f} library={library_ms} "
            f"bound={b_ms:.4f} launches={launches[name]}")
        if launches[name] == 0:
            problems.append(f"{kernel}_ensemble.{site} was not launched on "
                            f"phase 8's main path")
        del fields
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_start
    log(f"phase 8: fleets {out['phase_s']:.1f} s")
    return rows, out


def train_run(argv, drive, path):
    """``launch.train``'s run (the function its ``main`` calls) as one
    counted path; returns (trainer, history, peak device GB)."""
    from repro_torch.launch import train as train_mod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, hist = drive(path, lambda: train_mod.train(
        train_mod.parse_args(argv)))
    return trainer, hist, torch.cuda.max_memory_allocated() / 1e9


def profile_train_step(trainer) -> dict:
    """One more training step under ``torch.profiler``: device ms by the
    port's kernels, matrix products and the rest, and the share of the
    step's device time inside the four ``Function``s' plain backward
    passes (the device time of their autograd nodes' subtrees)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_steps(1)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    split = {k: 0.0 for k in ("rmsnorm", "gated", "mamba", "flash_attention",
                              "gemm", "rest")}
    for name, us in by_name.items():
        split[next((k for k, ks in TRAIN_KERNEL_NAMES.items()
                    if any(s in name for s in ks)),
                   "gemm" if any(s in name.lower() for s in GEMM_NAMES)
                   else "rest")] += us
    busy = sum(by_name.values())
    bwd_nodes = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and any(e.name.endswith(f) for f in BACKWARD_NODES)]
    # count each node's subtree once: skip nodes inside another one
    ids = {id(e) for e in bwd_nodes}

    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if id(p) in ids:
                return True
            p = p.cpu_parent
        return False
    bwd_us = {f: 0.0 for f in BACKWARD_NODES}
    for e in bwd_nodes:
        if not nested(e):
            f = next(f for f in BACKWARD_NODES if e.name.endswith(f))
            bwd_us[f] += e.device_time_total
    return {"device_ms": busy / 1e3,
            "device_ms_by_part": {k: v / 1e3 for k, v in split.items()},
            "plain_backward_ms": {k: v / 1e3 for k, v in bwd_us.items()},
            "plain_backward_share": (sum(bwd_us.values()) / busy
                                     if busy else None),
            "kernels_traced": len(kernels),
            "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:15]}}


def grad_check(name, kernel_fn, plain_fn, inputs, problems, *, extra=None):
    """One kernel ``Function`` at a training shape: its output and the
    gradients of every input through it against the plain version's
    (``LM_TOL``), then timed: the kernel's forward alone, forward +
    backward through the ``Function``, and the plain version's forward +
    backward (CUDA events, median of ``GRAD_REPS``)."""
    g = torch.Generator(device=inputs[0].device).manual_seed(17)
    out_k, out_p = kernel_fn(*inputs), plain_fn(*inputs)
    if out_k.grad_fn is None:
        problems.append(f"phase 9 {name}: the kernel output has no grad_fn")
    dy = torch.randn(out_p.shape, device=out_p.device, generator=g)
    gk = torch.autograd.grad(out_k, inputs, dy)
    gp = torch.autograd.grad(out_p, inputs, dy)
    torch.cuda.synchronize()
    out_err = max_abs((out_k.detach(),), (out_p.detach(),))
    grad_err = max_abs(gk, gp)
    ok = all(torch.isfinite(a).all() and torch.allclose(a, b, **LM_TOL)
             for a, b in zip((out_k.detach(), *gk), (out_p.detach(), *gp)))
    if not ok:
        problems.append(f"phase 9 {name}: max |kernel - plain| output "
                        f"{out_err}, gradients {grad_err}")
    del out_k, out_p, gk, gp
    plain_in = [x.detach() for x in inputs]
    fwd_ms = time_ms(lambda: kernel_fn(*plain_in), reps=GRAD_REPS)
    fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        kernel_fn(*inputs), inputs, dy), reps=GRAD_REPS)
    plain_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        plain_fn(*inputs), inputs, dy), reps=GRAD_REPS)
    res = {"shape": [list(x.shape) for x in inputs], "output_max_abs_err":
           out_err, "grad_max_abs_err": grad_err, "fwd_ms": fwd_ms,
           "fwd_bwd_ms": fwd_bwd_ms, "bwd_ms": fwd_bwd_ms - fwd_ms,
           "plain_fwd_bwd_ms": plain_fwd_bwd_ms, **(extra or {})}
    log(f"phase 9: {name} {res}")
    torch.cuda.empty_cache()
    return res


def training_grad_checks(problems, device="cuda") -> dict:
    """The four kernel ``Function``s at the training path's full-width
    shapes (``TRAIN_GRAD_SHAPES``), and kernel 4's log-sum-exp against the
    plain ``logsumexp``."""
    from repro_torch.kernels import flash_attention, ops, ref
    from repro_torch.models.ssm import _chunked_scan
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(23)

    def leaf(*shape, scale=1.0):
        return (scale * torch.randn(shape, device=dev, generator=g)
                ).requires_grad_()
    out = {}
    for tokens, d in TRAIN_GRAD_SHAPES["rmsnorm"]:
        x, w = leaf(tokens, d), leaf(d, scale=0.1)
        out[f"rmsnorm ({tokens}, {d})"] = grad_check(
            f"_RMSNormFn ({tokens}, {d})",
            lambda x, w: ops.rmsnorm(x, w, target="cuda", scale_offset=1.0,
                                     device=dev),
            lambda x, w: ref.rmsnorm_ref(x, w, scale_offset=1.0), [x, w],
            problems)
    tokens, f = TRAIN_GRAD_SHAPES["gated"]
    u, v = leaf(tokens, f), leaf(tokens, f)
    out[f"gated geglu ({tokens}, {f})"] = grad_check(
        f"_GatedActFn geglu ({tokens}, {f})",
        lambda u, v: ops.gated_act(u, v, kind="geglu", target="cuda",
                                   device=dev),
        lambda u, v: ref.gated_act_ref(u, v, kind="geglu"), [u, v], problems)
    del x, w, u, v
    b, hq, hkv, s, dh = TRAIN_GRAD_SHAPES["flash_attention"]
    q, k, v = leaf(b, hq, s, dh), leaf(b, hkv, s, dh), leaf(b, hkv, s, dh)
    for variant, window in (("local", 4096), ("attn", 0)):
        kw = dict(causal=True, window=window, softcap=50.0)
        o, lse = flash_attention.flash_attention(
            q.detach(), k.detach(), v.detach(), return_lse=True, **kw)
        _, want = ref.attention_ref(q.detach(), k.detach(), v.detach(),
                                    return_lse=True, **kw)
        lse_err = float((lse - want).abs().max())
        if not torch.allclose(lse, want, **LM_TOL):
            problems.append(f"phase 9 flash {variant}: lse differs by "
                            f"{lse_err}")
        o2 = flash_attention.flash_attention(q.detach(), k.detach(),
                                             v.detach(), **kw)
        if not torch.equal(o, o2):
            problems.append(f"phase 9 flash {variant}: the output with the "
                            f"lse store differs from the one without")
        plain_in = [q.detach(), k.detach(), v.detach()]
        lse_ms = time_ms(lambda kw=kw: flash_attention.flash_attention(
            *plain_in, return_lse=True, **kw), reps=GRAD_REPS)
        out[f"flash_attention {variant} {[b, hq, hkv, s, dh]}"] = grad_check(
            f"_FlashFn {variant}",
            lambda q, k, v, kw=kw: ops.flash_attention(
                q, k, v, target="cuda", device=dev, **kw),
            lambda q, k, v, kw=kw: ref.attention_ref(q, k, v, **kw),
            [q, k, v], problems,
            extra={"lse_max_abs_err": lse_err, "fwd_lse_ms": lse_ms})
        del o, o2, lse, want
    del q, k, v
    bsz, length, di, n = TRAIN_GRAD_SHAPES["mamba"]
    x = leaf(bsz, length, di)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, length, di, device=dev, generator=g) - 2.0
    ).requires_grad_()
    bm, cm = leaf(bsz, length, n), leaf(bsz, length, n)
    a = (-torch.exp(0.5 * torch.randn(di, n, device=dev, generator=g))
         ).requires_grad_()
    dsk = leaf(di)
    out[f"mamba ({bsz}, {length}, {di}, {n})"] = grad_check(
        "_MambaScanFn",
        lambda *xs: ops.mamba_scan(*xs, target="cuda", device=dev,
                                   chunk=128)[0],
        lambda *xs: _chunked_scan(*xs, chunk=128)[0],
        [x, dt, bm, cm, a, dsk], problems)
    return out


def trainer_for(cfg, backend, ckpt_dir, steps, *, ckpt_every=0, seq_len=256,
                batch=8, accum=2, device="cuda", param_dtype="float32",
                quant_moments=False):
    """A ``Trainer`` the way ``launch.train`` builds one (its flags'
    defaults, ``TRAIN_WARMUP``; ``quant_moments`` its
    ``--quant-moments``), for a config the CLI cannot name or a
    ``param_dtype`` it does not take."""
    from repro_torch.data import SyntheticConfig
    from repro_torch.models.context import ExecContext
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig, TrainHParams
    return Trainer(
        cfg, None, SyntheticConfig(cfg.vocab_size, seq_len, batch, seed=0),
        AdamWConfig(quantize_moments=quant_moments),
        TrainHParams(warmup_steps=TRAIN_WARMUP, total_steps=steps,
                     grad_accum=accum),
        TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                      log_every=1, log=log, param_dtype=param_dtype),
        ctx=ExecContext(backend=backend, remat="block"), device=device)


def leaf_names(tree, prefix="") -> list[str]:
    """The paths of ``tree``'s leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


@contextlib.contextmanager
def first_step_leaf_norms():
    """Yields a dict that gets, on the host, the name and norm of every
    gradient leaf the first train step inside the block hands to AdamW
    (``runtime.steps`` looks ``adamw_update`` up at each step): a run keeps
    no gradients, and two full-width runs do not fit on the card
    together."""
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import steps
    adamw_update, store = steps.adamw_update, {}

    def update(params, grads, state, cfg, **kw):
        if not store:
            store["names"] = leaf_names(grads)
            store["norms"] = torch.stack([
                torch.linalg.vector_norm(g.float())
                for g in tree_leaves(grads)]).tolist()
        return adamw_update(params, grads, state, cfg, **kw)
    steps.adamw_update = update
    try:
        yield store
    finally:
        steps.adamw_update = adamw_update


def hold_to_oracle(what, kern_hist, plain_hist, kern_leaves, plain_leaves,
                   problems, tol=TRAIN_TOL) -> dict:
    """Step 1 on the kernels against the plain path at ``tol``: the
    loss, the global gradient norm and the worst leaf's gradient norm."""
    k, p = kern_hist[0], plain_hist[0]
    res = {key: {"kernels": k[key], "plain": p[key],
                 "rel_diff": abs(k[key] - p[key]) / abs(p[key])}
           for key in ("loss", "grad_norm")}
    if kern_leaves["names"] != plain_leaves["names"]:
        problems.append(f"{what}: the two runs' gradient trees differ")
        return res
    rel = [abs(a - b) / b if b else abs(a)
           for a, b in zip(kern_leaves["norms"], plain_leaves["norms"])]
    worst = int(np.argmax(rel))
    res["leaf_grad_norm"] = {
        "leaves": len(rel), "worst_leaf": kern_leaves["names"][worst],
        "kernels": kern_leaves["norms"][worst],
        "plain": plain_leaves["norms"][worst], "rel_diff": rel[worst],
        "rel_diff_median": float(np.median(rel))}
    finite = all(math.isfinite(x) for x in
                 (k["loss"], k["grad_norm"], *kern_leaves["norms"]))
    for key, rtol in tol.items():
        if not (finite and res[key]["rel_diff"] <= rtol):
            problems.append(f"{what}: step-1 {key} "
                            f"{res[key]['kernels']} on the kernels, "
                            f"{res[key]['plain']} on the plain path (rtol "
                            f"{rtol})")
    return res


def training_phase(drive, by_path, problems, device="cuda") -> dict:
    """Phase 9: training on the card (see the module docstring)."""
    import tempfile
    t_phase = time.perf_counter()
    out = {"tolerance": {"grads": LM_TOL, "step1_vs_plain": TRAIN_TOL}}
    out["functions"] = training_grad_checks(problems, device)

    # gemma2-2b at full width and depth through launch.train, then the
    # same first step on the plain path, one after the other
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = TRAIN_ARGS + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", tmp,
                         "--device", device]
    path = f"gemma2-2b train {TRAIN_STEPS} steps (cuda)"
    with first_step_leaf_norms() as leaves:
        trainer, hist, peak_gb = train_run(argv, drive, path)
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    tokens = trainer.data_cfg.global_batch * trainer.data_cfg.seq_len
    gemma = {"params": trainer.cfg.num_params(), "steps": len(hist),
             "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
             "step_ms": [h["ms"] for h in hist],
             "step_ms_median_2_to_6": step_ms,
             "tokens_per_s": tokens / step_ms * 1e3,
             "peak_memory_gb": peak_gb, "launches": {
                 f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    half = TRAIN_STEPS // 2
    if len(hist) != TRAIN_STEPS or not (np.mean(losses[half:])
                                        < np.mean(losses[:half])):
        problems.append(f"phase 9 gemma2-2b: the loss did not fall over "
                        f"{TRAIN_STEPS} steps (mean of the last {half} "
                        f"against the first {half}): {losses}")
    gemma_layers = trainer.cfg.n_layers
    gemma["profile"] = profile_train_step(trainer)
    del trainer
    torch.cuda.empty_cache()
    plain_path = "gemma2-2b train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves:
        _, plain_hist, plain_gb = train_run(
            TRAIN_ARGS + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                          tmp + "_plain", "--device", device], drive,
            plain_path)
    gemma["plain_step1_ms"] = plain_hist[0]["ms"]
    gemma["plain_peak_memory_gb"] = plain_gb
    gemma["step1_vs_plain"] = hold_to_oracle("phase 9 gemma2-2b", hist,
                                             plain_hist,
                                             leaves, plain_leaves, problems)
    out["gemma2-2b"] = gemma
    torch.cuda.empty_cache()

    # resume from a checkpoint: 3 steps, a fresh trainer on the directory
    # runs to 6; against 6 uninterrupted steps at the same seed
    from repro_torch import configs
    small = configs.get_smoke("gemma2-2b")
    a = trainer_for(small, "cuda", tmp + "_ab", RESUME_STEPS[1],
                    ckpt_every=RESUME_STEPS[0], seq_len=64, device=device)
    drive("gemma2 smoke train 3 steps (cuda)",
          lambda: a.train_steps(RESUME_STEPS[0]))
    a.ckpt.wait()
    b = trainer_for(small, "cuda", tmp + "_ab", RESUME_STEPS[1],
                    ckpt_every=RESUME_STEPS[0], seq_len=64, device=device)
    drive("gemma2 smoke resume to 6 (cuda)", lambda: b.run(RESUME_STEPS[1]))
    ref_run = trainer_for(small, "cuda", tmp + "_ref", RESUME_STEPS[1],
                          ckpt_every=RESUME_STEPS[0], seq_len=64,
                          device=device)
    drive("gemma2 smoke train 6 steps (cuda)",
          lambda: ref_run.run(RESUME_STEPS[1]))
    from repro_torch.optim.tree import tree_leaves
    diffs = [float((x - y).detach().abs().max()) for x, y in
             zip(tree_leaves(ref_run.params), tree_leaves(b.params))]
    out["resume"] = {"config": small.name, "steps": list(RESUME_STEPS),
                     "restored_step": RESUME_STEPS[0],
                     "final_step": b.step, "params_max_abs_diff": max(diffs),
                     "bit_equal": max(diffs) == 0.0}
    if b.step != RESUME_STEPS[1] or max(diffs) != 0.0:
        problems.append(f"phase 9 resume: step {b.step}, parameters differ "
                        f"from the uninterrupted run by {max(diffs)}")
    del a, b, ref_run
    torch.cuda.empty_cache()

    # falcon-mamba-7b at full width, FALCON_LAYERS layers
    fcfg = configs.first_layers(configs.get_config("falcon-mamba-7b"),
                                FALCON_LAYERS)
    fpath = f"falcon-mamba-7b x{FALCON_LAYERS} train {FALCON_STEPS} steps (cuda)"
    torch.cuda.reset_peak_memory_stats()
    ft = trainer_for(fcfg, "cuda", tmp + "_fm", FALCON_STEPS, device=device)
    with first_step_leaf_norms() as fleaves:
        fhist = drive(fpath, lambda: ft.run(FALCON_STEPS))
    falcon = {"layers": FALCON_LAYERS, "params": fcfg.num_params(),
              "losses": [h["loss"] for h in fhist],
              "grad_norms": [h["grad_norm"] for h in fhist],
              "step_ms": [h["ms"] for h in fhist],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": {f"{k}.{s}": n
                           for (k, s), n in by_path[fpath].items()}}
    del ft
    torch.cuda.empty_cache()
    fp = trainer_for(fcfg, "torch", tmp + "_fm_plain", 1, device=device)
    with first_step_leaf_norms() as fplain_leaves:
        fplain = drive(f"falcon-mamba-7b x{FALCON_LAYERS} train step 1 "
                       f"(torch)", lambda: fp.run(1))
    falcon["step1_vs_plain"] = hold_to_oracle(
        "phase 9 falcon-mamba-7b", fhist, fplain, fleaves, fplain_leaves, problems)
    del fp
    torch.cuda.empty_cache()
    out["falcon-mamba-7b"] = falcon

    # every kernel of the path ran, as often as the forward and its remat
    # recompute call it (each layer twice a microbatch, the final norm
    # once); none on the plain path
    for p, arch, steps, n_layers in (
            (path, "gemma2-2b", TRAIN_STEPS, gemma_layers),
            (fpath, "falcon-mamba-7b", FALCON_STEPS, FALCON_LAYERS)):
        micro = steps * 2                              # --grad-accum 2
        want = {e: micro * (2 * n * n_layers + (e[1] == "rmsnorm"))
                for e, n in TRAIN_NEEDS[arch].items()}
        if by_path[p] != want:
            problems.append(f"phase 9 {p}: launches {by_path[p]}, expected "
                            f"{want}")
    for p in (plain_path,
              f"falcon-mamba-7b x{FALCON_LAYERS} train step 1 (torch)"):
        if by_path[p]:
            problems.append(f"phase 9 {p}: the plain path launched "
                            f"{by_path[p]}")
    shutil.rmtree(tmp, ignore_errors=True)
    for suffix in ("_plain", "_ab", "_ref", "_fm", "_fm_plain"):
        shutil.rmtree(tmp + suffix, ignore_errors=True)
    out["paths"] = [p for p in by_path if " train " in p or " resume " in p]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 9: training {out['phase_s']:.1f} s")
    return out


def lm_row_key(row):
    """The launch counter entry of an LM kernel row, None for another."""
    kernel, _, rest = row["name"].partition(".")
    site = rest.partition(".")[0]
    key = (("flash_attention", "flash_attention")
           if kernel == "flash_attention" else (kernel, site))
    if kernel not in ("tdp_gathered", "flash_attention") or (
            key[1] not in ROW_FUNCTIONS):
        return None
    return key


def merge_launches(rows, by_path, paths) -> None:
    """Add the launches of ``paths`` to the LM kernel rows (phases 9 and 10
    run after phase 5 counted the rows' launches)."""
    for row in rows:
        key = lm_row_key(row)
        for p in paths if key else ():
            n = by_path[p].get(key, 0)
            if n:
                row["launches"] += n
                row["launches_by_path"][p] = n


def merge_training_launches(rows, by_path, training: dict) -> None:
    """Add phase 9's paths to the LM kernel rows: their launches, the
    Function each runs under, and the Function's checks and times."""
    merge_launches(rows, by_path, training["paths"])
    fn_results = training["functions"]
    for row in rows:
        key = lm_row_key(row)
        if key is None:
            continue
        kernel, _, rest = row["name"].partition(".")
        site, _, variant = rest.partition(".")
        row["function"] = ROW_FUNCTIONS[key[1]]
        # the Function's checks and times at the training shapes: on the
        # site's first row, and on flash's local and global rows
        prefix = (f"flash_attention {site} " if kernel == "flash_attention"
                  else None if variant or site == "act" else site)
        if prefix:
            row["training"] = {k: v for k, v in fn_results.items()
                               if k.startswith(prefix)}


def dense_rows(launches, launches_by_path, max_err, problems, record, *,
               rms_rows=DENSE_RMS_ROWS, ew_rows=DENSE_EW_ROWS,
               attn_rows=DENSE_ATTN_ROWS, dtype=torch.float32) -> list:
    """Phase 5, the dense archs' shapes (``DENSE_*_ROWS``, or granite's
    ``MOE_*_ROWS``): each kernel held
    to its plain version, then timed beside it, its bound and, where one
    PyTorch call computes the same function, that call (``lm_row``):
    ``F.rms_norm``; ``scaled_dot_product_attention`` (``enable_gqa``),
    ``is_causal`` for a global layer and a boolean band mask for gemma3's
    window; none for SwiGLU (``silu(g) * u``: two calls) and squared ReLU
    (``relu(x).square()``: two calls).  An attention row may end in a
    softcap (no SDPA then).  In bfloat16 (phase 15's ``BF16_*_ROWS``) the
    inputs are rounded to it, each row is held by ``bf16_close`` against a
    control that must fail it (``bf16_control``), the library call, which
    rounds otherwise, is recorded but not held, the bounds count 2 bytes
    an element and kernel 4's work at ``BF16_ATTN_PER_FLOP``, and the
    timings take the short spin (``SHORT_HOLD``) and no VVL sweep."""
    import torch.nn.functional as F
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import flash_attention, lm, ref, tdp_pointwise
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    bf = dtype == torch.bfloat16
    esize = torch.finfo(dtype).bits // 8
    hold = (dict(close=bf16_close, readings=bf16_readings,
                 hold_library=False, hold=SHORT_HOLD) if bf else {})
    rows = []

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=g)).to(dtype)

    def pointwise_row(name, spec, xs, consts, nbytes, flops, control):
        plan = launch_plan(spec, Target("cuda", vvl=1), consts=consts)
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        t_o = flops / PEAK_F32_PER_S * 1e3
        kernel = ".".join(name.split(".")[:2])
        row = lm_row(
            name, KERNELS[kernel], ("tdp_gathered", kernel.split(".")[1]),
            lambda: tdp_pointwise.cuda_execute(plan, xs),
            lambda: torch_executor(plan, xs),
            lm_library_call(name, xs, consts),
            (t_b, "bytes") if t_b >= t_o else (t_o, "operations"),
            launches, launches_by_path, max_err, problems, record,
            max_err_key=kernel, control=control if bf else None, **hold)
        row["shape"] = list(xs[0].shape)
        if not bf:
            row["ms_by_vvl"] = {vvl: time_ms(lambda p=launch_plan(
                spec, Target("cuda", vvl=vvl), consts=consts):
                tdp_pointwise.cuda_execute(p, xs)) for vvl in (1, 2, 4, 8)}
            log(f"phase 5: {name} ms by VVL {row['ms_by_vvl']}")
        rows.append(row)
        torch.cuda.empty_cache()

    for suffix, d, ntok in rms_rows:
        x, w = randn(d, ntok), randn(d)
        pointwise_row("tdp_gathered.rmsnorm" + suffix, lm.rmsnorm_spec(d),
                      [x], {"weight": w, "eps": 1e-6, "scale_offset": 1.0},
                      esize * (2 * d * ntok + d), 5 * d * ntok,
                      lambda x=x, w=w: bf16_control("rmsnorm", x, w))
        del x
    for name, kind, gated, ntok, nff, ops_per in ew_rows:
        n = ntok * nff
        xs = [randn(1, n, scale=3.0)] + ([randn(1, n)] if gated else [])
        pointwise_row(name, lm.gated_act_spec(kind, gated), xs, {},
                      esize * n * (len(xs) + 1), ops_per * n,
                      lambda xs=xs, kind=kind: bf16_control(kind, *xs))
        rows[-1]["shape"] = [ntok, nff]
        del xs
    for tag, b, hq, hkv, sq, window, dh, *cap in attn_rows:
        q = randn(b, hq, sq, dh)
        k, v = randn(b, hkv, sq, dh), randn(b, hkv, sq, dh)
        kw = dict(causal=True, window=window, softcap=cap[0] if cap else 0.0)
        if kw["softcap"]:
            lib = None
        elif window:
            i = torch.arange(sq, device=dev)
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            lib = ((lambda q=q, k=k, v=v, band=band:
                    F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                   enable_gqa=True)),
                   (lambda o: (o,)))
        else:
            lib = ((lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)), (lambda o: (o,)))
        shape = (b, hq, hkv, sq, sq, dh, True, window)
        name = f"flash_attention.{tag}"
        rows.append(lm_row(
            name, KERNELS["flash_attention"],
            ("flash_attention", "flash_attention"),
            lambda q=q, k=k, v=v, kw=kw: flash_attention.flash_attention(
                q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: ref.attention_ref(q, k, v, **kw),
            lib, attn_bound(*shape, elem_bytes=2, per_flop=BF16_ATTN_PER_FLOP)
            if bf else attn_bound(*shape, split=flash_attention.TF32_SPLIT),
            launches, launches_by_path, max_err, problems, record,
            max_err_key="flash_attention",
            control=(lambda q=q, k=k, v=v, kw=kw: p_rounded_attention(
                q, k, v, **kw)) if bf else None, **hold))
        rows[-1]["shape"] = [b, hq, hkv, sq, dh, window, *cap]
        if not bf:
            record.setdefault("bound_fp32_ms", {})[name] = attn_bound(*shape)[0]
        del q, k, v, lib
        torch.cuda.empty_cache()
    for row in rows:
        row["dtype"] = str(dtype).removeprefix("torch.")
    return rows


def dense_expected(cfg) -> tuple[dict, dict]:
    """The launches of one prefill and of ``SERVE_DECODE`` decode steps on
    the kernels: per layer a flash attention (prefill only: decode attends
    in plain PyTorch), the MLP's ``gated`` (or ungated ``act``) and, under
    RMSNorm, two norms, plus the final norm.  LayerNorm and qk-norm are
    plain PyTorch, as in the reference."""
    n = cfg.n_layers
    mlp = ("tdp_gathered", "gated" if cfg.act in ("swiglu", "geglu")
           else "act")
    pre = {("flash_attention", "flash_attention"): n, mlp: n}
    dec = {mlp: n * SERVE_DECODE}
    if cfg.norm == "rmsnorm":
        pre[("tdp_gathered", "rmsnorm")] = 2 * n + 1
        dec[("tdp_gathered", "rmsnorm")] = (2 * n + 1) * SERVE_DECODE
    return pre, dec


def dense_train(arch, drive, by_path, problems, device="cuda") -> dict:
    """Phase 10, one training run through ``launch.train`` on the kernels
    (``DENSE_TRAIN``), then its first step on the plain path, held at
    ``TRAIN_TOL``; the loss falling over 6 steps or more; each path's
    launches."""
    import tempfile
    extra, steps = DENSE_TRAIN[arch]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dense_")
    base = ["--arch", arch, *extra, *DENSE_TRAIN_ARGS, "--device", device]
    path = f"{arch} train {steps} steps (cuda)"
    with first_step_leaf_norms() as leaves:
        trainer, hist, peak_gb = train_run(
            base + ["--steps", str(steps), "--ckpt-dir", tmp], drive, path)
    cfg = trainer.cfg
    tokens = trainer.data_cfg.global_batch * trainer.data_cfg.seq_len
    del trainer
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "quant_moments": "--quant-moments" in extra, "steps": len(hist),
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "peak_memory_gb": peak_gb,
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    half = steps // 2
    if len(hist) != steps or (steps >= 6 and not np.mean(losses[half:])
                              < np.mean(losses[:half])):
        problems.append(f"phase 10 {arch}: {len(hist)} of {steps} steps, or "
                        f"the loss did not fall: {losses}")
    plain_path = f"{arch} train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves:
        _, plain_hist, plain_gb = train_run(
            base + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                    tmp + "_plain"], drive, plain_path)
    out["plain_step1_ms"] = plain_hist[0]["ms"]
    out["plain_peak_memory_gb"] = plain_gb
    out["step1_vs_plain"] = hold_to_oracle(f"phase 10 {arch}", hist,
                                           plain_hist, leaves, plain_leaves,
                                           problems)
    # each layer's forward twice a microbatch (remat), the final norm once
    micro = steps * 2
    mlp = "gated" if cfg.act in ("swiglu", "geglu") else "act"
    want = {("flash_attention", "flash_attention"): micro * 2 * cfg.n_layers,
            ("tdp_gathered", mlp): micro * 2 * cfg.n_layers,
            ("tdp_gathered", "rmsnorm"): micro * (4 * cfg.n_layers + 1)}
    if by_path[path] != want:
        problems.append(f"phase 10 {path}: launches {by_path[path]}, "
                        f"expected {want}")
    if by_path[plain_path]:
        problems.append(f"phase 10 {plain_path}: the plain path launched "
                        f"{by_path[plain_path]}")
    for d in (tmp, tmp + "_plain"):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def examples_run(drive, by_path, problems, device="cuda") -> dict:
    """Phase 10, the LM examples: ``train_lm`` at its 22m preset for
    ``EXAMPLE_STEPS`` steps (the loss must fall: its own check), then
    ``serve_lm`` from its checkpoint (the restore reported, the
    probability its served logits put on the bigram table's successors
    ``SERVE_LM_Z`` standard errors above chance; the share of greedy
    continuations that follow the table reported); their printed lines go
    to the log."""
    import io
    import tempfile
    from repro_torch.examples import serve_lm, train_lm
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    out, text = {}, io.StringIO()
    train_path = f"train_lm 22m {EXAMPLE_STEPS} steps"
    with contextlib.redirect_stdout(text):
        t0 = time.perf_counter()
        try:
            _, hist = drive(train_path, lambda: train_lm.run(
                train_lm.parse_args(["--steps", str(EXAMPLE_STEPS),
                                     "--ckpt-dir", tmp, "--device",
                                     device])))
        except RuntimeError as e:          # train_lm's loss check
            problems.append(f"phase 10 train_lm: {e}")
            hist = []
        out["train_s"] = time.perf_counter() - t0
        res = drive("serve_lm 22m", lambda: serve_lm.run(
            serve_lm.parse_args(["--ckpt-dir", tmp, "--device", device])))
    log(text.getvalue())
    out.update(losses={h["step"]: h["loss"] for h in hist},
               step_ms_median=(statistics.median(h["ms"] for h in hist)
                               if hist else None), serve=res,
               share=res["ok"] / res["total"],
               lift=res["ok"] / res["total"] / res["chance"],
               mass_lift=res["mass"] / res["chance"],
               mass_z=(res["mass"] - res["chance"]) / res["mass_se"])
    if not res["trained"] or "restored trained weights" not in text.getvalue():
        problems.append("phase 10 serve_lm: it did not restore train_lm's "
                        "checkpoint")
    if not out["mass_z"] > SERVE_LM_Z:
        problems.append(f"phase 10 serve_lm: probability {res['mass']} "
                        f"± {res['mass_se']} on the bigram table's "
                        f"successors, not {SERVE_LM_Z} standard errors above "
                        f"chance {res['chance']}")
    # the 22m model: global attention, RMSNorm, SwiGLU on the kernels
    want = {("flash_attention", "flash_attention"), ("tdp_gathered", "rmsnorm"),
            ("tdp_gathered", "gated")}
    for p in (train_path, "serve_lm 22m"):
        if set(by_path[p]) != want:
            problems.append(f"phase 10 {p}: launches {by_path[p]}")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def dense_archs_phase(drive, by_path, problems, device="cuda") -> dict:
    """Phase 10 (see the module docstring)."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    out = {"serving": {}, "training": {}}
    for arch, (n_layers, prompt) in DENSE_SERVE.items():
        cfg = configs.first_layers(configs.get_config(arch), n_layers)
        out["serving"][arch] = serve_model(cfg, prompt, drive, problems,
                                           ring=arch == "gemma3-27b",
                                           device=device)
        pre, dec = dense_expected(cfg)
        runs = ["", " ring"] if arch == "gemma3-27b" else [""]
        for tag in runs:
            for p, want in ((f"{cfg.name}{tag} prefill (cuda)", pre),
                            (f"{cfg.name}{tag} decode x{SERVE_DECODE} (cuda)",
                             dec)):
                if by_path.get(p) != want:
                    problems.append(f"phase 10 {p}: launches "
                                    f"{by_path.get(p)}, expected {want}")
        for p in (f"{cfg.name} prefill (torch)",
                  f"{cfg.name} decode x{SERVE_DECODE} (torch)"):
            if by_path.get(p):
                problems.append(f"phase 10 {p}: the plain path launched "
                                f"{by_path[p]}")
        out["serving"][arch]["launches"] = {
            p: {f"{k}.{s}": n for (k, s), n in by_path[p].items()}
            for p in by_path if p.startswith(cfg.name + " ")}
    for arch in DENSE_TRAIN:
        out["training"][arch] = dense_train(arch, drive, by_path, problems,
                                            device)
    out["examples"] = examples_run(drive, by_path, problems, device)
    out["paths"] = [p for p in by_path if p.startswith(tuple(
        f"{n} " for n in ("gemma3-27b", "qwen2-vl-2b", "phi3-medium-14b",
                          "nemotron-4-15b", "train_lm", "serve_lm")))]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10: dense archs {out['phase_s']:.1f} s")
    return out


@contextlib.contextmanager
def recorded_routes(limit=None):
    """Yields a list that gets, for each of the first ``limit`` (all:
    ``None``) calls of ``models.moe._route``, its experts (T, K) and each
    row's margin, the gap between its k-th and (k+1)-th router probability
    (T,), on the card, in call order."""
    from repro_torch.models import moe
    route, calls = moe._route, []

    def wrapped(x2, w, cfg_moe):
        out = route(x2, w, cfg_moe)
        if limit is None or len(calls) < limit:
            top = torch.topk(out[2].detach(), cfg_moe.top_k + 1, dim=-1).values
            calls.append((out[1].detach().clone(), top[:, -2] - top[:, -1]))
        return out
    moe._route = wrapped
    try:
        yield calls
    finally:
        moe._route = route


@contextlib.contextmanager
def forced_routes(calls):
    """Inside the block, call i of ``models.moe._route`` returns the
    experts of ``calls[i]`` (another run's, from ``recorded_routes``) with
    this run's router probabilities at them as the weights, renormalised
    as ``_route`` does: two paths compared with their routing held equal."""
    from repro_torch.models import moe
    route, done = moe._route, [0]

    def wrapped(x2, w, cfg_moe):
        _, _, probs = route(x2, w, cfg_moe)
        top_e = calls[done[0]][0]
        done[0] += 1
        top_w = probs.gather(-1, top_e.long())
        if cfg_moe.router_scale:
            top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
        return top_w, top_e, probs
    moe._route = wrapped
    try:
        yield
    finally:
        moe._route = route


def kept_by_expert(top_e, moe_cfg) -> torch.Tensor:
    """(T, E) flags: the (token, expert) choices the capacity path keeps
    (each expert's first ``cap`` choosing tokens in token order; the order
    of a token's K choices does not matter)."""
    from repro_torch.models import moe
    t, k = top_e.shape
    flat = top_e.reshape(-1).long()
    onehot = torch.nn.functional.one_hot(flat, moe_cfg.num_experts)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    kept = torch.zeros(t, moe_cfg.num_experts, dtype=torch.bool,
                       device=top_e.device)
    kept[torch.arange(t, device=top_e.device).repeat_interleave(k), flat] = (
        pos < moe.capacity(t, moe_cfg))
    return kept


class RouteHold:
    """Routes of the kernels against the plain path's, call by call, for
    ``nseq`` sequences: a sequence stays alive while its routes and its
    kept choices agree in every call so far; a route that differs in a
    live sequence is reported with the plain path's margin, and one at a
    margin of ``MOE_ROUTE_MARGIN`` or more is a fault."""

    def __init__(self, moe_cfg, nseq: int, what: str):
        self.moe_cfg, self.what = moe_cfg, what
        self.alive = torch.ones(nseq, dtype=torch.bool)
        self.routes = 0
        self.differing: list[dict] = []

    def call(self, i, kern, plain) -> None:
        (ke, _), (pe, margin) = kern, plain
        differ = (ke.sort(-1).values != pe.sort(-1).values).any(-1)
        parted = differ | (kept_by_expert(ke, self.moe_cfg)
                           != kept_by_expert(pe, self.moe_cfg)).any(-1)
        per_seq = ke.shape[0] // self.alive.numel()
        live = self.alive.repeat_interleave(per_seq).to(differ.device)
        self.routes += int(live.sum()) * ke.shape[1]
        for r in (differ & live).nonzero().flatten().tolist():
            self.differing.append({"call": i, "row": r,
                                   "margin": float(margin[r])})
        self.alive &= ~parted.reshape(-1, per_seq).any(-1).cpu()

    def report(self, problems) -> dict:
        bad = [d for d in self.differing if d["margin"] >= MOE_ROUTE_MARGIN]
        if bad:
            problems.append(f"{self.what}: {len(bad)} routes differ from the "
                            f"plain path at a margin of {MOE_ROUTE_MARGIN} or "
                            f"more: {bad[:5]}")
        return {"routes_compared": self.routes,
                "differing_routes": len(self.differing),
                "differing": self.differing[:50],
                "largest_margin_of_a_differing_route": max(
                    (d["margin"] for d in self.differing), default=None),
                "sequences_alive": int(self.alive.sum())}


def moe_serve(cfg, drive, problems, device="cuda", *, prompt=MOE_PROMPT,
              phase="phase 11", plain_attn_impl="ref") -> dict:
    """Phase 11, serving (and phase 13's, ``phase`` naming it): the model
    (granite whole, deepseek-v3's cut) from seeded random float32 weights,
    ``SERVE_BATCH`` prompts of ``prompt`` tokens and
    ``SERVE_DECODE`` greedy steps through ``build_serve_steps`` on the
    kernels (counted, routes recorded), on the plain path (the same), on
    the kernels with the plain path's routes (``forced_routes``) and on the
    kernels warm (timed).  The first run's logits held at ``SERVE_TOL`` and
    its tokens to equality on the sequences whose routes and kept choices
    agree so far (``RouteHold``; a token that differs at a near tie of the
    logits parts its sequence, as in ``compare_serving``); the run on the
    plain path's routes held to the plain path on every sequence
    (``compare_serving``).  ``plain_attn_impl``: the plain path's attention
    oracle (``ExecContext.attn_impl``)."""
    from repro_torch.models import params as model_params
    dev = torch.device(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mparams = model_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, prompt))).to(dev)}
    with recorded_routes() as kern_routes:
        served = serve_run(mparams, cfg, "cuda", batch, drive=drive)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with recorded_routes() as plain_routes:
        plain = serve_run(mparams, cfg, "torch", batch, drive=drive,
                          attn_impl=plain_attn_impl)
    with forced_routes(plain_routes):
        forced = serve_run(mparams, cfg, "cuda", batch)
    warm = serve_run(mparams, cfg, "cuda", batch)
    n = cfg.layer_program.count("attn_moe")     # routed calls a forward
    hold = RouteHold(cfg.moe, SERVE_BATCH, f"{phase} {cfg.name} serving")
    if len(kern_routes) != len(plain_routes) or len(kern_routes) != n * (
            1 + SERVE_DECODE):
        problems.append(f"{phase}: {len(kern_routes)} and "
                        f"{len(plain_routes)} routed calls, expected "
                        f"{n * (1 + SERVE_DECODE)}")
    steps = []
    for i, (lk, lp, tk, tp) in enumerate(zip(served["logits"], plain["logits"],
                                             served["tokens"], plain["tokens"])):
        for c in range(i * n, min((i + 1) * n, len(kern_routes),
                                  len(plain_routes))):
            hold.call(c, kern_routes[c], plain_routes[c])
        ok = hold.alive.to(dev)
        top2 = torch.topk(lp.float(), 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        tol = SERVE_TOL["atol"] + SERVE_TOL["rtol"] * float(lp.abs().max())
        same = (tk == tp).reshape(-1)
        diff_all = float((lk - lp).abs().max())
        diff = float((lk - lp)[ok].abs().max()) if ok.any() else None
        steps.append({"step": i, "sequences_compared": int(ok.sum()),
                      "max_abs_logit_diff": diff,
                      "max_abs_logit_diff_all_sequences": diff_all,
                      "min_top2_margin": float(margin.min()),
                      "tokens_equal": bool(same.all())})
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            problems.append(f"{phase} {cfg.name} step {i}: non-finite logits")
        if ok.any() and not torch.allclose(lk[ok], lp[ok], **SERVE_TOL):
            problems.append(f"{phase} {cfg.name} step {i}: logits differ by "
                            f"{diff}")
        if bool((~same & ok & (margin > 2 * tol)).any()):
            problems.append(f"{phase} {cfg.name} step {i}: greedy tokens "
                            f"differ where the margin exceeds {2 * tol}")
        hold.alive &= same.cpu()
    # choices the capacity path dropped in the kernels' prefill, by MoE
    # layer
    dropped = [e.numel() - int(kept_by_expert(e, cfg.moe).sum())
               for e, _ in kern_routes[:n]]
    out = {"tolerance": SERVE_TOL, "steps": steps,
           "routes": hold.report(problems), "params": cfg.num_params(),
           "prefill_dropped_choices_by_layer": dropped,
           "prefill_choices_per_layer": SERVE_BATCH * prompt
           * cfg.moe.top_k,
           "layers": cfg.n_layers, "prompt": [SERVE_BATCH, prompt],
           "decode_steps": SERVE_DECODE, "peak_memory_gb_kernels": peak_gb}
    out["with_the_plain_routes"] = compare_serving(
        forced, plain, problems, f"{phase} {cfg.name} on the plain path's "
        f"routes")
    for name, run in (("kernels_first_run", served), ("kernels_warm", warm),
                      ("plain", plain)):
        out[name] = {
            "prefill_ms": run["prefill_ms"],
            "prefill_tokens_per_s": SERVE_BATCH * prompt
            / run["prefill_ms"] * 1e3,
            "decode_ms_per_step": run["decode_ms_per_step"],
            "decode_tokens_per_s": SERVE_BATCH / run["decode_ms_per_step"]
            * 1e3}
    if not all(torch.equal(a, b) for a, b in zip(warm["tokens"],
                                                 served["tokens"])):
        problems.append(f"{phase} {cfg.name}: the warm run's tokens differ "
                        f"from the first")
    del mparams, served, plain, forced, warm, batch, kern_routes, plain_routes
    torch.cuda.empty_cache()
    return out


def moe_layer(cfg, problems, device="cuda") -> dict:
    """Phase 11, one MoE layer alone at full width on 8192 tokens of unit
    variance (an ``rmsnorm`` output's scale): ``backend="cuda"`` against
    ``"torch"`` at the config's capacity (``LM_TOL``), its dropped choices
    counted; ``ragged`` against ``capacity`` at the dropless factor E/K
    (``MOE_DROPLESS_TOL``); each timed (CUDA events; ``ragged`` by wall
    clock: it copies its group sizes to the host)."""
    from repro_torch.models import moe
    from repro_torch.models import params as model_params
    from repro_torch.models.context import ExecContext
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(21)
    p = model_params._moe_params(cfg, g, dev)
    x = torch.randn(1, SERVE_BATCH * MOE_PROMPT, cfg.d_model, device=dev,
                    generator=g)
    t, mo = x.shape[1], cfg.moe
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))

    def run(backend, impl="capacity", c=cfg):
        return moe.moe_mlp(p, x, c, ExecContext(backend=backend,
                                                moe_impl=impl))
    with torch.inference_mode():
        kern, plain = run("cuda"), run("torch")
        ragged, packed = run("cuda", "ragged", dropless), run("cuda", c=dropless)
        _, top_e, _ = moe._route(x[0], p["router"], mo)
        torch.cuda.synchronize()
        cap = moe.capacity(t, mo)
        load = torch.bincount(top_e.reshape(-1).long(), minlength=mo.num_experts)
        out = {"tokens": t, "capacity": cap,
               "dropped_choices": int((load - cap).clamp_min(0).sum()),
               "choices": t * mo.top_k, "largest_load": int(load.max()),
               "kernels_vs_plain_max_abs": float((kern - plain).abs().max()),
               "ragged_vs_capacity_dropless_max_abs":
                   float((ragged - packed).abs().max()),
               "ms_kernels": time_ms(lambda: run("cuda"), reps=5, warmup=1,
                                     hold=SHORT_HOLD),
               "ms_plain": time_ms(lambda: run("torch"), reps=5, warmup=1,
                                   hold=SHORT_HOLD),
               "ms_ragged_dropless_wall": wall_ms(
                   lambda: run("cuda", "ragged", dropless))}
    out["dropped_share"] = out["dropped_choices"] / out["choices"]
    if not (torch.isfinite(kern).all() and torch.allclose(kern, plain,
                                                          **LM_TOL)):
        problems.append(f"phase 11 MoE layer: kernels and plain differ by "
                        f"{out['kernels_vs_plain_max_abs']}")
    if not torch.allclose(ragged, packed, **MOE_DROPLESS_TOL):
        problems.append(f"phase 11 MoE layer: ragged and dropless capacity "
                        f"differ by {out['ragged_vs_capacity_dropless_max_abs']}")
    log(f"phase 11: MoE layer {out}")
    del p, x, kern, plain, ragged, packed
    torch.cuda.empty_cache()
    return out


def moe_train(drive, by_path, problems, device="cuda") -> dict:
    """Phase 11, training granite whole through ``launch.train``
    (``MOE_TRAIN_ARGS``) on the kernels, then its first step on the plain
    path; step 1's routes (the first forward's) recorded on both and held
    by ``RouteHold``; step 1 held at ``TRAIN_TOL`` (where a near-tie route
    differs, only the loss is held and the rest reported); the loss of
    step 1's batch lower through the trained weights; each path's
    launches."""
    import tempfile
    from repro_torch import configs
    cfg = configs.get_config(MOE_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    base = MOE_TRAIN_ARGS + ["--device", device]
    path = f"{MOE_ARCH} train {MOE_TRAIN_STEPS} steps (cuda)"
    with first_step_leaf_norms() as leaves, \
            recorded_routes(limit=cfg.n_layers) as kern_routes:
        trainer, hist, peak_gb = train_run(
            base + ["--steps", str(MOE_TRAIN_STEPS), "--ckpt-dir", tmp],
            drive, path)
    tokens = trainer.data_cfg.global_batch * trainer.data_cfg.seq_len
    # step 1's batch once more, through the trained weights: the batches of
    # a bigram stream over 49 155 tokens share little, so their losses
    # scatter by ~0.02 from step to step, more than 6 steps move them
    with torch.no_grad():
        from repro_torch.models import lm
        loss_again = float(lm.loss_fn(trainer.params, trainer.loader(0), cfg,
                                      trainer.ctx)[0])
    del trainer
    torch.cuda.empty_cache()
    plain_path = f"{MOE_ARCH} train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves, \
            recorded_routes(limit=cfg.n_layers) as plain_routes:
        _, plain_hist, plain_gb = train_run(
            base + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                    tmp + "_plain"], drive, plain_path)
    hold = RouteHold(cfg.moe, 1, f"phase 11 {MOE_ARCH} training step 1")
    for c, (a, b) in enumerate(zip(kern_routes, plain_routes)):
        hold.call(c, a, b)
    routes = hold.report(problems)
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "steps": len(hist), "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step1_batch_loss_after_training": loss_again,
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "peak_memory_gb": peak_gb,
           "plain_step1_ms": plain_hist[0]["ms"],
           "plain_peak_memory_gb": plain_gb, "step1_routes": routes,
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    if len(hist) != MOE_TRAIN_STEPS or not loss_again < losses[0]:
        problems.append(f"phase 11 training: {len(hist)} of "
                        f"{MOE_TRAIN_STEPS} steps, or step 1's batch has a "
                        f"loss of {loss_again} after them, not below "
                        f"{losses[0]}")
    if routes["differing_routes"]:
        # a near-tie route moves its token's gradient: the loss is held,
        # the norms reported beside the routes that differ
        held: list = []
        out["step1_vs_plain"] = hold_to_oracle(
            f"phase 11 {MOE_ARCH}", hist, plain_hist, leaves, plain_leaves,
            held)
        loss = out["step1_vs_plain"]["loss"]
        if not (math.isfinite(loss["kernels"])
                and loss["rel_diff"] <= TRAIN_TOL["loss"]):
            problems.append(f"phase 11 {MOE_ARCH}: step-1 loss {loss}")
        out["step1_vs_plain"]["not_held"] = held
    else:
        out["step1_vs_plain"] = hold_to_oracle(
            f"phase 11 {MOE_ARCH}", hist, plain_hist, leaves, plain_leaves,
            problems)
    want = {e: MOE_TRAIN_STEPS * n for e, n in train_expected(cfg).items()}
    if by_path[path] != want:
        problems.append(f"phase 11 {path}: launches {by_path[path]}, "
                        f"expected {want}")
    if by_path[plain_path]:
        problems.append(f"phase 11 {plain_path}: the plain path launched "
                        f"{by_path[plain_path]}")
    for d in (tmp, tmp + "_plain"):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def moe_phase(drive, by_path, problems, device="cuda") -> dict:
    """Phase 11 (see the module docstring)."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    out = {"layer": moe_layer(cfg, problems, device)}
    out["serving"] = moe_serve(cfg, drive, problems, device)
    pre, dec = dense_expected(cfg)
    for p, want in ((f"{cfg.name} prefill (cuda)", pre),
                    (f"{cfg.name} decode x{SERVE_DECODE} (cuda)", dec)):
        if by_path.get(p) != want:
            problems.append(f"phase 11 {p}: launches {by_path.get(p)}, "
                            f"expected {want}")
    for p in (f"{cfg.name} prefill (torch)",
              f"{cfg.name} decode x{SERVE_DECODE} (torch)"):
        if by_path.get(p):
            problems.append(f"phase 11 {p}: the plain path launched "
                            f"{by_path[p]}")
    out["serving"]["launches_per_decode_step"] = {
        f"{k}.{s}": n / SERVE_DECODE
        for (k, s), n in by_path[f"{cfg.name} decode x{SERVE_DECODE} (cuda)"
                                 ].items()}
    out["training"] = moe_train(drive, by_path, problems, device)
    out["paths"] = [p for p in by_path
                    if p.startswith((cfg.name + " ", MOE_ARCH + " "))]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: MoE {out['phase_s']:.1f} s")
    return out


def ssd_expected(cfg) -> tuple[dict, dict, dict]:
    """zamba2's launches on the kernels: one prefill, ``SERVE_DECODE``
    decode steps, one training step (one microbatch, each layer's forward
    twice under remat, the final norm once).  A ``mamba2`` layer's norm is
    kernel 2a's rmsnorm (its SSD, convolutions and gated norm are plain
    PyTorch, as in the reference); a ``shared_attn`` position is an
    ``attn`` block: two norms, the GeGLU and (prefill only) kernel 4."""
    n_m = cfg.layer_program.count("mamba2")
    n_s = cfg.layer_program.count("shared_attn")
    rms = n_m + 2 * n_s
    pre = {("flash_attention", "flash_attention"): n_s,
           ("tdp_gathered", "gated"): n_s, ("tdp_gathered", "rmsnorm"): rms + 1}
    dec = {("tdp_gathered", "gated"): n_s * SERVE_DECODE,
           ("tdp_gathered", "rmsnorm"): (rms + 1) * SERVE_DECODE}
    train = {("flash_attention", "flash_attention"): 2 * n_s,
             ("tdp_gathered", "gated"): 2 * n_s,
             ("tdp_gathered", "rmsnorm"): 2 * rms + 1}
    return pre, dec, train


@contextlib.contextmanager
def rounded_rmsnorm():
    """``ops.rmsnorm`` (every RMSNorm of the models) computed in float64
    and rounded to the input's dtype once: the plain version's result
    moved by up to a rounding, as the kernel's is (≤ 1.5 float32 ulp from
    the plain version at phase 5's rows)."""
    from repro_torch.kernels import ops
    rmsnorm = ops.rmsnorm

    def rounded(x, weight, *, eps=1e-6, scale_offset=0.0, **_):
        xd = x.double()
        inv = torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
        return (xd * inv * (weight.double() + scale_offset)).to(x.dtype)
    ops.rmsnorm = rounded
    try:
        yield
    finally:
        ops.rmsnorm = rmsnorm


def leaf_kind(name: str) -> str:
    """A leaf's name with its layer indices as ``*``: the leaves of one
    kind across the layers (``/layers/*/attn/wq``)."""
    return re.sub(r"/\d+(?=/|$)", "/*", name)


def hold_leaves_to_floor(what, kern_hist, plain_hist, kern_leaves,
                         plain_leaves, floor_leaves, problems, *,
                         tol=TRAIN_TOL, floor_factor=SSD_LEAF_FLOOR,
                         floor_hist=None, pooled=False) -> dict:
    """``hold_to_oracle`` (step 1's loss and global gradient norm at
    ``tol``), with each leaf's gradient norm held at
    ``tol["leaf_grad_norm"]`` or, where that leaf moves more than it
    under a rounding of the norms' outputs (``floor_leaves``: the plain
    path with ``rounded_rmsnorm``), at ``floor_factor`` times its move
    there.  ``pooled``: a leaf's floor is the largest move of its kind
    (``leaf_kind``) under that rounding, not its own (one sample of a
    rounding's effect, which a chaotic backward scatters over the layers).
    ``floor_hist`` (that run's history): the global gradient norm held the
    same way, at ``tol`` or ``floor_factor`` times its move there."""
    held: list = []
    tol_g = tol
    if floor_hist is not None:
        g_floor = (abs(floor_hist[0]["grad_norm"] - plain_hist[0]["grad_norm"])
                   / abs(plain_hist[0]["grad_norm"]))
        tol_g = dict(tol, grad_norm=max(tol["grad_norm"],
                                        floor_factor * g_floor))
    res = hold_to_oracle(what, kern_hist, plain_hist, kern_leaves,
                         plain_leaves, held, tol_g)
    if floor_hist is not None:
        res["grad_norm"].update(floor_rel_diff=g_floor,
                                bar=tol_g["grad_norm"])
    problems += [p for p in held if "leaf_grad_norm" not in p]
    if "leaf_grad_norm" not in res:
        problems += held
        return res
    if floor_leaves.get("names") != plain_leaves["names"]:
        problems.append(f"{what}: the rounded-norms run's gradient tree "
                        f"differs")
        return res

    def rel(a, b):
        return abs(a - b) / b if b else abs(a)
    kern = [rel(a, b) for a, b in zip(kern_leaves["norms"],
                                      plain_leaves["norms"])]
    floor = [rel(a, b) for a, b in zip(floor_leaves["norms"],
                                       plain_leaves["norms"])]
    if pooled:
        kinds = [leaf_kind(n) for n in plain_leaves["names"]]
        by_kind: dict = {}
        for k, f in zip(kinds, floor):
            by_kind[k] = max(by_kind.get(k, 0.0), f)
        floor = [by_kind[k] for k in kinds]
    bars = [max(tol["leaf_grad_norm"], floor_factor * f) for f in floor]
    over = [i for i, (k, b) in enumerate(zip(kern, bars))
            if not (math.isfinite(k) and k <= b)]
    worst = int(np.argmax([k / b for k, b in zip(kern, bars)]))
    res["leaf_grad_norm"].update(
        floor_rel_diff_worst=max(floor),
        floor_rel_diff_median=float(np.median(floor)), floor_pooled=pooled,
        leaves_above_train_tol=sum(k > tol["leaf_grad_norm"] for k in kern),
        worst_vs_bar={"leaf": kern_leaves["names"][worst],
                      "rel_diff": kern[worst], "floor": floor[worst],
                      "bar": bars[worst]})
    for i in over:
        problems.append(f"{what}: step-1 gradient norm of "
                        f"{kern_leaves['names'][i]} {kern[i]} from the plain "
                        f"path's, over {bars[i]} (its floor {floor[i]})")
    return res


def ssd_train(cfg, drive, by_path, problems, device="cuda") -> dict:
    """Phase 12, training zamba2 whole through ``launch.train``
    (``SSD_TRAIN_ARGS``) on the kernels, then its first step on the plain
    path, held at ``TRAIN_TOL``; the tied block one set of tensors in the
    parameters and both moments (the unique elements ``count_params``);
    step 1's batch at a lower loss through the trained weights; each
    path's launches and the peak memory; the plain path's step 1 run once
    more (for the record: deterministic) and once with its norms rounded
    once more (``rounded_rmsnorm``), each leaf's floor for
    ``hold_leaves_to_floor``."""
    import tempfile
    from repro_torch.models import lm
    from repro_torch.optim.tree import tree_leaves
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssd_")
    base = SSD_TRAIN_ARGS + ["--device", device]
    path = f"{SSD_ARCH} train {SSD_TRAIN_STEPS} steps (cuda)"
    with first_step_leaf_norms() as leaves:
        trainer, hist, peak_gb = train_run(
            base + ["--steps", str(SSD_TRAIN_STEPS), "--ckpt-dir", tmp],
            drive, path)
    tokens = trainer.data_cfg.global_batch * trainer.data_cfg.seq_len
    shared_at = [i for i, b in enumerate(cfg.layer_program)
                 if b == "shared_attn"]
    tie = {}
    for name, tree in (("params", trainer.params),
                       ("m", trainer.opt_state["m"]),
                       ("v", trainer.opt_state["v"])):
        ts = tree_leaves(tree)
        tie[name] = {"tensors": len(ts), "unique": len({id(t) for t in ts}),
                     "elements": sum(t.numel() for t in ts),
                     "shared_positions_empty": all(
                         tree["layers"][i] == {} for i in shared_at)}
        if (tie[name]["unique"] != len(ts)
                or tie[name]["elements"] != cfg.num_params()
                or not tie[name]["shared_positions_empty"]):
            problems.append(f"phase 12: the tied block in {name}: "
                            f"{tie[name]}, {cfg.num_params()} parameters")
    with torch.no_grad():
        loss_again = float(lm.loss_fn(trainer.params, trainer.loader(0), cfg,
                                      trainer.ctx)[0])
    del trainer
    torch.cuda.empty_cache()
    plain_path = f"{SSD_ARCH} train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves:
        _, plain_hist, plain_gb = train_run(
            base + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                    tmp + "_plain"], drive, plain_path)
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "steps": len(hist), "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step1_batch_loss_after_training": loss_again,
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "peak_memory_gb": peak_gb,
           "plain_step1_ms": plain_hist[0]["ms"],
           "plain_peak_memory_gb": plain_gb, "tied_block": tie,
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    if len(hist) != SSD_TRAIN_STEPS or not loss_again < losses[0]:
        problems.append(f"phase 12 training: {len(hist)} of "
                        f"{SSD_TRAIN_STEPS} steps, or step 1's batch has a "
                        f"loss of {loss_again} after them, not below "
                        f"{losses[0]}")
    # the plain path's step 1 once more (bit for bit the same, for the
    # record), and with its RMSNorm outputs rounded once more: each leaf's
    # rounding floor
    with first_step_leaf_norms() as again_leaves:
        _, again_hist, _ = train_run(
            base + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                    tmp + "_again"], drive, plain_path + " again")
    out["plain_step1_again"] = hold_to_oracle("", again_hist, plain_hist,
                                              again_leaves, plain_leaves, [])
    with first_step_leaf_norms() as floor_leaves, rounded_rmsnorm():
        _, floor_hist, _ = train_run(
            base + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                    tmp + "_floor"], drive, plain_path + " rounded norms")
    out["step1_vs_plain"] = hold_leaves_to_floor(
        f"phase 12 {SSD_ARCH}", hist, plain_hist, leaves, plain_leaves,
        floor_leaves, problems)
    want = {k: n * SSD_TRAIN_STEPS for k, n in ssd_expected(cfg)[2].items()}
    if by_path[path] != want:
        problems.append(f"phase 12 {path}: launches {by_path[path]}, "
                        f"expected {want}")
    for p in (plain_path, plain_path + " again",
              plain_path + " rounded norms"):
        if by_path[p]:
            problems.append(f"phase 12 {p}: the plain path launched "
                            f"{by_path[p]}")
    for d in (tmp, tmp + "_plain", tmp + "_again", tmp + "_floor"):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def ssd_rows(launches, launches_by_path, max_err, problems, record) -> list:
    """Phase 5 at zamba2's prefill (``SSD_*_ROWS``, through
    ``dense_rows``), and beside kernel 4's Dh 80 row the route that pads
    q, k and v with zeros to ``SSD_PAD_DH`` (the scale kept at Dh 80's)
    and slices the output: held to the plain version and timed, for the
    record; no path takes it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    rows = dense_rows(launches, launches_by_path, max_err, problems, record,
                      rms_rows=SSD_RMS_ROWS, ew_rows=SSD_EW_ROWS,
                      attn_rows=SSD_ATTN_ROWS)
    tag, b, hq, hkv, s, window, dh = SSD_ATTN_ROWS[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    q = torch.randn(b, hq, s, dh, device=dev, generator=g)
    k, v = (torch.randn(b, hkv, s, dh, device=dev, generator=g)
            for _ in range(2))

    def padded():
        def pad(t):
            return F.pad(t, (0, SSD_PAD_DH - dh))
        return flash_attention.flash_attention(
            pad(q), pad(k), pad(v), causal=True, window=window,
            scale=dh ** -0.5)[..., :dh]
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    got = padded()
    torch.cuda.synchronize()
    err = max_abs(got, want)
    if not torch.allclose(got, want, **LM_TOL):
        problems.append(f"flash_attention padded to {SSD_PAD_DH}: max "
                        f"|padded - plain| = {err}")
    del got, want
    torch.cuda.empty_cache()
    row = next(r for r in rows if r["name"] == f"flash_attention.{tag}")
    row["padded_route"] = {
        "head_dim": SSD_PAD_DH, "ms": time_ms(padded), "max_abs_err": err,
        "bound_ms": attn_bound(b, hq, hkv, s, s, SSD_PAD_DH, True, window,
                               split=flash_attention.TF32_SPLIT)[0]}
    log(f"phase 5: flash_attention.{tag} padded to {SSD_PAD_DH}: "
        f"{row['padded_route']}")
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def ssd_phase(drive, by_path, problems, device="cuda") -> dict:
    """Phase 12 (see the module docstring)."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    cfg = configs.get_config(SSD_ARCH)
    out = {"serving": serve_model(cfg, SSD_PROMPT, drive, problems,
                                  device=device)}
    pre, dec, _ = ssd_expected(cfg)
    for p, want in ((f"{cfg.name} prefill (cuda)", pre),
                    (f"{cfg.name} decode x{SERVE_DECODE} (cuda)", dec)):
        if by_path.get(p) != want:
            problems.append(f"phase 12 {p}: launches {by_path.get(p)}, "
                            f"expected {want}")
    for p in (f"{cfg.name} prefill (torch)",
              f"{cfg.name} decode x{SERVE_DECODE} (torch)"):
        if by_path.get(p):
            problems.append(f"phase 12 {p}: the plain path launched "
                            f"{by_path[p]}")
    out["serving"]["launches"] = {
        p: {f"{k}.{s}": n for (k, s), n in by_path[p].items()}
        for p in by_path if p.startswith(cfg.name + " ")}
    out["training"] = ssd_train(cfg, drive, by_path, problems, device)
    out["paths"] = [p for p in by_path if p.startswith(cfg.name + " ")]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: zamba2 {out['phase_s']:.1f} s")
    return out


def deepseek_expected(cfg, accum: int = 1) -> tuple[dict, dict, dict]:
    """deepseek-v3's launches on the kernels at ``cfg``'s cut: one prefill,
    ``SERVE_DECODE`` decode steps and one training step of ``accum``
    microbatches.  A layer runs its two norms, kernel 4 (full-sequence
    passes only: decode attends over the latent cache in plain PyTorch, as
    the reference does) and SwiGLU: once in an ``attn_dense`` layer, twice
    in an ``attn_moe`` one with a shared expert (the packed experts', the
    shared expert's); MLA's latent norms are plain PyTorch, as in the
    reference.  A training microbatch runs each layer's forward twice
    (block remat), the final norm once and each MTP module once, without
    remat (as the reference): its norm and its block, the program's last
    type."""
    flash, gated, rms = (("flash_attention", "flash_attention"),
                         ("tdp_gathered", "gated"), ("tdp_gathered", "rmsnorm"))

    def swiglus(btype):
        return 1 + (cfg.moe.num_shared > 0) if btype == "attn_moe" else 1
    n, m = cfg.n_layers, cfg.mtp_depth
    g = sum(swiglus(b) for b in cfg.layer_program)
    pre = {flash: n, gated: g, rms: 2 * n + 1}
    dec = {gated: g * SERVE_DECODE, rms: (2 * n + 1) * SERVE_DECODE}
    train = {flash: accum * (2 * n + m),
             gated: accum * (2 * g + m * swiglus(cfg.layer_program[-1])),
             rms: accum * (4 * n + 1 + 3 * m)}
    return pre, dec, train


def mla_rows(launches, launches_by_path, max_err, problems, record) -> list:
    """Phase 5 at deepseek-v3's prefill (``MLA_*``), before any weights of
    phase 13 are allocated: rmsnorm and SwiGLU through ``dense_rows``;
    kernel 4 at Dh 192 (``MLA_ATTN``) on q, k and V zero-padded from
    ``MLA_V_DIM``, causal, held to the chunked plain version
    (``ref.attention_chunked_ref``: the whole-score one would hold three
    17.2 GB tensors) and timed beside it, beside
    ``scaled_dot_product_attention`` in float32 on the same padded inputs
    and beside its bounds,
    the 3xTF32 one with V padded and with V at its own width; the V pad
    copy and the output slice at the model's (B, S, H, ·) layouts timed;
    kernel 4 raising ``ValueError`` at a head_dim it is not instantiated
    for (``MLA_BAD_DH``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    rows = dense_rows(launches, launches_by_path, max_err, problems, record,
                      rms_rows=MLA_RMS_ROWS, ew_rows=MLA_EW_ROWS,
                      attn_rows=[])
    tag, b, hq, hkv, s, dh = MLA_ATTN
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn(b, hq, s, dh, device=dev, generator=g)
    k = torch.randn(b, hkv, s, dh, device=dev, generator=g)
    v = F.pad(torch.randn(b, hkv, s, MLA_V_DIM, device=dev, generator=g),
              (0, dh - MLA_V_DIM))
    lib = ((lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
           (lambda o: (o,)))
    name = f"flash_attention.{tag}"
    shape = (b, hq, hkv, s, s, dh, True, 0)
    row = lm_row(
        name, KERNELS["flash_attention"], ("flash_attention", "flash_attention"),
        lambda: flash_attention.flash_attention(q, k, v, causal=True),
        lambda: ref.attention_chunked_ref(q, k, v, causal=True), lib,
        attn_bound(*shape, split=flash_attention.TF32_SPLIT),
        launches, launches_by_path, max_err, problems, record,
        max_err_key="flash_attention", plain_reps=3)
    o = flash_attention.flash_attention(q, k, v, causal=True)
    pad_zero = bool((o[..., MLA_V_DIM:] == 0).all())
    if not pad_zero:
        problems.append(f"{name}: the padded dimensions of O are not 0")
    del o
    pairs = b * hq * attn_live_pairs(s, s, True, 0)
    row.update(shape=[b, hq, hkv, s, dh], v_dim=MLA_V_DIM,
               padded_dims_of_o_zero=pad_zero,
               bound_v_unpadded_ms=flash_attention.TF32_SPLIT * pairs
               * (2 * dh + 2 * MLA_V_DIM) / PEAK_TF32_PER_S * 1e3)
    record.setdefault("bound_fp32_ms", {})[name] = attn_bound(*shape)[0]
    del q, k, v, lib
    torch.cuda.empty_cache()
    # the pad and the slice at the model's layouts: V (B, S, H, 128) to
    # (B, S, H, 192); O's (B, S, H, 192) to the (B, S, H·128) rows of wo
    vm = torch.randn(b, s, hkv, MLA_V_DIM, device=dev, generator=g)
    om = torch.randn(b, s, hq, dh, device=dev, generator=g)
    row["v_pad_ms"] = time_ms(lambda: F.pad(vm, (0, dh - MLA_V_DIM)))
    row["o_slice_ms"] = time_ms(
        lambda: om[..., :MLA_V_DIM].reshape(b, s, -1).contiguous())
    row["v_pad_bound_ms"] = (4 * b * s * hkv * (MLA_V_DIM + dh)
                             / PEAK_BYTES_PER_S * 1e3)
    row["o_slice_bound_ms"] = (4 * b * s * hq * 2 * MLA_V_DIM
                               / PEAK_BYTES_PER_S * 1e3)
    del vm, om
    x = torch.zeros(1, 1, 8, MLA_BAD_DH, device=dev)
    try:
        flash_attention.flash_attention(x, x, x)
        problems.append(f"flash_attention at head_dim {MLA_BAD_DH}: no "
                        f"ValueError")
        row["raises_outside_head_dims"] = False
    except ValueError:
        row["raises_outside_head_dims"] = True
    torch.cuda.empty_cache()
    log(f"phase 5: {name} {row}")
    return rows + [row]


def mla_train(drive, by_path, problems, device="cuda") -> dict:
    """Phase 13, training: deepseek-v3 at full width cut to its first 3
    layers and its MTP module through ``launch.train``
    (``MLA_TRAIN_ARGS``) on the kernels, then its first step on the plain
    path: step 1's loss, ``ce``, ``mtp``, global gradient norm and worst
    leaf held at ``TRAIN_TOL``; each path's
    launches, step ms, tokens/s and peak memory; step 1's batch's loss
    through the trained weights, reported (its microbatches' mean, as the
    step computes it: without a loss mask the reference's MTP term is the
    sum over a microbatch's rows of their mean, so it scales with the
    rows; at 8-bit moments 3 steps need not lower it)."""
    import tempfile
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.runtime.steps import _microbatch
    cfg = configs.first_layers(configs.get_config(MLA_ARCH), 3)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mla_")
    base = MLA_TRAIN_ARGS + ["--device", device]
    path = f"{MLA_ARCH} train {MLA_TRAIN_STEPS} steps (cuda)"
    with first_step_leaf_norms() as leaves:
        trainer, hist, peak_gb = train_run(
            base + ["--steps", str(MLA_TRAIN_STEPS), "--ckpt-dir", tmp],
            drive, path)
    tokens = trainer.data_cfg.global_batch * trainer.data_cfg.seq_len
    mbs = _microbatch(trainer.loader(0), MLA_TRAIN_ACCUM)
    with torch.no_grad():
        loss_again = statistics.mean(
            float(lm.loss_fn(trainer.params, {k: v[j] for k, v in mbs.items()},
                             cfg, trainer.ctx)[0])
            for j in range(MLA_TRAIN_ACCUM))
    del trainer, mbs
    torch.cuda.empty_cache()
    plain_path = f"{MLA_ARCH} train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves:
        _, plain_hist, plain_gb = train_run(
            base + ["--steps", "1", "--backend", "torch", "--ckpt-dir",
                    tmp + "_plain"], drive, plain_path)
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    out = {"layers": cfg.n_layers, "mtp_depth": cfg.mtp_depth,
           "mtp_block": cfg.layer_program[-1], "params": cfg.num_params(),
           "steps": len(hist), "losses": losses,
           "ce": [h["ce"] for h in hist], "mtp": [h["mtp"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step1_batch_loss_after_training": loss_again,
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "peak_memory_gb": peak_gb,
           "plain_step1_ms": plain_hist[0]["ms"],
           "plain_peak_memory_gb": plain_gb,
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    if len(hist) != MLA_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + [loss_again]):
        problems.append(f"phase 13 training: {len(hist)} of "
                        f"{MLA_TRAIN_STEPS} steps, losses {losses}, step 1's "
                        f"batch after them {loss_again}")
    parts = {}
    for key in ("ce", "mtp"):
        k, p = hist[0][key], plain_hist[0][key]
        parts[key] = {"kernels": k, "plain": p, "rel_diff": abs(k - p) / p}
        if not (math.isfinite(k) and parts[key]["rel_diff"]
                <= TRAIN_TOL["loss"]):
            problems.append(f"phase 13 {MLA_ARCH}: step-1 {key} {k} on the "
                            f"kernels, {p} on the plain path")
    out["step1_vs_plain"] = hold_to_oracle(f"phase 13 {MLA_ARCH}", hist,
                                           plain_hist, leaves, plain_leaves,
                                           problems)
    out["step1_vs_plain"].update(parts)
    want = {k: n * MLA_TRAIN_STEPS for k, n in deepseek_expected(
        cfg, MLA_TRAIN_ACCUM)[2].items()}
    if by_path[path] != want:
        problems.append(f"phase 13 {path}: launches {by_path[path]}, "
                        f"expected {want}")
    if by_path[plain_path]:
        problems.append(f"phase 13 {plain_path}: the plain path launched "
                        f"{by_path[plain_path]}")
    for d in (tmp, tmp + "_plain"):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def mla_phase(drive, by_path, problems, device="cuda") -> dict:
    """Phase 13 (see the module docstring)."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.first_layers(
        configs.get_config(MLA_ARCH), MLA_SERVE_LAYERS), mtp_depth=0)
    # what earlier phases leave allocated counts in the serving peak
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    out = {"serving": moe_serve(cfg, drive, problems, device,
                                prompt=MLA_PROMPT, phase="phase 13",
                                plain_attn_impl="chunked")}
    out["serving"]["allocated_gb_before"] = allocated_gb
    pre, dec, _ = deepseek_expected(cfg)
    for p, want in ((f"{cfg.name} prefill (cuda)", pre),
                    (f"{cfg.name} decode x{SERVE_DECODE} (cuda)", dec)):
        if by_path.get(p) != want:
            problems.append(f"phase 13 {p}: launches {by_path.get(p)}, "
                            f"expected {want}")
    for p in (f"{cfg.name} prefill (torch)",
              f"{cfg.name} decode x{SERVE_DECODE} (torch)"):
        if by_path.get(p):
            problems.append(f"phase 13 {p}: the plain path launched "
                            f"{by_path[p]}")
    out["serving"]["launches"] = {
        p: {f"{k}.{s}": n for (k, s), n in by_path[p].items()}
        for p in by_path if p.startswith(cfg.name + " ")}
    log(f"phase 13: serving {json.dumps(out['serving'], default=str)}")
    out["training"] = mla_train(drive, by_path, problems, device)
    out["paths"] = [p for p in by_path if p.startswith(cfg.name + " ")]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13: deepseek-v3 {out['phase_s']:.1f} s")
    return out


def whisper_expected(cfg, accum: int = 1) -> tuple[dict, dict, dict]:
    """whisper's launches on the kernels: one prefill, ``SERVE_DECODE``
    decode steps, one training step of ``accum`` microbatches.  An ``enc``
    layer runs kernel 4 (non-causal) and the GELU; an ``xattn`` layer
    kernel 4 twice (causal self-attention, cross-attention) and the GELU;
    decode attends in plain PyTorch (the self and cross caches), as the
    reference does; LayerNorm is plain PyTorch, as in the reference.  A
    training microbatch runs every layer's forward twice (block remat)."""
    flash, act = ("flash_attention", "flash_attention"), ("tdp_gathered",
                                                          "act")
    n_e, n_d = cfg.encoder.n_layers, cfg.n_layers
    pre = {flash: n_e + 2 * n_d, act: n_e + n_d}
    dec = {act: n_d * SERVE_DECODE}
    train = {k: 2 * accum * n for k, n in pre.items()}
    return pre, dec, train


def whisper_rows(launches, launches_by_path, max_err, problems,
                 record) -> list:
    """Phase 5 at whisper's prefill (``WHISPER_*_ROWS``): the GELU rows
    through ``dense_rows`` (beside ``F.gelu(approximate="tanh")``), then
    kernel 4 at each of the three attentions, held to ``attention_ref``,
    timed beside it, its bound and ``scaled_dot_product_attention`` on the
    same inputs (``is_causal`` for the causal one only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    rows = dense_rows(launches, launches_by_path, max_err, problems, record,
                      rms_rows=[], ew_rows=WHISPER_EW_ROWS, attn_rows=[])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    dh = 64
    for tag, b, hq, hkv, sq, sk, causal in WHISPER_ATTN_ROWS:
        q = torch.randn(b, hq, sq, dh, device=dev, generator=g)
        k, v = (torch.randn(b, hkv, sk, dh, device=dev, generator=g)
                for _ in range(2))
        lib = ((lambda q=q, k=k, v=v, causal=causal:
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)),
               (lambda o: (o,)))
        shape = (b, hq, hkv, sq, sk, dh, causal, 0)
        name = f"flash_attention.{tag}"
        rows.append(lm_row(
            name, KERNELS["flash_attention"],
            ("flash_attention", "flash_attention"),
            lambda q=q, k=k, v=v, causal=causal:
                flash_attention.flash_attention(q, k, v, causal=causal),
            lambda q=q, k=k, v=v, causal=causal:
                ref.attention_ref(q, k, v, causal=causal),
            lib, attn_bound(*shape, split=flash_attention.TF32_SPLIT),
            launches, launches_by_path, max_err, problems, record,
            max_err_key="flash_attention"))
        rows[-1]["shape"] = [b, hq, hkv, sq, sk, dh, causal]
        record.setdefault("bound_fp32_ms", {})[name] = attn_bound(*shape)[0]
        del q, k, v, lib
        torch.cuda.empty_cache()
    return rows


def whisper_batch(cfg, step, device="cuda", *, seq=WHISPER_TRAIN_SEQ,
                  batch=WHISPER_TRAIN_BATCH) -> dict:
    """Training batch ``step`` of whisper: the successor stream's tokens
    and labels, with random frames from the step's seed."""
    from repro_torch.data import SyntheticConfig, make_batch_loader
    dev = torch.device(device)
    tokens = make_batch_loader(SyntheticConfig(cfg.vocab_size, seq, batch,
                                               seed=0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1000 + step)
    return {**tokens(step), "audio_embed": torch.randn(
        batch, cfg.encoder.n_frames, cfg.d_model, device=dev, generator=g)}


def whisper_train_run(cfg, backend, steps, path, drive, device="cuda", *,
                      dtype=torch.float32, seq=WHISPER_TRAIN_SEQ,
                      batch=WHISPER_TRAIN_BATCH, accum=WHISPER_TRAIN_ACCUM):
    """``steps`` steps of whisper through ``runtime.steps.build_train_step``
    (block remat, dense AdamW, ``accum`` strided microbatches) from seeded
    ``dtype`` weights, on ``whisper_batch``'s batches, as one counted path;
    returns (parameters, history, peak device GB)."""
    from repro_torch.models import params as model_params
    from repro_torch.models.context import ExecContext
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import TrainHParams, build_train_step
    dev = torch.device(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model_params.trainable(model_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, dtype))
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    step = build_train_step(
        cfg, ExecContext(backend=backend, remat="block"), opt_cfg,
        TrainHParams(warmup_steps=TRAIN_WARMUP, total_steps=steps,
                     grad_accum=accum))
    hist = []

    def steps_all():
        nonlocal params, opt
        for i in range(steps):
            b = whisper_batch(cfg, i, dev, seq=seq, batch=batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                         **{k: float(v) for k, v in m.items()}})
    drive(path, steps_all)
    return params, hist, torch.cuda.max_memory_allocated() / 1e9


def whisper_train(cfg, drive, by_path, problems, device="cuda") -> dict:
    """Phase 14, training: whisper-medium whole through
    ``runtime.steps.build_train_step`` (``WHISPER_TRAIN_*``: two strided
    microbatches, block remat, dense AdamW; ``whisper_train_run``) on the
    kernels, the batches the successor stream's tokens and labels with
    random frames from the step's seed; then its first step on the plain
    path from the same weights: step 1's loss, global gradient norm and
    every leaf's gradient norm (the encoder's and both position tables'
    among them) held at ``TRAIN_TOL``; step 1's batch at a lower loss
    through the trained weights; each path's launches, step ms, tokens/s
    and peak memory."""
    from repro_torch.models import lm
    from repro_torch.models.context import ExecContext
    dev = torch.device(device)

    def run(backend, steps, path):
        return whisper_train_run(cfg, backend, steps, path, drive, dev)

    path = f"{cfg.name} train {WHISPER_TRAIN_STEPS} steps (cuda)"
    with first_step_leaf_norms() as leaves:
        params, hist, peak_gb = run("cuda", WHISPER_TRAIN_STEPS, path)
    with torch.no_grad():
        loss_again = float(lm.loss_fn(params, whisper_batch(cfg, 0, dev),
                                      cfg, ExecContext(backend="cuda"))[0])
    del params
    plain_path = f"{cfg.name} train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves:
        params, plain_hist, plain_gb = run("torch", 1, plain_path)
    del params
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    names = leaves.get("names", [])
    out = {"layers": [cfg.encoder.n_layers, cfg.n_layers],
           "params": cfg.num_params(), "steps": len(hist),
           "batch": [WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ,
                     cfg.encoder.n_frames], "accum": WHISPER_TRAIN_ACCUM,
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step1_batch_loss_after_training": loss_again,
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": (WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ
                            / step_ms * 1e3),
           "frames_per_s": (WHISPER_TRAIN_BATCH * cfg.encoder.n_frames
                            / step_ms * 1e3),
           "peak_memory_gb": peak_gb,
           "plain_step1_ms": plain_hist[0]["ms"],
           "plain_peak_memory_gb": plain_gb,
           "leaves_held": {"all": len(names), "encoder": sum(
               n.startswith("/encoder/") for n in names),
               "pos_embed": [n for n in names if n.endswith("pos_embed")]},
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    if (len(hist) != WHISPER_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not loss_again < losses[0]):
        problems.append(f"phase 14 training: {len(hist)} of "
                        f"{WHISPER_TRAIN_STEPS} steps, losses {losses}, step "
                        f"1's batch after them {loss_again}")
    if (out["leaves_held"]["encoder"] == 0
            or len(out["leaves_held"]["pos_embed"]) != 2):
        problems.append(f"phase 14 training: step 1's leaves {names}")
    out["step1_vs_plain"] = hold_to_oracle(f"phase 14 {cfg.name}", hist,
                                           plain_hist, leaves, plain_leaves,
                                           problems)
    want = {k: n * WHISPER_TRAIN_STEPS for k, n in whisper_expected(
        cfg, WHISPER_TRAIN_ACCUM)[2].items()}
    if by_path[path] != want:
        problems.append(f"phase 14 {path}: launches {by_path[path]}, "
                        f"expected {want}")
    if by_path[plain_path]:
        problems.append(f"phase 14 {plain_path}: the plain path launched "
                        f"{by_path[plain_path]}")
    return out


def whisper_phase(drive, by_path, problems, device="cuda") -> dict:
    """Phase 14 (see the module docstring)."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    cfg = configs.get_config(WHISPER_ARCH)
    out = {"serving": serve_model(cfg, WHISPER_PROMPT, drive, problems,
                                  device=device, batch_size=WHISPER_BATCH,
                                  busy=True)}
    pre, dec, _ = whisper_expected(cfg)
    for p, want in ((f"{cfg.name} prefill (cuda)", pre),
                    (f"{cfg.name} decode x{SERVE_DECODE} (cuda)", dec)):
        if by_path.get(p) != want:
            problems.append(f"phase 14 {p}: launches {by_path.get(p)}, "
                            f"expected {want}")
    for p in (f"{cfg.name} prefill (torch)",
              f"{cfg.name} decode x{SERVE_DECODE} (torch)"):
        if by_path.get(p):
            problems.append(f"phase 14 {p}: the plain path launched "
                            f"{by_path[p]}")
    out["serving"]["launches"] = {
        p: {f"{k}.{s}": n for (k, s), n in by_path[p].items()}
        for p in by_path if p.startswith(cfg.name + " ")}
    log(f"phase 14: serving {json.dumps(out['serving'], default=str)}")
    out["training"] = whisper_train(cfg, drive, by_path, problems, device)
    out["paths"] = [p for p in by_path if p.startswith(cfg.name + " ")]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14: whisper-medium {out['phase_s']:.1f} s")
    return out


def bf16_readings(got, want, atol=BF16_ATOL) -> dict:
    """bfloat16 ``got`` against ``want``: the largest distance in bfloat16
    steps (the spacing at ``want``, 2^-7 of its binade, or ``atol`` where
    that is smaller) and the share of elements on another value."""
    g, w = got.float(), want.float()
    exp = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    step = torch.exp2(exp - 7).clamp_min(atol)
    return {"max_bf16_steps": float(((g - w).abs() / step).max()),
            "share_apart": float((g != w).float().mean())}


def bf16_close(got, want, atol=BF16_ATOL) -> bool:
    """bfloat16 ``got`` finite, every element within one bfloat16 step of
    ``want`` (or ``atol``) and at most ``BF16_SHARE_BAR`` of them apart: a
    kernel and its plain version compute float32 results a few ulps apart,
    which land on the same bfloat16 value but near a rounding boundary."""
    r = bf16_readings(got, want, atol)
    return bool(got.dtype == want.dtype == torch.bfloat16
                and torch.isfinite(got).all() and r["max_bf16_steps"] <= 1
                and r["share_apart"] <= BF16_SHARE_BAR)


def bf16_control(kind, x, y=None):
    """The control of a bfloat16 kernel 2a row: its function one rounding
    away, which ``bf16_close`` must reject — RMSNorm of ``x (d, tokens)``
    scaled by ``1 + w`` rounded to bfloat16 (as ``F.rms_norm`` takes it),
    or the activation computed in bfloat16 arithmetic, its product with
    ``y`` rounded once more (as eager bfloat16 PyTorch computes it)."""
    from repro_torch.kernels import ref
    if kind == "rmsnorm":
        w1 = (y.float() + 1.0).to(torch.bfloat16)
        return ref.rmsnorm_ref(x.T, w1).T
    if kind in ("gelu", "geglu"):
        c = math.sqrt(2 / math.pi)
        a = 0.5 * x * (1 + torch.tanh(c * (x + 0.044715 * x * x * x)))
    elif kind in ("silu", "swiglu"):
        a = x * torch.sigmoid(x)
    else:
        raise ValueError(f"no bfloat16 control for {kind!r}")
    return a if y is None else a * y


def p_rounded_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, block=512):
    """``ref.attention_ref`` with P rounded to bfloat16 before P·V, as SDPA
    and FlashAttention compute in bfloat16 where the reference keeps P in
    float32: the control of kernel 4's bfloat16 bars.  ``block`` query
    rows at a time, so that its scores fit beside gemma3's weights."""
    hq, sq, dh = q.shape[1:]
    group = hq // k.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    kr, vr = (t.repeat_interleave(group, 1).float() for t in (k, v))
    kpos = torch.arange(k.shape[2], device=q.device)
    outs = []
    for i in range(0, sq, block):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i:i + block].float(),
                         kr) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(i, i + s.shape[2], device=q.device)[:, None]
        live = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window > 0:
            live &= kpos > qpos - window
        p = torch.softmax(s.masked_fill(~live, -1e30), -1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd",
                                 p.to(torch.bfloat16).float(), vr))
    return torch.cat(outs, 2).to(q.dtype)


@contextlib.contextmanager
def held_calls(attention=None):
    """Yields a dict that gets, for each of ``ops.flash_attention``,
    ``ops.rmsnorm``, ``ops.gated_act`` and ``ops.mamba_scan`` called in the
    block, its calls, the worst ``bf16_readings`` of its bfloat16 output
    against the plain version's (``target="torch"``, attention
    ``"chunked"``) on the same inputs, and whether ``bf16_mixed_close``
    held at every call (the scan's float32 state at ``LM_TOL``): a served
    model's kernels held on its own activations, layer by layer.
    ``attention`` (q, k, v, **kw) computes the attention the block runs in
    place of the op: phase 15's control, ``p_rounded_attention``, which
    must fail the hold."""
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in ("flash_attention", "rmsnorm",
                                          "gated_act", "mamba_scan")}
    store: dict = {}

    def wrap(name):
        op = saved[name]

        def held(*args, **kw):
            if name == "flash_attention" and attention is not None:
                out = attention(*args, **{k: kw[k] for k in (
                    "causal", "window", "softcap", "scale") if k in kw})
            else:
                out = op(*args, **kw)
            plain = dict(kw, target="torch")
            if name == "flash_attention":
                plain["impl"] = "chunked"
            with torch.no_grad():
                wants = op(*args, **plain)
            gots, wants = ((out, wants) if name == "mamba_scan"
                           else ((out,), (wants,)))
            st = store.setdefault(name, {"calls": 0, "close": True,
                                         "max_bf16_steps": 0.0,
                                         "share_apart": 0.0})
            st["calls"] += 1
            atol = BF16_SCAN_ATOL if name == "mamba_scan" else BF16_ATOL
            for got, want in zip(gots, wants):
                got = got.detach()
                st["close"] &= bf16_mixed_close(got, want, atol)
                for k, v in bf16_mixed_readings(got, want, atol).items():
                    st[k] = max(st[k], v)
            return out
        return held
    for n in saved:
        setattr(ops, n, wrap(n))
    try:
        yield store
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)


def bf16_named_raises(problems) -> dict:
    """bfloat16 where the port has no bfloat16 kernel yet, on the card: an
    example site function (``scale``) under AoSoA raises
    ``NotImplementedError`` naming A7.1c.4, an LB ensemble launch one
    naming A5, kernel 4 at a head dim it is not instantiated for (48)
    ``ValueError``; no launch."""
    from repro_torch.core import Lattice, Target
    from repro_torch.core.api import launch, launch_ensemble
    from repro_torch.kernels import example_sites, flash_attention
    from repro_torch.lb import stencil
    dev, bf = torch.device("cuda"), torch.bfloat16
    out = {}
    z = torch.zeros
    cases = {
        "example_scale_aosoa": (NotImplementedError, "A7.1c.4", lambda: launch(
            example_sites.SCALE_SPEC, Target("cuda", layout="aosoa", vvl=8),
            z(3, 64, dtype=bf, device=dev), consts={"a": 2.0})),
        "lb_stream_ensemble": (NotImplementedError, "A5",
                               lambda: launch_ensemble(
                                   stencil.STREAM_SPEC, Target("cuda"),
                                   z(2, 19, 64, dtype=bf, device=dev),
                                   batch=2, lattice=Lattice((4, 4, 4)))),
        "flash_attention_dh48": (ValueError, "head_dim",
                                 lambda: flash_attention.flash_attention(
                                     *(z(1, 2, 8, 48, dtype=bf, device=dev)
                                       for _ in range(3))))}
    for name, (exc, word, fn) in cases.items():
        try:
            fn()
            out[name] = "no error"
        except exc as e:
            out[name] = f"{type(e).__name__}: {e}"
        if word not in out[name]:
            problems.append(f"phase 15: bfloat16 into {name} gave "
                            f"{out[name]!r}, not the named error")
    return out


def logits_distance(a: dict, b: dict) -> float:
    """The largest |logit| difference of two served runs over the steps
    while their greedy tokens agree (the prefill's always)."""
    d = 0.0
    for la, lb, ta, tb in zip(a["logits"], b["logits"], a["tokens"],
                              b["tokens"]):
        d = max(d, float((la.float() - lb.float()).abs().max()))
        if not torch.equal(ta, tb):
            break
    return d


def bf16_compare(kern: dict, plain: dict, problems: list, what: str,
                 layers: int, bar=None) -> dict:
    """Each step's logits within ``bar`` (by default
    ``BF16_SERVE_BAR[layers]``) of the plain path's largest |logit|;
    greedy tokens equal wherever the plain path's top-2 margin exceeds the
    step's logits distance, the exceptions (near-ties the distance covers)
    counted; the comparison stops where the streams part."""
    bar = BF16_SERVE_BAR[layers] if bar is None else bar
    steps, near_ties = [], 0
    for i, (lk, lp, tk, tp) in enumerate(zip(kern["logits"], plain["logits"],
                                             kern["tokens"], plain["tokens"])):
        # padded vocab entries carry ±1e30 in both: left out
        real = lp.float().abs() < 1e29
        d = torch.where(real, lk.float() - lp.float(), 0.0)
        diff = float(d.abs().max())
        scale = float(lp.float().abs().masked_fill(~real, 0.0).max())
        top2 = torch.topk(lp.float(), 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu()
        same = (tk.cpu() == tp.cpu()).reshape(-1)
        near_ties += int((~same & (margin <= diff)).sum())
        steps.append({"step": i, "max_abs_logit_diff": diff,
                      "rms_logit_diff": float(d[real].square().mean().sqrt()),
                      "max_abs_logit": scale, "rel": diff / scale,
                      "min_top2_margin": float(margin.min()),
                      "tokens_equal": bool(same.all())})
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            problems.append(f"{what} step {i}: non-finite logits")
        if diff > bar * scale:
            problems.append(f"{what} step {i}: logits differ by {diff}, over "
                            f"{bar} of {scale}")
        if bool((~same & (margin > diff)).any()):
            problems.append(f"{what} step {i}: greedy tokens differ where the "
                            f"margin exceeds the logits' distance {diff}")
        if not bool(same.all()):
            break
    return {"bar": bar, "max_rel": max(st["rel"] for st in steps),
            "near_tie_exceptions": near_ties, "steps": steps}


def bf16_serve(drive, by_path, problems, device="cuda") -> dict:
    """Phase 15's serving (see the module docstring): gemma3 at
    ``BF16_CMP_LAYERS`` layers against the float32 kernels, each kernel
    call held to its plain version on the model's own activations
    (``held_calls``) and a control (the plain path with P rounded to
    bfloat16) shown to fail that hold; then whole; each path's launches
    held to ``dense_expected``.  The float32 run must fail the 12-layer
    logits bar; the P-rounded control's logits are recorded beside the
    kernels' at both depths (they land at the model's own bfloat16 noise,
    PERF.md §6)."""
    from repro_torch import configs
    from repro_torch.models import params as model_params
    from repro_torch.optim.tree import tree_leaves, tree_map
    t_serve = time.perf_counter()
    dev, bf = torch.device(device), torch.bfloat16
    full = configs.get_config(BF16_ARCH)
    cut = configs.first_layers(full, BF16_CMP_LAYERS)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, full.vocab_size, (SERVE_BATCH, BF16_PROMPT))).to(dev)}
    out = {}
    tags = {cut.n_layers: f" bf16 x{cut.n_layers}", full.n_layers: " bf16"}

    def control(params, cfg):
        with held_calls(attention=p_rounded_attention) as held:
            return serve_run(params, cfg, "torch", batch,
                             local_ring=True), held

    # the cut model: bfloat16 kernels (each call held) and plain path, the
    # control, then the same values upcast to float32 on the float32
    # kernels
    torch.cuda.empty_cache()
    p16 = model_params.init_params(
        cut, torch.Generator(device=dev).manual_seed(1), dev, bf)
    with held_calls() as held:
        k16 = serve_run(p16, cut, "cuda", batch, drive, local_ring=True,
                        tag=tags[cut.n_layers])
    pl16 = serve_run(p16, cut, "torch", batch, drive, local_ring=True,
                     tag=tags[cut.n_layers], attn_impl="chunked")
    ctl16, ctl_held = control(p16, cut)
    p32 = tree_map(lambda t: t.float(), p16)
    del p16
    k32 = serve_run(p32, cut, "cuda", batch, local_ring=True)
    del p32
    torch.cuda.empty_cache()
    kern_d, plain_d = logits_distance(k16, k32), logits_distance(pl16, k32)
    f32_fails: list = []
    out[f"x{cut.n_layers}_vs_float32"] = {
        "layers": cut.n_layers, "kernels_bf16_vs_f32": kern_d,
        "plain_bf16_vs_f32": plain_d, "ratio": kern_d / plain_d,
        "bar": BF16_VS_F32_RATIO,
        "kernels_vs_plain": bf16_compare(
            k16, pl16, problems, f"phase 15 {cut.name} x{cut.n_layers}",
            cut.n_layers),
        "float32_vs_plain": bf16_compare(k32, pl16, f32_fails, "float32",
                                         cut.n_layers),
        "control_vs_plain": bf16_compare(ctl16, pl16, [], "control",
                                         cut.n_layers),
        "calls_held": held, "control_calls_held": ctl_held}
    if not f32_fails:
        problems.append(f"phase 15 {cut.name} x{cut.n_layers}: the float32 "
                        f"run passes the bfloat16 logits bar "
                        f"{BF16_SERVE_BAR[cut.n_layers]}")
    if not (set(held) == {"flash_attention", "rmsnorm", "gated_act"}
            and all(h["close"] for h in held.values())):
        problems.append(f"phase 15 {cut.name} x{cut.n_layers}: a kernel "
                        f"call of the served model is not within the "
                        f"bfloat16 bar of its plain version: {held}")
    if ctl_held.get("flash_attention", {}).get("close", True):
        problems.append(f"phase 15 {cut.name} x{cut.n_layers}: the control "
                        f"(P rounded to bfloat16) passes the per-call hold: "
                        f"{ctl_held}")
    if not kern_d <= BF16_VS_F32_RATIO * plain_d:
        problems.append(f"phase 15 {cut.name} x{cut.n_layers}: the kernels' "
                        f"bfloat16 logits are {kern_d} from the float32 "
                        f"run, over {BF16_VS_F32_RATIO} x the plain path's "
                        f"{plain_d}")
    del k16, pl16, k32, ctl16
    log(f"phase 15: x{cut.n_layers} served "
        f"{time.perf_counter() - t_serve:.1f} s")

    # whole: 62 layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_params.init_params(
        full, torch.Generator(device=dev).manual_seed(0), dev, bf)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
    kern = serve_run(params, full, "cuda", batch, drive, local_ring=True,
                     tag=tags[full.n_layers])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    plain = serve_run(params, full, "torch", batch, drive, local_ring=True,
                      tag=tags[full.n_layers], attn_impl="chunked")
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 15: whole served {time.perf_counter() - t_serve:.1f} s")
    ctl, _ = control(params, full)
    log(f"phase 15: whole control {time.perf_counter() - t_serve:.1f} s")
    busy = serve_busy(params, full, batch, steps=BF16_BUSY_STEPS)
    log(f"phase 15: whole busy {time.perf_counter() - t_serve:.1f} s")
    cache_dtypes = kern["cache_dtypes"]
    del params
    torch.cuda.empty_cache()
    out["whole"] = {
        "layers": full.n_layers, "params": full.num_params(),
        "weights_gb": weights_gb, "init_params_s": init_s,
        "prompt": [SERVE_BATCH, BF16_PROMPT], "decode_steps": SERVE_DECODE,
        "prefill_ms": kern["prefill_ms"],
        "prefill_tokens_per_s":
            SERVE_BATCH * BF16_PROMPT / kern["prefill_ms"] * 1e3,
        "decode_ms_per_step": kern["decode_ms_per_step"],
        "plain_prefill_ms": plain["prefill_ms"],
        "plain_decode_ms_per_step": plain["decode_ms_per_step"],
        "peak_memory_gb_kernels": peak_gb,
        "peak_memory_gb_plain": plain_peak_gb, "device_busy": busy,
        "cache_dtypes": cache_dtypes,
        "kernels_vs_plain": bf16_compare(kern, plain, problems,
                                         f"phase 15 {full.name}",
                                         full.n_layers),
        "control_vs_plain": bf16_compare(ctl, plain, [], "control",
                                         full.n_layers)}
    if cache_dtypes != ["torch.bfloat16"]:
        problems.append(f"phase 15 {full.name}: caches of {cache_dtypes}")
    for c in (cut, full):
        pre, dec = dense_expected(c)
        name = f"{c.name}{tags[c.n_layers]}"
        for p, want in ((f"{name} prefill (cuda)", pre),
                        (f"{name} decode x{SERVE_DECODE} (cuda)", dec)):
            if by_path.get(p) != want:
                problems.append(f"phase 15 {p}: launches {by_path.get(p)}, "
                                f"expected {want}")
        for p in (f"{name} prefill (torch)",
                  f"{name} decode x{SERVE_DECODE} (torch)"):
            if by_path.get(p):
                problems.append(f"phase 15 {p}: the plain path launched "
                                f"{by_path[p]}")
    return out


def bf16_train(drive, by_path, problems, device="cuda") -> dict:
    """Phase 15's training (see the module docstring): gemma2-2b whole
    through ``Trainer(param_dtype="bfloat16")`` on the kernels, step 1 on
    the plain path, on the plain path with its norms rounded once more
    (each leaf's floor) and with P rounded to bfloat16 (the control, which
    must fail step 1's bars), then a bfloat16 checkpoint of gemma2's smoke model
    restored."""
    import tempfile
    from repro_torch import configs
    from repro_torch.optim.tree import tree_leaves
    t_train = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    cfg = configs.get_config(BF16_TRAIN_ARCH)
    seq, gbatch, accum = BF16_TRAIN_SHAPE

    def run(backend, steps, path, suffix, profile=False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer_for(cfg, backend, tmp + suffix, steps, seq_len=seq,
                         batch=gbatch, accum=accum, device=device,
                         param_dtype="bfloat16")
        dtypes = sorted({str(p.dtype) for p in tree_leaves(tr.params)})
        hist = list(drive(path, lambda: tr.run(steps)))
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = profile_train_step(tr) if profile else None   # one more step
        del tr
        return hist, peak, dtypes, prof

    path = f"{cfg.name} bf16 train {BF16_TRAIN_STEPS} steps (cuda)"
    with first_step_leaf_norms() as leaves:
        hist, peak_gb, dtypes, prof = run("cuda", BF16_TRAIN_STEPS, path, "",
                                          profile=True)
    log(f"phase 15: trained on the kernels {time.perf_counter() - t_train:.1f} s")
    plain_path = f"{cfg.name} bf16 train step 1 (torch)"
    with first_step_leaf_norms() as plain_leaves:
        plain_hist, plain_gb, _, _ = run("torch", 1, plain_path, "_plain")
    with first_step_leaf_norms() as floor_leaves, rounded_rmsnorm():
        run("torch", 1, plain_path + " rounded norms", "_floor")
    with first_step_leaf_norms() as ctl_leaves, held_calls(
            attention=p_rounded_attention):
        ctl_hist = run("torch", 1, plain_path + " P rounded", "_ctl")[0]
    log(f"phase 15: trained {time.perf_counter() - t_train:.1f} s")
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "param_dtypes": dtypes, "steps": len(hist), "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": seq * gbatch / step_ms * 1e3,
           "peak_memory_gb": peak_gb, "plain_step1_ms": plain_hist[0]["ms"],
           "plain_peak_memory_gb": plain_gb, "tolerance": BF16_TRAIN_TOL,
           "profile": prof,
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    out["step1_vs_plain"] = hold_leaves_to_floor(
        f"phase 15 {cfg.name} bf16", hist, plain_hist, leaves, plain_leaves,
        floor_leaves, problems, tol=BF16_TRAIN_TOL,
        floor_factor=BF16_LEAF_FLOOR)
    ctl_fails: list = []
    out["control_step1_vs_plain"] = hold_leaves_to_floor(
        "control", ctl_hist, plain_hist, ctl_leaves, plain_leaves,
        floor_leaves, ctl_fails, tol=BF16_TRAIN_TOL,
        floor_factor=BF16_LEAF_FLOOR)
    out["control_step1_vs_plain"]["fails"] = ctl_fails[:3]
    if not ctl_fails:
        problems.append(f"phase 15 {cfg.name} bf16: the control (P rounded "
                        f"to bfloat16) passes step 1's bars")
    half = BF16_TRAIN_STEPS // 2
    if dtypes != ["torch.bfloat16"] or len(hist) != BF16_TRAIN_STEPS or not (
            np.mean(losses[half:]) < np.mean(losses[:half])):
        problems.append(f"phase 15 {cfg.name} bf16 training: parameters "
                        f"{dtypes}, {len(hist)} of {BF16_TRAIN_STEPS} steps, "
                        f"or the loss did not fall: {losses}")
    micro = BF16_TRAIN_STEPS * accum
    want = {e: micro * (2 * n * cfg.n_layers + (e[1] == "rmsnorm"))
            for e, n in TRAIN_NEEDS[BF16_TRAIN_ARCH].items()}
    if by_path[path] != want:
        problems.append(f"phase 15 {path}: launches {by_path[path]}, "
                        f"expected {want}")
    for p in (plain_path, plain_path + " rounded norms",
              plain_path + " P rounded"):
        if by_path[p]:
            problems.append(f"phase 15 {p}: the plain path launched "
                            f"{by_path[p]}")

    # a bfloat16 checkpoint (raw bytes) of the smoke model on the card,
    # written and restored bit for bit, on the plain path
    small = configs.get_smoke(BF16_TRAIN_ARCH)
    a = trainer_for(small, "torch", tmp + "_ckpt", 3, ckpt_every=3,
                    seq_len=64, device=device, param_dtype="bfloat16")
    drive(f"{small.name} bf16 smoke train 3 steps (torch)", lambda: a.run(3))
    a.ckpt.wait()
    b = trainer_for(small, "torch", tmp + "_ckpt", 3, ckpt_every=3,
                    seq_len=64, device=device, param_dtype="bfloat16")
    restored = b.restore_latest()
    same = restored and b.step == 3 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(
            tree_leaves({"p": a.params, "m": a.opt_state["m"],
                         "v": a.opt_state["v"]}),
            tree_leaves({"p": b.params, "m": b.opt_state["m"],
                         "v": b.opt_state["v"]})))
    out["checkpoint"] = {"config": small.name, "step": b.step,
                         "bit_equal": bool(same)}
    if not same:
        problems.append(f"phase 15: the bfloat16 checkpoint of {small.name} "
                        f"was not restored bit for bit (step {b.step})")
    del a, b
    for suffix in ("", "_plain", "_floor", "_ctl", "_ckpt"):
        shutil.rmtree(tmp + suffix, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def bf16_phase(drive, by_path, problems, device="cuda", ptxas=()) -> dict:
    """Phase 15 (see the module docstring)."""
    t_phase = time.perf_counter()
    before = set(by_path)
    out = {"named_raises": bf16_named_raises(problems)}
    # the ungated GELU (no model of the phase has one) through its entry
    # point, at gemma2's MLP activations
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=device).manual_seed(16)
    h = torch.randn(SERVE_BATCH * SERVE_PROMPT, 9216, device=device,
                    generator=g).to(torch.bfloat16)
    act = drive("ops.gated_act ungated gelu bf16",
                lambda: ops.gated_act(h, None, kind="gelu", device=device))
    if not (act.dtype == torch.bfloat16
            and bf16_close(act, ref.gated_act_ref(h, kind="gelu"))):
        problems.append("phase 15 ops.gated_act ungated gelu: bfloat16 kernel "
                        "and plain version disagree")
    del h, act
    out["serving"] = bf16_serve(drive, by_path, problems, device)
    log(f"phase 15: serving {json.dumps(out['serving'], default=str)}")
    out["training"] = bf16_train(drive, by_path, problems, device)
    out["paths"] = [p for p in by_path if p not in before]
    entries = [("tdp_gathered", s) for s in ("rmsnorm", "gated", "act")] + [
        ("flash_attention", "flash_attention")]
    launches = {e: sum(by_path[p].get(e, 0) for p in out["paths"])
                for e in entries}
    launches_by_path = {e: {p: by_path[p][e] for p in out["paths"]
                            if by_path[p].get(e)} for e in entries}
    for e, n in launches.items():
        if not n:
            problems.append(f"phase 15: {e[0]}.{e[1]} was not launched in "
                            f"bfloat16 on the main path")
    out["rows"] = dense_rows(launches, launches_by_path, {}, problems, out,
                             rms_rows=BF16_RMS_ROWS, ew_rows=BF16_EW_ROWS,
                             attn_rows=BF16_ATTN_ROWS, dtype=torch.bfloat16)
    for row in out["rows"]:     # registers and spills in bfloat16, VVL 1
        attn = row["name"].startswith("flash_attention")
        site = "flash_attention" if attn else row["name"].split(".")[1]
        dh = row["shape"][4] if attn else None
        row["ptxas"] = [
            {k: r.get(k) for k in ("mapping", "act", "vvl", "head_dim",
                                   "registers", "spill_stores", "spill_loads")}
            for r in ptxas if r.get("dtype") == "bf16"
            and r.get("site") == site and r.get("head_dim") == dh
            and r.get("vvl") in (None, 1)]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: bfloat16 {out['phase_s']:.1f} s")
    return out


@contextlib.contextmanager
def dt_rounded_scan():
    """The plain path's selective scan (``models.ssm._chunked_scan``) fed
    dt rounded to x's bfloat16, as the ``"cuda"`` route hands dt to the
    ``mamba`` site function (the reference's Pallas scan rounds it, its
    ``"xla"`` scan does not: falcon-mamba's smoke logits 2.9e-2 apart).
    Phase 16's plain path then computes the kernels' function; float32 is
    unchanged (the rounding is a no-op)."""
    from repro_torch.models import ssm
    scan = ssm._chunked_scan

    def rounded(x, dt, *args, **kw):
        return scan(x, dt.to(x.dtype), *args, **kw)
    ssm._chunked_scan = rounded
    try:
        yield
    finally:
        ssm._chunked_scan = scan


def mamba_state_rounded(x, dt, a, d, b, c, batch, length):
    """The control of the bfloat16 ``mamba`` row: the plain body
    (``kernels.lm.mamba_scan_spec``) with its state rounded to bfloat16
    after every step, which ``bf16_close`` must reject."""
    xf, dtf, bf_, cf = x.float(), dt.float(), b.float(), c.float()
    ys, hs = [], []
    for r in range(batch):
        h = torch.zeros(a.shape[0], x.shape[1], device=x.device)
        for t in range(r * length, (r + 1) * length):
            h = (h * torch.exp(dtf[t][None, :] * a)
                 + (dtf[t] * xf[t])[None, :] * bf_[t][:, None]).to(
                     torch.bfloat16).float()
            ys.append((h * cf[t][:, None]).sum(0) + d[0] * xf[t])
        hs.append(h)
    return torch.stack(ys).to(torch.bfloat16), torch.cat(hs)


def bf16_mixed_close(got, want, atol=BF16_ATOL) -> bool:
    """``bf16_close`` for a bfloat16 output, ``LM_TOL`` for a float32 one
    (the scan's final state)."""
    if want.dtype == torch.bfloat16:
        return bf16_close(got, want, atol)
    return bool(got.dtype == want.dtype and torch.isfinite(got).all()
                and torch.allclose(got, want, **LM_TOL))


def bf16_mixed_readings(got, want, atol=BF16_ATOL) -> dict:
    """``bf16_readings`` of a bfloat16 output; a float32 one reads 0."""
    if want.dtype == torch.bfloat16:
        return bf16_readings(got, want, atol)
    return {"max_bf16_steps": 0.0, "share_apart": 0.0}


def scan_close(got, want) -> bool:
    """``bf16_mixed_close`` at the scan's absolute floor
    ``BF16_SCAN_ATOL``."""
    return bf16_mixed_close(got, want, BF16_SCAN_ATOL)


def scan_readings(got, want) -> dict:
    """``bf16_mixed_readings`` at ``BF16_SCAN_ATOL``."""
    return bf16_mixed_readings(got, want, BF16_SCAN_ATOL)


def falcon_expected(cfg) -> tuple[dict, dict, dict]:
    """falcon-mamba's launches on the kernels: one prefill (per layer the
    norm and the scan, the final norm), ``SERVE_DECODE`` decode steps (the
    norms; the O(1) state update is plain PyTorch, as in the reference)
    and one training microbatch (each layer's forward twice under block
    remat, the final norm once)."""
    rms, mamba = ("tdp_gathered", "rmsnorm"), ("tdp_gathered", "mamba")
    n = cfg.n_layers
    return ({rms: n + 1, mamba: n}, {rms: (n + 1) * SERVE_DECODE},
            {rms: 2 * n + 1, mamba: 2 * n})


def bf16_family_expected(cfg) -> tuple[dict, dict]:
    """The launches of one prefill and ``SERVE_DECODE`` decode steps on the
    kernels, as the family's float32 phase holds them."""
    if "mamba1" in cfg.layer_program:
        return falcon_expected(cfg)[:2]
    if "mamba2" in cfg.layer_program:
        return ssd_expected(cfg)[:2]
    if cfg.mla is not None:
        return deepseek_expected(cfg)[:2]
    if cfg.is_encdec:
        return whisper_expected(cfg)[:2]
    return dense_expected(cfg)


def bf16_family_serve(arch, layers, held_layers, nprompts, prompt, drive,
                      by_path, problems, device="cuda") -> dict:
    """Phase 16's serving of one family (see the module docstring): at
    ``held_layers`` every kernel call on the kernels' run held to its plain
    version on the model's own activations (``held_calls``) and the logits
    to the plain path's (``BF16F_SERVE_BAR``); at ``layers`` (the model's
    own depth when None) served on the kernels, timed, the peak and the
    busy share; each path's launches held to the family's float32 count."""
    from repro_torch import configs
    from repro_torch.models import params as model_params
    from repro_torch.optim.tree import tree_leaves
    t0 = time.perf_counter()
    dev, bf = torch.device(device), torch.bfloat16
    full = configs.get_config(arch)
    if full.mtp_depth:
        # serving never reads the MTP module
        full = dataclasses.replace(full, mtp_depth=0)
    cfgs = {}
    for d in {layers, held_layers}:
        cfgs[d] = full if d is None else dataclasses.replace(
            configs.first_layers(full, d), mtp_depth=0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, full.vocab_size, (nprompts, prompt))).to(dev)}
    if full.is_encdec:
        batch["audio_embed"] = torch.from_numpy(rng.standard_normal(
            (nprompts, full.encoder.n_frames, full.d_model),
            dtype=np.float32)).to(dev).to(bf)
    plain_impl = "chunked" if full.attn is not None else "ref"
    out = {"arch": arch, "prompt": [nprompts, prompt],
           "decode_steps": SERVE_DECODE}
    paths = []

    def params_for(cfg):
        torch.cuda.empty_cache()
        return model_params.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev, bf)

    def tag_of(d):
        return f" bf16 x{d}" if d is not None else " bf16"

    # the held depth: every kernel call held, the logits to the plain path
    cut, tag = cfgs[held_layers], tag_of(held_layers)
    p = params_for(cut)
    with held_calls() as held:
        kern = serve_run(p, cut, "cuda", batch, drive, tag=tag)
    with dt_rounded_scan():
        plain = serve_run(p, cut, "torch", batch, drive, tag=tag,
                          attn_impl=plain_impl)
    paths += [f"{cut.name}{tag} prefill", f"{cut.name}{tag} decode"
              f" x{SERVE_DECODE}"]
    # the control, one rounding placed elsewhere on the plain path: P
    # rounded to bfloat16 in every attention (phase 15's), or, for the
    # Mamba-1 family (no attention), dt not rounded (the reference's
    # "xla" scan)
    if cut.attn is not None:
        with held_calls(attention=p_rounded_attention):
            ctl = serve_run(p, cut, "torch", batch, attn_impl=plain_impl)
    else:
        ctl = serve_run(p, cut, "torch", batch, attn_impl=plain_impl)
    bar = BF16F_SERVE_BAR[arch]
    out["held"] = {
        "layers": cut.n_layers, "calls_held": held,
        "kernels_vs_plain": bf16_compare(kern, plain, problems,
                                         f"phase 16 {cut.name}{tag}",
                                         cut.n_layers, bar=bar),
        "control_vs_plain": bf16_compare(ctl, plain, [], "control",
                                         cut.n_layers, bar=bar)}
    want_calls = {"flash_attention"} if cut.attn is not None else set()
    want_calls |= {"mamba_scan"} if "mamba1" in cut.layer_program else set()
    if not (want_calls <= set(held)
            and all(h["close"] for h in held.values())):
        problems.append(f"phase 16 {cut.name}{tag}: a kernel call of the "
                        f"served model is not within the bfloat16 bar of "
                        f"its plain version: {held}")
    del kern, plain, ctl
    # the served depth: timed, the peak, the busy share
    cfg = cfgs[layers]
    if cfg is not cut:
        del p
        tag = tag_of(layers)
        torch.cuda.reset_peak_memory_stats()
        p = params_for(cfg)
        kern = serve_run(p, cfg, "cuda", batch, drive, tag=tag)
        paths += [f"{cfg.name}{tag} prefill", f"{cfg.name}{tag} decode"
                  f" x{SERVE_DECODE}"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    else:
        torch.cuda.reset_peak_memory_stats()
        kern = serve_run(p, cfg, "cuda", batch)      # warm, timed
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy = serve_busy(p, cfg, batch, steps=BF16_BUSY_STEPS)
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(p)) / 1e9
    del p
    torch.cuda.empty_cache()
    out.update({
        "layers": cfg.n_layers, "params": cfg.num_params(),
        "weights_gb": weights_gb, "prefill_ms": kern["prefill_ms"],
        "prefill_tokens_per_s": nprompts * prompt / kern["prefill_ms"] * 1e3,
        "decode_ms_per_step": kern["decode_ms_per_step"],
        "peak_memory_gb": peak_gb, "device_busy": busy,
        "cache_dtypes": kern["cache_dtypes"]})
    if not all(torch.isfinite(lg).all() for lg in kern["logits"]):
        problems.append(f"phase 16 {cfg.name}: non-finite logits")
    for c, t in {(cut, tag_of(held_layers)), (cfg, tag_of(layers))}:
        pre, dec = bf16_family_expected(c)
        for pth, want in ((f"{c.name}{t} prefill (cuda)", pre),
                          (f"{c.name}{t} decode x{SERVE_DECODE} (cuda)",
                           dec)):
            if by_path.get(pth) != want:
                problems.append(f"phase 16 {pth}: launches "
                                f"{by_path.get(pth)}, expected {want}")
    for pth in (f"{paths[0]} (torch)", f"{paths[1]} (torch)"):
        if by_path.get(pth):
            problems.append(f"phase 16 {pth}: the plain path launched "
                            f"{by_path[pth]}")
    out["serve_s"] = time.perf_counter() - t0
    log(f"phase 16: {arch} served {out['serve_s']:.1f} s")
    return out


@contextlib.contextmanager
def rounded_layernorm():
    """``models.layers.layernorm`` (whisper's norms: plain PyTorch, no
    kernel) computed in float64 and rounded to the input's dtype once, as
    ``rounded_rmsnorm`` moves RMSNorm's outputs: the floor of whisper's
    leaves for ``hold_leaves_to_floor``."""
    from repro_torch.models import layers
    layernorm = layers.layernorm

    def rounded(w, x):
        xd = x.double()
        mu = xd.mean(-1, keepdim=True)
        var = xd.var(-1, unbiased=False, keepdim=True)
        return ((xd - mu) * torch.rsqrt(var + 1e-5)
                * (1.0 + w.double())).to(x.dtype)
    layers.layernorm = rounded
    try:
        yield
    finally:
        layers.layernorm = layernorm


def train_expected(cfg, accum: int = 1) -> dict:
    """The launches of one training step of ``accum`` microbatches on the
    kernels, as the family's float32 phase holds them; a model of
    attention layers with one gated MLP each (granite's ``attn_moe``:
    the packed experts' SwiGLU) runs each layer's forward twice (block
    remat): kernel 4 and the gated site twice, its two norms four times,
    and the final norm once."""
    if "mamba1" in cfg.layer_program:
        return {e: accum * n for e, n in falcon_expected(cfg)[2].items()}
    if "mamba2" in cfg.layer_program:
        return {e: accum * n for e, n in ssd_expected(cfg)[2].items()}
    if cfg.mla is not None:
        return deepseek_expected(cfg, accum)[2]
    if cfg.is_encdec:
        return whisper_expected(cfg, accum)[2]
    n = cfg.n_layers
    return {("flash_attention", "flash_attention"): accum * 2 * n,
            ("tdp_gathered", "gated"): accum * 2 * n,
            ("tdp_gathered", "rmsnorm"): accum * (4 * n + 1)}


@contextlib.contextmanager
def chunked_backward():
    """Kernel 4's gradient as the reference's chunked oracle computes it
    (``ref._chunk_bwd`` without ``as_plain``: the softmax jacobian's
    diagonal term Σ dout·out from the bfloat16 output, a group's dk and dv
    summed before they are rounded): the control of phase 16's training
    holds (``BF16F_TRAIN_CONTROL``)."""
    from repro_torch.kernels import ops
    ops._FlashFn.as_plain = False
    try:
        yield
    finally:
        ops._FlashFn.as_plain = True


def bf16_family_train(arch, layers, held, shape, quant, steps, drive,
                      by_path, problems, device="cuda") -> dict:
    """Phase 16's training of one family (``BF16F_TRAINS``) in bfloat16 on
    the kernels: through ``Trainer(param_dtype="bfloat16")``, or for
    whisper ``whisper_train_run`` on ``init_params(dtype=bfloat16)``; then
    step 1 on the plain path from the same weights and batch, and once more
    with its norms rounded once more (``rounded_rmsnorm``,
    ``rounded_layernorm``: each leaf's floor), held at ``BF16_TRAIN_TOL``
    by ``hold_leaves_to_floor`` (``BF16_LEAF_FLOOR``; widened as
    ``BF16F_TRAIN_WIDE`` says, the holds that the bars as set would refuse
    recorded), and the MTP model's ``ce`` and
    ``mtp`` at its loss bar.  Where ``held`` is not ``layers`` step 1 is
    taken again at that depth, on the kernels and the plain paths, and held
    there; the trained depth's step-1 loss is held to the plain path's from
    the same weights and batch at ``BF16_TRAIN_TOL`` (its gradient norm
    recorded).  For ``BF16F_TRAIN_CONTROL``'s families kernel 4's backward
    as the chunked oracle computes it (``chunked_backward``) must fail the
    hold.  The plain runs take the
    scan fed dt rounded as the kernels take it (``dt_rounded_scan``) and
    every MoE route of the kernels' step 1 (``forced_routes``): bfloat16
    router logits tie far more often than float32 ones, and a route that
    flips moves its expert's gradient past any bar; the routes the plain
    path would have taken are compared and reported (``RouteHold``), not
    held.  Step ms (median from step 2), tokens/s, the peak, each path's
    launches against ``train_expected``; the plain paths launch none."""
    import tempfile
    from repro_torch import configs
    from repro_torch.optim.tree import tree_leaves
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_train_")
    full = configs.get_config(arch)
    cfg = configs.first_layers(full, layers) if layers else full
    hcfg = cfg if held == layers else configs.first_layers(full, held)
    seq, gbatch, accum = shape

    def run(c, backend, nsteps, path, suffix):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if c.is_encdec:
            params, hist, peak = whisper_train_run(
                c, backend, nsteps, path, drive, device,
                dtype=torch.bfloat16, seq=seq, batch=gbatch, accum=accum)
        else:
            tr = trainer_for(c, backend, tmp + suffix, nsteps, seq_len=seq,
                             batch=gbatch, accum=accum, device=device,
                             param_dtype="bfloat16", quant_moments=quant)
            hist = list(drive(path, lambda: tr.run(nsteps)))
            params = tr.params
            peak = torch.cuda.max_memory_allocated() / 1e9
        dtypes = sorted({str(q.dtype) for q in tree_leaves(params)})
        del params
        return hist, peak, dtypes

    path = f"{cfg.name} bf16 train {steps} steps (cuda)"
    tag = "" if hcfg is cfg else f" x{held}"
    held_path = f"{hcfg.name} bf16 train step 1{tag} (cuda)"
    with first_step_leaf_norms() as leaves, \
            recorded_routes() as whole_routes:
        hist, peak_gb, dtypes = run(cfg, "cuda", steps, path, "")
    khist, kern_routes = hist, whole_routes
    if hcfg is not cfg:
        with first_step_leaf_norms() as leaves, \
                recorded_routes() as kern_routes:
            khist, _, _ = run(hcfg, "cuda", 1, held_path, "_held")
    plain_path = f"{hcfg.name} bf16 train step 1{tag} (torch)"
    plain_paths = [plain_path, plain_path + " rounded norms"]
    with first_step_leaf_norms() as plain_leaves, dt_rounded_scan(), \
            recorded_routes() as plain_routes, forced_routes(kern_routes):
        plain_hist, plain_gb, _ = run(hcfg, "torch", 1, plain_path, "_plain")
    with first_step_leaf_norms() as floor_leaves, dt_rounded_scan(), \
            forced_routes(kern_routes), rounded_rmsnorm(), \
            rounded_layernorm():
        floor_hist, _, _ = run(hcfg, "torch", 1,
                               plain_path + " rounded norms", "_floor")
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "param_dtypes": dtypes, "shape": list(shape),
           "moments": "8-bit" if quant else "float32", "steps": len(hist),
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": [h["ms"] for h in hist],
           "step_ms_median_from_2": step_ms,
           "tokens_per_s": seq * gbatch / step_ms * 1e3,
           "peak_memory_gb": peak_gb, "plain_step1_ms": plain_hist[0]["ms"],
           "plain_peak_memory_gb": plain_gb, "tolerance": BF16_TRAIN_TOL,
           "launches": {f"{k}.{s}": n for (k, s), n in by_path[path].items()}}
    if cfg.is_encdec:
        out["layers"] = [cfg.encoder.n_layers, cfg.n_layers]
        out["frames_per_s"] = gbatch * cfg.encoder.n_frames / step_ms * 1e3
    what = f"phase 16 {hcfg.name}{tag} bf16"
    out["held_layers"] = hcfg.n_layers
    out["floor_vs_plain"] = {
        k: abs(floor_hist[0][k] - plain_hist[0][k]) / abs(plain_hist[0][k])
        for k in ("loss", "grad_norm")}

    def hold(kern_hist, kern_leaves, probs,
             wide=BF16F_TRAIN_WIDE.get(arch, ())):
        return hold_leaves_to_floor(
            what, kern_hist, plain_hist, kern_leaves, plain_leaves,
            floor_leaves, probs, tol=BF16_TRAIN_TOL,
            floor_factor=BF16_LEAF_FLOOR,
            floor_hist=floor_hist if "grad_norm" in wide else None,
            pooled="pooled" in wide)
    out["step1_vs_plain"] = hold(khist, leaves, problems)
    if arch in BF16F_TRAIN_WIDE:
        # what the bars as set on gemma2 would refuse: why this one is wide
        narrow: list = []
        hold(khist, leaves, narrow, wide=())
        out["step1_vs_plain"]["fails_unwidened"] = {"count": len(narrow),
                                                     "first": narrow[:4]}
    if hcfg is not cfg:
        # the trained depth's loss from the same weights and batch
        whole_path = f"{cfg.name} bf16 train step 1 (torch)"
        with dt_rounded_scan(), forced_routes(whole_routes):
            whole_hist, _, _ = run(cfg, "torch", 1, whole_path, "_whole")
        plain_paths.append(whole_path)
        k, pl = hist[0]["loss"], whole_hist[0]["loss"]
        out["whole_step1_vs_plain"] = {
            "loss": {"kernels": k, "plain": pl,
                     "rel_diff": abs(k - pl) / abs(pl)},
            "grad_norm_unheld": {
                "kernels": hist[0]["grad_norm"],
                "plain": whole_hist[0]["grad_norm"],
                "rel_diff": abs(hist[0]["grad_norm"]
                                - whole_hist[0]["grad_norm"])
                / abs(whole_hist[0]["grad_norm"])}}
        if not (math.isfinite(k) and abs(k - pl)
                <= BF16_TRAIN_TOL["loss"] * abs(pl)):
            problems.append(f"{what}: step-1 loss at {cfg.n_layers} layers "
                            f"{k} on the kernels, {pl} on the plain path")
    if arch in BF16F_TRAIN_CONTROL:
        with first_step_leaf_norms() as ctl_leaves, chunked_backward():
            ctl_hist, _, _ = run(hcfg, "cuda", 1, held_path + " control",
                                 "_control")
        caught: list = []
        out["control"] = hold(ctl_hist, ctl_leaves, caught)
        out["control"]["failed_holds"] = len(caught)
        if not caught:
            problems.append(f"{what}: the control (kernel 4's backward as "
                            f"the chunked oracle computes it) passes the "
                            f"step-1 hold: {out['control']}")
    for key in ("ce", "mtp") if hcfg.mtp_depth else ():
        k, pl = khist[0][key], plain_hist[0][key]
        out["step1_vs_plain"][key] = {"kernels": k, "plain": pl,
                                      "rel_diff": abs(k - pl) / abs(pl)}
        if not (math.isfinite(k) and abs(k - pl) <= BF16_TRAIN_TOL["loss"]
                * abs(pl)):
            problems.append(f"{what}: step-1 {key} {k} on the kernels, {pl} "
                            f"on the plain path")
    if "attn_moe" in hcfg.layer_program:
        # the first forward's routes of step 1: the plain path's own, were
        # it not held to the kernels'
        n_moe = hcfg.layer_program.count("attn_moe")
        hold = RouteHold(cfg.moe, 1, f"{what} training step 1")
        for c, (a, b) in enumerate(zip(kern_routes[:n_moe],
                                       plain_routes[:n_moe])):
            hold.call(c, a, b)
        out["step1_routes"] = hold.report([])
        out["step1_routes"]["forced_calls"] = len(plain_routes)
    if dtypes != ["torch.bfloat16"] or len(hist) != steps or not all(
            math.isfinite(x) for x in losses):
        problems.append(f"{what} training: parameters {dtypes}, {len(hist)} "
                        f"of {steps} steps, losses {losses}")
    for pth, c, n in ((path, cfg, steps), (held_path, hcfg, 1)):
        want = {e: n * k for e, k in train_expected(c, accum).items()}
        if pth in by_path and by_path[pth] != want:
            problems.append(f"phase 16 {pth}: launches {by_path[pth]}, "
                            f"expected {want}")
    for pth in plain_paths:
        if by_path[pth]:
            problems.append(f"phase 16 {pth}: the plain path launched "
                            f"{by_path[pth]}")
    for suffix in ("", "_held", "_plain", "_floor", "_whole", "_control"):
        shutil.rmtree(tmp + suffix, ignore_errors=True)
    torch.cuda.empty_cache()
    out["train_s"] = time.perf_counter() - t0
    log(f"phase 16: {cfg.name} trained in bf16 {out['train_s']:.1f} s: "
        f"{json.dumps(out, default=str)}")
    return out


def bf16_family_rows(launches, launches_by_path, problems, record,
                     ptxas, device="cuda") -> list:
    """Phase 16's rows in bfloat16: the ``mamba`` site function at
    falcon-mamba-7b's layer and kernel 4 at ``BF16F_ATTN_ROWS``, each held
    to its plain version on the same bfloat16 inputs (``bf16_close``;
    the scan's float32 state at ``LM_TOL``) against a control that must
    fail that bar (the state rounded to bfloat16 each step;
    ``p_rounded_attention``), timed beside it (the scan at every VVL), its
    bound and the bfloat16 library call where one exists (SDPA; recorded,
    not held), with its registers and spills."""
    import torch.nn.functional as F
    from repro_torch.core import Target
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import flash_attention, lm, ref, tdp_pointwise
    dev, bf = torch.device(device), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(16)
    rows = []
    # the scan: x, dt (softplus, rounded), b, c bfloat16; a, d float32
    batch, length, n, nstate = BF16F_MAMBA
    nr = batch * length
    xs = [torch.randn(nr, n, device=dev, generator=g).to(bf),
          F.softplus(torch.randn(nr, n, device=dev, generator=g)).to(bf),
          -torch.exp(torch.randn(nstate, n, device=dev, generator=g)),
          torch.ones(1, n, device=dev)]
    consts = {"b": torch.randn(nr, nstate, device=dev, generator=g).to(bf),
              "c": torch.randn(nr, nstate, device=dev, generator=g).to(bf)}
    spec = lm.mamba_scan_spec(length, nstate, batch)
    plan = launch_plan(spec, Target("cuda", vvl=1), consts=consts)
    # x, dt read and y written (2 bytes); a, d read (4); b, c read (2) and h
    # written (4) a row; the exponentials on the SFUs as in float32
    nbytes = (2 * 3 * nr * n + 4 * (nstate * n + n)
              + batch * (4 * nstate * n + 2 * 2 * length * nstate))
    bounds = [(nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
              (nr * n * nstate / PEAK_SFU_PER_S * 1e3, "operations"),
              ((6 * nstate + 3) * nr * n / PEAK_F32_PER_S * 1e3,
               "operations")]
    rows.append(lm_row(
        "tdp_gathered.mamba.bf16_falcon", KERNELS["tdp_gathered.mamba"],
        ("tdp_gathered", "mamba"),
        lambda: tdp_pointwise.cuda_execute(plan, xs),
        lambda: torch_executor(plan, xs), None, max(bounds),
        launches, launches_by_path, {}, problems, record,
        max_err_key="tdp_gathered.mamba.bf16", plain_reps=MAMBA_PLAIN_REPS,
        plain_wall=True, close=scan_close, readings=scan_readings,
        control=lambda: mamba_state_rounded(*xs, consts["b"], consts["c"],
                                            batch, length),
        hold=SHORT_HOLD))
    rows[-1]["shape"] = [batch, length, n, nstate]
    rows[-1]["ms_by_vvl"] = {vvl: time_ms(lambda p=launch_plan(
        spec, Target("cuda", vvl=vvl), consts=consts):
        tdp_pointwise.cuda_execute(p, xs), hold=SHORT_HOLD)
        for vvl in (1, 2, 4, 8)}
    log(f"phase 16: mamba bf16 ms by VVL {rows[-1]['ms_by_vvl']}")
    del xs, consts, plan
    torch.cuda.empty_cache()
    for tag, b, hq, hkv, sq, sk, dh, causal in BF16F_ATTN_ROWS:
        q = torch.randn(b, hq, sq, dh, device=dev, generator=g).to(bf)
        k, v = (torch.randn(b, hkv, sk, dh, device=dev, generator=g).to(bf)
                for _ in range(2))
        lib = ((lambda q=q, k=k, v=v, causal=causal:
                F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                               enable_gqa=True)),
               (lambda o: (o,)))
        shape = (b, hq, hkv, sq, sk, dh, causal, 0)
        name = f"flash_attention.{tag}"
        rows.append(lm_row(
            name, KERNELS["flash_attention"],
            ("flash_attention", "flash_attention"),
            lambda q=q, k=k, v=v, causal=causal:
                flash_attention.flash_attention(q, k, v, causal=causal),
            lambda q=q, k=k, v=v, causal=causal: ref.attention_chunked_ref(
                q, k, v, causal=causal, block_q=512),
            lib, attn_bound(*shape, elem_bytes=2,
                            per_flop=BF16_ATTN_PER_FLOP),
            launches, launches_by_path, {}, problems, record,
            max_err_key="flash_attention.bf16",
            plain_reps=BF16F_ATTN_PLAIN_REPS, close=bf16_close,
            readings=bf16_readings, hold_library=False, hold=SHORT_HOLD,
            control=lambda q=q, k=k, v=v, causal=causal: p_rounded_attention(
                q, k, v, causal=causal)))
        rows[-1]["shape"] = [b, hq, hkv, sq, sk, dh, causal]
        rows[-1]["plain"] = "attention_chunked_ref(block_q=512)"
        del q, k, v, lib
        torch.cuda.empty_cache()
    for row in rows:
        row["dtype"] = "bfloat16"
        attn = row["name"].startswith("flash_attention")
        site = "flash_attention" if attn else "mamba"
        dh = row["shape"][5] if attn else None
        row["ptxas"] = [
            {k: r.get(k) for k in ("mapping", "nstate", "vvl", "head_dim",
                                   "registers", "spill_stores",
                                   "spill_loads")}
            for r in ptxas if r.get("dtype") == "bf16"
            and r.get("site") == site and r.get("head_dim") == dh
            and (attn or r.get("nstate") == BF16F_MAMBA[3])]
    return rows


def bf16_family_checks(problems, device="cuda") -> dict:
    """Phase 16's checks before the models: kernel 4 in bfloat16 at every
    head dim it is instantiated for (``BF16F_ATTN_CHECKS``: ragged query and
    key tiles, GQA, a window and softcap, non-causal Sq ≠ Sk) and the
    ``mamba`` site function in bfloat16 at every VVL over ragged shapes
    (``BF16F_MAMBA_CHECKS``; n not a multiple of 8 stages x and dt a value
    at a time), each held to its plain version by ``bf16_mixed_close``;
    the worst ``bf16_readings`` recorded.  Then kernel 4's bfloat16
    gradient at each family's training microbatch (``BF16F_ATTN_GRADS``)
    against the plain version's autograd, the chunked oracle's backward
    (``chunked_backward``) its control."""
    from repro_torch.kernels import flash_attention, ops, ref
    dev, bf = torch.device(device), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(161)
    out = {"flash_attention": {}, "mamba": {}}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(bf)
    for dh in flash_attention.HEAD_DIMS:
        worst = {"max_bf16_steps": 0.0, "share_apart": 0.0}
        for b, hq, hkv, sq, sk, kw in BF16F_ATTN_CHECKS:
            q, k, v = randn(b, hq, sq, dh), randn(b, hkv, sk, dh), randn(
                b, hkv, sk, dh)
            got = flash_attention.flash_attention(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            if not bf16_close(got, want):
                problems.append(f"phase 16: kernel 4 in bfloat16 at Dh {dh} "
                                f"{(b, hq, hkv, sq, sk, kw)}: "
                                f"{bf16_readings(got, want)}")
            for key, val in bf16_readings(got, want).items():
                worst[key] = max(worst[key], val)
        out["flash_attention"][dh] = worst
    for b, length, n, nstate in BF16F_MAMBA_CHECKS:
        x, dt = randn(b, length, n), torch.nn.functional.softplus(
            randn(b, length, n).float()).to(bf)
        bb, cc = randn(b, length, nstate), randn(b, length, nstate)
        a = -torch.exp(torch.randn(n, nstate, device=dev, generator=g))
        d = torch.randn(n, device=dev, generator=g)
        want = ops.mamba_scan(x, dt, bb, cc, a, d, target="torch",
                              device=dev)
        worst = {"max_bf16_steps": 0.0, "share_apart": 0.0}
        for vvl in (1, 2, 4, 8):
            got = ops.mamba_scan(x, dt, bb, cc, a, d, vvl=vvl, device=dev)
            for gg, ww in zip(got, want):
                if not scan_close(gg, ww):
                    problems.append(f"phase 16: mamba in bfloat16 "
                                    f"{(b, length, n, nstate)} vvl={vvl}: "
                                    f"{scan_readings(gg, ww)}")
            for key, val in scan_readings(got[0], want[0]).items():
                worst[key] = max(worst[key], val)
        out["mamba"][str((b, length, n, nstate))] = worst
    out["flash_attention_grad"] = {}
    for tag, b, hq, hkv, sq, sk, dh, causal in BF16F_ATTN_GRADS:
        q, k = 2 * randn(b, hq, sq, dh), 2 * randn(b, hkv, sk, dh)
        v, dout = randn(b, hkv, sk, dh), randn(b, hq, sq, dh)

        def grads(fn):
            xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            fn(*xs, causal=causal).backward(dout)
            return [x.grad for x in xs]

        def kernel(*xs, **kw):
            return ops.flash_attention(*xs, target="cuda", device=dev, **kw)
        want = grads(ref.attention_ref)
        got = grads(kernel)
        with chunked_backward():
            ctl = grads(kernel)
        res = {f"d{n}": bf16_readings(a, w)
               for n, a, w in zip("qkv", got, want)}
        res["control_share_apart"] = max(
            bf16_readings(a, w)["share_apart"] for a, w in zip(ctl, want))
        out["flash_attention_grad"][tag] = res
        if not all(a.dtype == bf and torch.isfinite(a).all()
                   and r["share_apart"] <= BF16_SHARE_BAR
                   for a, r in zip(got, list(res.values())[:3])):
            problems.append(f"phase 16: kernel 4's bfloat16 gradient at "
                            f"{tag}'s microbatch: {res}")
        if res["control_share_apart"] <= BF16_SHARE_BAR:
            problems.append(f"phase 16: kernel 4's gradient as the chunked "
                            f"oracle computes it passes at {tag}'s "
                            f"microbatch: {res}")
        del q, k, v, dout, want, got, ctl
    torch.cuda.empty_cache()
    log(f"phase 16: checks {json.dumps(out)}")
    return out


def bf16_families_phase(drive, by_path, problems, device="cuda",
                        ptxas=()) -> dict:
    """Phase 16 (see the module docstring)."""
    t_phase = time.perf_counter()
    before = set(by_path)
    out = {"checks": bf16_family_checks(problems, device), "serving": {}}
    for arch, layers, held_layers, nprompts, prompt in BF16F_SERVE:
        out["serving"][arch] = bf16_family_serve(
            arch, layers, held_layers, nprompts, prompt, drive, by_path,
            problems, device)
        log(f"phase 16: {arch} "
            f"{json.dumps(out['serving'][arch], default=str)}")
    out["training"] = {
        arch: bf16_family_train(arch, layers, held, shape, quant, steps,
                                drive, by_path, problems, device)
        for arch, layers, held, shape, quant, steps in BF16F_TRAINS}
    out["paths"] = [p for p in by_path if p not in before]
    entries = [("tdp_gathered", "mamba"),
               ("flash_attention", "flash_attention")]
    launches = {e: sum(by_path[p].get(e, 0) for p in out["paths"])
                for e in entries}
    launches_by_path = {e: {p: by_path[p][e] for p in out["paths"]
                            if by_path[p].get(e)} for e in entries}
    for e, n in launches.items():
        if not n:
            problems.append(f"phase 16: {e[0]}.{e[1]} was not launched in "
                            f"bfloat16 on the main path")
    out["rows"] = bf16_family_rows(launches, launches_by_path, problems, out,
                                   ptxas, device)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: bfloat16 families {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: bfloat16 in the LB and example kernels (ROADMAP A7.1c.3)
# ---------------------------------------------------------------------------

#: the CamelCase of each LB site function in the ptxas report
LB_SITE_CC = {"stream": "Stream", "grad6": "Grad6", "moment": "Moment",
              "collide": "Collide", "fused": "Fused", "phi_stream": "PhiStream",
              "fused_two": "FusedTwo"}


def lb_bf16_inputs(spec, shape, halo=(0, 0, 0), *, seed, device="cuda"):
    """Phase 3's random fields in bfloat16 (f = 1/19 + 0.01·N, the rest
    0.05·N), drawn in float32 and rounded."""
    r = np.random.default_rng(seed)
    n = int(np.prod(shape))
    n_ext = int(np.prod([s + 2 * h for s, h in zip(shape, halo)]))
    xs = []
    for fs in spec.fields:
        x = r.standard_normal((fs.ncomp, n if fs.stencil is None else n_ext),
                              dtype=np.float32)
        x = 1.0 / 19.0 + 0.01 * x if fs.name == "f" else 0.05 * x
        xs.append(torch.from_numpy(x).to(device).to(torch.bfloat16))
    return xs


def lb_bf16_hold(what, got, want, problems) -> dict:
    """bfloat16 kernel outputs against their plain version on the same
    inputs: bit-equality expected (the kernels round as the plain bodies
    do), held at ``bf16_close``."""
    r = {"bit_equal": all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                          for g, w in zip(got, want)),
         "max_abs_err": max_abs(got, want),
         "share_apart": max(bf16_readings(g, w)["share_apart"]
                            for g, w in zip(got, want))}
    if not all(bf16_close(g, w) for g, w in zip(got, want)):
        problems.append(f"phase 17: {what}: bfloat16 kernel and plain "
                        f"version disagree {r}")
    elif not r["bit_equal"]:
        log(f"phase 17: {what} not bit-equal to the plain version: {r}")
    return r


def lb_bf16_ptxas(ptxas, lib, site) -> list:
    """Registers and spills of the bfloat16 kernels of ``site`` in ``lib``
    at VVL 1 (and the windowed fused's tile)."""
    cc = "collide" if lib == "lb_collision" else (
        site if lib == "tdp_gathered_example" else LB_SITE_CC[site])
    return [{k: r.get(k) for k in ("mapping", "vvl", "op", "registers",
                                   "spill_stores", "spill_loads")}
            for r in ptxas if r.get("lib") == lib and r.get("dtype") == "bf16"
            and str(r.get("site", "")).lower() == cc.lower()
            and r.get("vvl") in (None, 1)]


def lb_bf16_paths(drive, problems, out, device="cuda") -> None:
    """Phase 17's main path in bfloat16, each path counted: the three LB
    regimes at 128³, the ops entry points, the examples and reduce; the
    regimes held to the plain path on the card at ``LB_BF16_CHECK_GRID``;
    MLUPS beside this process's float32 MLUPS."""
    from repro_torch.core import Target
    from repro_torch.core.api import launch
    from repro_torch.core.execute import reduce
    from repro_torch.kernels import bf16 as kbf16
    from repro_torch.kernels import example_sites as ex
    from repro_torch.kernels import lb_collision, ops
    from repro_torch.lb import stencil
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim
    bf = torch.bfloat16
    params = LBParams(**PARAMS)
    regimes = (False, "one_launch", "two_launch")
    sims = {r: BinaryFluidSim(GRID, params, fused=r, dtype=bf, device=device)
            for r in regimes}
    st0 = sims[False].init_spinodal(seed=0, noise=0.05)
    obs0 = sims[False].observables(st0)
    finals = {str(r): drive(f"lb_bf16: BinaryFluidSim bf16 fused={r}",
                            lambda sim=sim: sim.run(st0, STEPS))
              for r, sim in sims.items()}
    out["observables"] = {}
    for r, st in finals.items():
        obs = sims[False].observables(st)
        out["observables"][r] = obs
        if st.f.dtype != bf or obs["nan"]:
            problems.append(f"phase 17 regime {r}: dtype {st.f.dtype}, NaN "
                            f"{obs['nan']}")
        out["observables"][r]["mass_drift"] = obs["mass"] - obs0["mass"]
    fin = finals["two_launch"]
    f2, g2 = fin.f.reshape(19, -1), fin.g.reshape(19, -1)
    phi = kbf16.sum0(g2, keepdim=True)
    grad, lap = stencil.gradients(phi.reshape(GRID))
    fo, go = drive("lb_bf16: ops.lb_collision bf16", lambda: ops.lb_collision(
        f2, g2, phi, grad.reshape(3, -1), lap.reshape(1, -1),
        target="cuda", device=device, **params.as_kwargs()))
    out["ops.lb_collision"] = lb_bf16_hold(
        "ops.lb_collision", (fo, go), lb_collision.collision_site_kernel(
            f2, g2, phi, grad.reshape(3, -1), lap.reshape(1, -1),
            w=lb_collision.WEIGHTS, c=lb_collision.CV,
            **params.as_kwargs()), problems)
    for mode in ("one_launch", "two_launch"):
        got = {tgt: drive(f"lb_bf16: ops.lb_fused_step {mode} {tgt}",
                          lambda mode=mode, tgt=tgt: ops.lb_fused_step(
                              f2, g2, grid_shape=GRID, mode=mode,
                              target=Target(tgt), device=device,
                              **params.as_kwargs()))
               for tgt in ("cuda_windowed", "cuda")}
        out[f"ops.lb_fused_step {mode}"] = lb_bf16_hold(
            f"ops.lb_fused_step {mode} windowed vs gathered",
            got["cuda_windowed"], got["cuda"], problems)
    del fo, go, got, grad, lap, phi, f2, g2, fin
    # the examples and reduce through their entry points
    g = torch.Generator(device=device).manual_seed(17)
    n = int(np.prod(GRID))
    x, y = (torch.randn(TDP_NCOMP, n, device=device, generator=g).to(bf)
            for _ in range(2))
    specs = {s: dataclasses.replace(ex.SPECS[s], out=TDP_NCOMP)
             for s in ex.SPECS}
    ins = {"scale": [x], "saxpy": [x, y], "site_pos": [x]}
    drive("lb_bf16: tdp.launch examples bf16", lambda: [launch(
        specs[s], Target("cuda"), *ins[s],
        consts={} if s == "site_pos" else {"a": LB_BF16_A}) for s in specs])
    drive("lb_bf16: reduce bf16", lambda: [reduce(
        specs["scale"], None, [x], consts={"a": 1.0}, op=op,
        target=Target("cuda")) for op in ("sum", "max", "min")])
    del x, y
    # each regime held to the plain path on the card at a small size
    out["vs_plain_small"] = {}
    for r in regimes:
        states = []
        for backend in (None, "torch"):
            sim = BinaryFluidSim(LB_BF16_CHECK_GRID, params, fused=r,
                                 dtype=bf, backend=backend or (
                                     ("cuda_windowed" if r else "cuda")),
                                 device=device)
            states.append(sim.run(sim.init_spinodal(seed=3, noise=0.05),
                                  LB_BF16_CHECK_STEPS))
        out["vs_plain_small"][str(r)] = lb_bf16_hold(
            f"{LB_BF16_CHECK_GRID} regime {r} vs the plain path",
            (states[0].f, states[0].g), (states[1].f, states[1].g), problems)
    # MLUPS, bfloat16 beside float32, in turns in this process
    mlups = {}
    f32_sims = {r: BinaryFluidSim(GRID, params, fused=r, device=device)
                for r in regimes}
    f32_st0 = f32_sims[False].init_spinodal(seed=0, noise=0.05)
    for dtype, ss, s0 in (("bf16", sims, st0), ("f32", f32_sims, f32_st0),
                          ("bf16_again", sims, st0)):
        for r, sim in ss.items():
            sim.run(s0, 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sim.run(s0, STEPS)
            torch.cuda.synchronize()
            mlups.setdefault(dtype, {})[str(r)] = (
                n * STEPS / (time.perf_counter() - t) / 1e6)
    out["mlups_128cubed_20_steps"] = mlups
    log(f"phase 17: MLUPS {mlups}")


def lb_bf16_rows(by_path, paths, problems, ptxas, device="cuda") -> list:
    """Phase 17's rows: every LB kernel × site function and the example
    sites and reduce in bfloat16 at 128³ (examples at (3, 128³)), each held
    to its plain version on the same inputs (at VVL 1, 2, 4 and 8 on a
    ragged lattice with ghost planes too), timed beside it, its bfloat16
    bound and library call, with its registers and spills; launches from
    the phase's paths."""
    from repro_torch.core import Lattice, Target, field_view
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.core.execute import reduce
    from repro_torch.core.target import CUDA_VVLS
    from repro_torch.kernels import _build
    from repro_torch.kernels import example_sites as ex
    from repro_torch.kernels import lb_collision, tdp_pointwise, tdp_windowed
    from repro_torch.lb import programs, stencil
    bf = torch.bfloat16
    consts = programs.collision_consts(dtype=bf, **PHYS)

    def launches(key):
        return {p: by_path[p][key] for p in paths if by_path[p].get(key)}

    def plan_of(kernel, site, shape, halo=None, vvl=1, pb=None):
        spec = stencil.SPECS[site]
        tgt = Target("cuda_windowed" if kernel == "tdp_windowed" else "cuda",
                     vvl=vvl)
        if pb is not None:
            tgt = tgt.with_tuning(plane_block=pb)
        return launch_plan(spec, tgt, lattice=Lattice(shape)
                           if spec.has_stencil else None,
                           halo=halo if spec.has_stencil else None,
                           consts=consts if spec.consts else {})

    def execute(kernel, plan, prepared):
        if kernel == "tdp_windowed":
            return tdp_windowed.windowed_execute(plan, prepared)
        return tdp_pointwise.cuda_execute(plan, prepared)

    def prepare(spec, xs, shape, halo=(0, 0, 0)):
        return tuple(x if s is None else field_view(x, shape, halo, s)
                     for x, s in zip(xs, spec.stencils))

    entries = ([("tdp_gathered", s) for s in _build.SITES]
               + [("tdp_windowed", s) for s in STENCIL_SITES]
               + [("lb_collision", "collide")])
    nsites = int(np.prod(GRID))
    rows = []
    for kernel, site in entries:
        spec = stencil.SPECS[site]
        seed = 200 + _build.SITE_ID[site]
        # the ragged lattice with ghost planes, every VVL
        if kernel == "lb_collision":
            n = nsites + 37
            xs = lb_bf16_inputs(spec, (n,), (0,), seed=seed, device=device)
            want = lb_collision.collision_site_kernel(
                *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
            ragged = {v: lb_bf16_hold(
                f"lb_collision.collide bf16 vvl={v} n={n}",
                lb_collision.lb_collision(*xs, vvl=v, **PHYS), want, problems)
                for v in CUDA_VVLS}
        else:
            shape, halo = ((LB_RAGGED, (2, 2, 2) if site == "fused"
                            else (1, 1, 1)) if spec.has_stencil
                           else ((nsites + 37,), (0,)))
            xs = lb_bf16_inputs(spec, shape, halo, seed=seed, device=device)
            prepared = prepare(spec, xs, shape, halo)
            want = tdp_pointwise.fields_plain(plan_of(kernel, site, shape,
                                                      halo), prepared)
            pbs = ((2, 8) if (kernel, site) == ("tdp_windowed", "fused")
                   else (None,))
            ragged = {f"{v}/{pb}": lb_bf16_hold(
                f"{kernel}.{site} bf16 vvl={v} plane_block={pb} "
                f"shape={shape} halo={halo}",
                execute(kernel, plan_of(kernel, site, shape, halo, v, pb),
                        prepared), want, problems)
                for v in CUDA_VVLS for pb in pbs}
            del prepared
        del xs, want
        # 128³ at VVL 1, timed
        shape = GRID if spec.has_stencil else (nsites,)
        xs = lb_bf16_inputs(spec, shape, (0,) * len(shape), seed=seed + 50,
                            device=device)
        prepared = prepare(spec, xs, shape, (0,) * len(shape))
        if kernel == "lb_collision":
            def kern():
                return lb_collision.lb_collision(*xs, **PHYS)

            def plain():
                return lb_collision.collision_site_kernel(
                    *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
            lib = None
        else:
            plan = plan_of(kernel, site, shape)

            def kern():
                return execute(kernel, plan, prepared)

            def plain():
                return tdp_pointwise.fields_plain(plan, prepared)
            lib = library_call(site, prepared, nsites)
        name = f"{kernel}.{site}.bf16"
        held = lb_bf16_hold(f"{name} 128^3", kern(), plain(), problems)
        lib_readings = library_ms = None
        if lib is not None:
            lib_out = lib[1](lib[0]())
            lib_readings = bf16_readings(lib_out[0], plain()[0])
            library_ms = time_ms(lib[0])
            del lib_out
        t_bytes = BYTES_PER_SITE[site] // 2 * nsites / PEAK_BYTES_PER_S * 1e3
        t_ops = FLOPS_PER_SITE[site] * nsites / PEAK_F32_PER_S * 1e3
        key = (kernel, site)
        row = {"name": name, "route": "cuda", **KERNELS[kernel],
               "dtype": "bfloat16",
               "launches": sum(launches(key).values()),
               "launches_by_path": launches(key),
               "max_abs_err": max([held["max_abs_err"]]
                                  + [r["max_abs_err"] for r in ragged.values()]),
               "ms": time_ms(kern),
               "plain_ms": time_ms(plain, reps=LB_BF16_PLAIN_REPS, warmup=1),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms,
               "library_vs_plain": lib_readings,
               "bit_equal": held["bit_equal"] and all(
                   r["bit_equal"] for r in ragged.values()),
               "checks": {"128cubed": held, "ragged": ragged},
               "ptxas": lb_bf16_ptxas(ptxas, kernel, site)}
        if (kernel, site) == ("tdp_windowed", "fused"):
            row["ms_by_plane_block"] = {pb: time_ms(lambda pb=pb: execute(
                kernel, plan_of(kernel, site, shape, pb=pb), prepared))
                for pb in (2, 8)}
        rows.append(row)
        log(f"phase 17: {name} ms={row['ms']:.4f} plain={row['plain_ms']:.4f}"
            f" library={library_ms} bound={row['bound_ms']:.4f} "
            f"bit_equal={row['bit_equal']} ptxas={row['ptxas']}")
        del xs, prepared, lib
        torch.cuda.empty_cache()

    # the example sites at (3, 128³), every VVL, and reduce
    g = torch.Generator(device=device).manual_seed(34)
    x, y = (torch.randn(TDP_NCOMP, nsites, device=device, generator=g).to(bf)
            for _ in range(2))
    ins = {"scale": [x], "saxpy": [x, y], "site_pos": [x]}
    a_bf = float(torch.tensor(LB_BF16_A).to(bf))
    libs = {"scale": lambda: torch.mul(x, a_bf),
            "saxpy": lambda: torch.add(y, x, alpha=a_bf), "site_pos": None}
    for site in ex.SPECS:
        spec = dataclasses.replace(ex.SPECS[site], out=TDP_NCOMP)
        c = {} if site == "site_pos" else {"a": LB_BF16_A}
        plans = {v: launch_plan(spec, Target("cuda", vvl=v), consts=c)
                 for v in CUDA_VVLS}
        xs = ins[site]

        def kern(p=plans[1], xs=xs):
            return tdp_pointwise.cuda_execute(p, xs)

        def plain(p=plans[1], xs=xs):
            return torch_executor(p, xs)

        want = plain()
        checks = {v: lb_bf16_hold(f"tdp_gathered.{site} bf16 vvl={v}",
                                  tdp_pointwise.cuda_execute(p, xs), want,
                                  problems) for v, p in plans.items()}
        lib = libs[site]
        key = ("tdp_gathered", site)
        b_ms = (4 + 2 * (len(xs) - 1)) * TDP_NCOMP * nsites \
            / PEAK_BYTES_PER_S * 1e3
        row = {"name": f"tdp_gathered.{site}.bf16", "route": "cuda",
               **KERNELS["tdp_gathered.example"], "dtype": "bfloat16",
               "launches": sum(launches(key).values()),
               "launches_by_path": launches(key),
               "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
               "ms": time_ms(kern, hold=SHORT_HOLD),
               "plain_ms": time_ms(plain, hold=SHORT_HOLD),
               "bound_ms": b_ms, "bound_by": "bytes",
               "library_ms": None if lib is None else time_ms(
                   lib, hold=SHORT_HOLD),
               "library_vs_plain": None if lib is None else bf16_readings(
                   lib(), want[0]),
               "bit_equal": all(r["bit_equal"] for r in checks.values()),
               "ms_by_vvl": {v: time_ms(
                   lambda p=p, xs=xs: tdp_pointwise.cuda_execute(p, xs),
                   hold=SHORT_HOLD) for v, p in plans.items()},
               "ptxas": lb_bf16_ptxas(ptxas, "tdp_gathered_example",
                                      site.replace("_", ""))}
        rows.append(row)
        log(f"phase 17: {row['name']} ms={row['ms']:.4f} plain="
            f"{row['plain_ms']:.4f} library={row['library_ms']} bound="
            f"{b_ms:.4f} by VVL {row['ms_by_vvl']} bit_equal={row['bit_equal']}")
        del want
    spec = dataclasses.replace(ex.SCALE_SPEC, out=TDP_NCOMP)

    def red(op, backend="cuda"):
        return reduce(spec, None, [x], consts={"a": 1.0}, op=op,
                      target=Target(backend))

    # the sum accumulates in double and rounds once to bfloat16: within one
    # bfloat16 step of the float64 sum of the plain map's values; max and
    # min exact
    sum64 = x.double().sum(-1)
    checks = {}
    for op in ("sum", "max", "min"):
        got, want = red(op), red(op, "torch")
        if op == "sum":
            step = torch.exp2(torch.floor(torch.log2(sum64.abs())) - 7)
            ok = got.dtype == bf and bool(
                ((got.double() - sum64).abs() <= step).all())
        else:
            ok = torch.equal(got, want)
        checks[op] = {"kernel": got.float().tolist(),
                      "plain_route": want.float().tolist(),
                      "float64_sum": sum64.tolist() if op == "sum" else None}
        if not ok:
            problems.append(f"phase 17: reduce({op}) bf16 of scale: {checks[op]}")
    key = ("tdp_gathered", "reduce")
    row = {"name": "tdp_gathered.reduce.bf16", "route": "cuda",
           **KERNELS["tdp_gathered.reduce"], "dtype": "bfloat16",
           "site": "scale", "op": "sum",
           "launches": sum(launches(key).values()),
           "launches_by_path": launches(key),
           "max_abs_err": float((red("sum").double() - sum64).abs().max()),
           "ms": time_ms(lambda: red("sum"), hold=SHORT_HOLD),
           "plain_ms": time_ms(lambda: red("sum", "torch"), hold=SHORT_HOLD),
           "bound_ms": 2 * TDP_NCOMP * nsites / PEAK_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": time_ms(lambda: x.sum(-1), hold=SHORT_HOLD),
           "checks": checks,
           "ptxas": lb_bf16_ptxas(ptxas, "tdp_gathered_example", "scale")}
    rows.append(row)
    log(f"phase 17: {row['name']} ms={row['ms']:.4f} plain={row['plain_ms']:.4f}"
        f" library={row['library_ms']:.4f} checks={checks}")
    del x, y
    torch.cuda.empty_cache()
    for row in rows:
        if not row["launches"]:
            problems.append(f"phase 17: {row['name']} was not launched in "
                            f"bfloat16 on the main path")
    return rows


def lb_bf16_phase(drive, by_path, problems, device="cuda", ptxas=()) -> dict:
    """Phase 17 (see the module docstring)."""
    t_phase = time.perf_counter()
    before = set(by_path)
    out = {}
    lb_bf16_paths(drive, problems, out, device)
    out["paths"] = [p for p in by_path if p not in before]
    out["rows"] = lb_bf16_rows(by_path, out["paths"], problems, ptxas, device)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: bfloat16 LB and examples {out['phase_s']:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("training", "dense", "moe", "ssd",
                                       "mla", "whisper", "bf16",
                                       "bf16_families", "aosoa_bf16",
                                       "lb_bf16"),
                    default=None,
                    help="run phases 1, 2 and this phase only (a partial "
                         "run: no kernels line)")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Lattice, Target, field_view
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch import configs
    from repro_torch.kernels import _build, calibrate, flash_attention
    from repro_torch.kernels import lb_collision, lm
    from repro_torch.kernels import ops, ref, tdp_pointwise, tdp_windowed
    from repro_torch.lb import programs, stencil
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim

    problems: list[str] = []
    record: dict = {}
    OUT_DIR.mkdir(exist_ok=True)

    # -- 1. device ----------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record["device"] = {"nvidia_smi": smi, "name": kind,
                        "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    logs = {name: p.with_name(f"{name}.log") for name, p in libs.items()}
    ptxas = ptxas_report(logs)
    record["build_s"] = build_s
    record["build_s_by_source"] = dict(_build.BUILD_SECONDS)
    record["ptxas"] = ptxas
    spills = [r for r in ptxas if r.get("spill_stores") or r.get("spill_loads")]
    print(json.dumps({"build_s": round(build_s, 3), "build_s_by_source": {
        k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()},
        "kernels_compiled": len(ptxas), "spilling": spills}), flush=True)

    counters = {"exchange": importlib.import_module(
                    "repro_torch.core.program").collectives,
                "tdp_gathered": tdp_pointwise.launches,
                "tdp_windowed": tdp_windowed.launches,
                "tdp_gathered_aosoa": tdp_pointwise.aosoa_launches,
                "tdp_windowed_aosoa": tdp_windowed.aosoa_launches,
                "tdp_gathered_ensemble": tdp_pointwise.ensemble_launches,
                "tdp_windowed_ensemble": tdp_windowed.ensemble_launches,
                "lb_collision": lb_collision.launches,
                "flash_attention": flash_attention.launches,
                "calibrate": calibrate.launches}
    lm_entries = [("tdp_gathered", s) for s in tdp_pointwise.LM_SITES] + [
        ("flash_attention", "flash_attention")]
    ex_entries = [("tdp_gathered", s)
                  for s in _build.EXAMPLE_SITES + ("reduce",)]
    cal_entries = [("calibrate", "add"), ("calibrate", "fma")]
    aosoa_entries = [("tdp_gathered_aosoa", s) for s in tdp_pointwise.launches
                     ] + [("tdp_windowed_aosoa", s) for s in STENCIL_SITES]
    ens_entries = [("tdp_gathered_ensemble", s) for s in _build.SITES] + [
        ("tdp_windowed_ensemble", s) for s in STENCIL_SITES]

    def entries():
        for site in _build.SITES:
            yield "tdp_gathered", site
        for site in STENCIL_SITES:
            yield "tdp_windowed", site
        yield "lb_collision", "collide"

    def make_inputs(spec, shape, halo=(0, 0, 0), *, seed):
        """Random fields about a physical state: f = 1/19 + 0.01·N gives
        ρ = 1 ± 0.044, so no site of a 128³ grid comes near ρ = 0, where
        u = j/ρ blows up and the comparison would hold nothing.  A stencil
        field spans the lattice and its ghost planes (random too), a
        pointwise one the interior."""
        r = np.random.default_rng(seed)
        n = int(np.prod(shape))
        n_ext = int(np.prod([s + 2 * h for s, h in zip(shape, halo)]))
        xs = []
        for fs in spec.fields:
            x = r.standard_normal((fs.ncomp, n if fs.stencil is None
                                   else n_ext), dtype=np.float32)
            if fs.name == "f":
                x = 1.0 / 19.0 + 0.01 * x
            else:
                x = 0.05 * x
            xs.append(torch.from_numpy(x).to(dev))
        return xs

    def lb_plan(kernel, site, shape, halo=None, vvl=1, plane_block=None):
        spec = stencil.SPECS[site]
        consts = programs.collision_consts(**PHYS) if spec.consts else {}
        tgt = Target("cuda_windowed" if kernel == "tdp_windowed" else "cuda",
                     vvl=vvl)
        if plane_block is not None:
            tgt = tgt.with_tuning(plane_block=plane_block)
        return launch_plan(spec, tgt, lattice=Lattice(shape)
                           if spec.has_stencil else None,
                           halo=halo if spec.has_stencil else None,
                           consts=consts)

    def prepare(spec, xs, shape, halo=(0, 0, 0)):
        """The executors' operands: each stencil field viewed over the
        lattice and its ghost planes (no copy), pointwise ones as given."""
        return tuple(x if s is None else field_view(x, shape, halo, s)
                     for x, s in zip(xs, spec.stencils))

    def execute(kernel, plan, prepared):
        if kernel == "tdp_windowed":
            return tdp_windowed.windowed_execute(plan, prepared)
        return tdp_pointwise.cuda_execute(plan, prepared)

    def lb_cases(kernel, site):
        """(shape, halo, plane_blocks) of phase 3's checks."""
        spec = stencil.SPECS[site]
        pbs = ((tdp_windowed.DEFAULT_PLANE_BLOCK, 8)
               if (kernel, site) == ("tdp_windowed", "fused") else (None,))
        if not spec.has_stencil:
            n = int(np.prod(GRID))
            return [((n,), (0,), pbs), ((n + 37,), (0,), pbs)]
        radius = [max(r) for r in zip(*(st.radius_per_dim()
                                        for st in spec.stencils
                                        if st is not None))]
        return ([(GRID, (0, 0, 0), pbs), (LB_RAGGED, (0, 0, 0), pbs)]
                + [(LB_RAGGED, h, pbs) for h in LB_HALOS
                   if all(hh == 0 or hh >= r for hh, r in zip(h, radius))])

    def ms_by_vvl(spec, xs, consts):
        """The gathered LM kernel's time at every VVL, on the same inputs
        (phase 3 held each VVL to the plain version)."""
        out = {}
        for vvl in (1, 2, 4, 8):
            p = launch_plan(spec, Target("cuda", vvl=vvl), consts=consts)
            out[vvl] = time_ms(lambda p=p: tdp_pointwise.cuda_execute(p, xs))
        return out

    by_path: dict = {}
    all_entries = list(entries()) + lm_entries + cal_entries + ex_entries

    def drive(path, fn):
        """Run one path of the main path with every launch counter set to
        0 just before and read just after."""
        for c in counters.values():
            for k in c:
                c[k] = 0
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = {(k, s): counters[k][s]
                         for k, s in all_entries + aosoa_entries + ens_entries
                         if counters[k][s]}
        return out

    if only is not None:
        if only in ("mla", "whisper"):
            # phase 5's rows at the model's shapes, before its weights; the
            # phase's launches merged after it
            launches = {e: 0 for e in lm_entries}
            launches_by_path = {e: {} for e in lm_entries}
            early_rows = (mla_rows if only == "mla" else whisper_rows)(
                launches, launches_by_path, {}, problems, record)
        phase = {"training": training_phase, "dense": dense_archs_phase,
                 "moe": moe_phase, "ssd": ssd_phase, "mla": mla_phase,
                 "whisper": whisper_phase,
                 "bf16": lambda *a: bf16_phase(*a, ptxas=ptxas),
                 "bf16_families": lambda *a: bf16_families_phase(
                     *a, ptxas=ptxas),
                 "aosoa_bf16": lambda *a: dict(zip(
                     ("rows", "bf16"), aosoa_bf16(*a))),
                 "lb_bf16": lambda *a: lb_bf16_phase(*a, ptxas=ptxas)}[only](
                         drive, by_path, problems)
        key = {"training": "training", "dense": "dense_archs",
               "moe": "moe", "ssd": "ssd", "mla": "mla",
               "whisper": "whisper", "bf16": "bf16",
               "bf16_families": "bf16_families",
               "aosoa_bf16": "aosoa", "lb_bf16": "lb_bf16"}[only]
        if only in ("mla", "whisper"):
            merge_launches(early_rows, by_path, phase["paths"])
            phase["rows"] = early_rows
        if only in ("moe", "ssd"):
            # phase 5's rows at the model's shapes, counting this phase's
            # paths
            launches = {e: sum(p.get(e, 0) for p in by_path.values())
                        for e in lm_entries}
            launches_by_path = {e: {path: p[e] for path, p in by_path.items()
                                    if e in p} for e in lm_entries}
            if only == "moe":
                phase["rows"] = dense_rows(
                    launches, launches_by_path, {}, problems, record,
                    rms_rows=MOE_RMS_ROWS, ew_rows=MOE_EW_ROWS,
                    attn_rows=MOE_ATTN_ROWS)
            else:
                phase["rows"] = ssd_rows(launches, launches_by_path, {},
                                         problems, record)
        print(json.dumps({key: phase}, default=str), flush=True)
        (OUT_DIR / f"chip_smoke_{only}.json").write_text(
            json.dumps(phase, indent=1, default=str))
        log(f"time_ms: {TIMED}")
        for p in problems:
            log(f"FAIL: {p}")
        if problems:
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- 3. kernels against plain versions ----------------------------------
    max_err: dict = {}
    for kernel, site in entries():
        spec = stencil.SPECS[site]
        err = 0.0
        if kernel == "lb_collision":
            for n in (int(np.prod(GRID)), int(np.prod(GRID)) + 37):
                xs = make_inputs(spec, (n,), (0,), seed=_build.SITE_ID[site])
                want = lb_collision.collision_site_kernel(
                    *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
                for vvl in (1, 2, 4, 8):
                    got = lb_collision.lb_collision(*xs, vvl=vvl, **PHYS)
                    torch.cuda.synchronize()
                    compare(site, got, want, f"{kernel}.{site} vvl={vvl} "
                            f"n={n}", problems)
                    err = max(err, max_abs(got, want))
        for shape, halo, pbs in ([] if kernel == "lb_collision"
                                 else lb_cases(kernel, site)):
            xs = make_inputs(spec, shape, halo, seed=_build.SITE_ID[site])
            prepared = prepare(spec, xs, shape, halo)
            want = tdp_pointwise.fields_plain(
                lb_plan(kernel, site, shape, halo), prepared)
            for vvl in (1, 2, 4, 8):
                for pb in pbs:
                    got = execute(kernel, lb_plan(kernel, site, shape, halo,
                                                  vvl, pb), prepared)
                    torch.cuda.synchronize()
                    compare(site, got, want, f"{kernel}.{site} vvl={vvl} "
                            f"plane_block={pb} shape={shape} halo={halo}",
                            problems)
                    err = max(err, max_abs(got, want))
            del xs, prepared, want
        max_err[(kernel, site)] = err
        log(f"phase 3: {kernel}.{site} max_abs_err={err}")
    torch.cuda.empty_cache()
    lm_checks(problems, max_err)
    calibrate_checks(problems, max_err)
    record["phase3_max_abs_err"] = {str(k): v for k, v in max_err.items()}

    # -- 4. main path at 128^3 -----------------------------------------------
    params = LBParams(**PARAMS)
    sims = {r: BinaryFluidSim(GRID, params, fused=r)
            for r in (False, "one_launch", "two_launch")}
    st0 = sims[False].init_spinodal(seed=0, noise=0.05)
    obs0 = sims[False].observables(st0)

    finals = {regime: drive(f"BinaryFluidSim fused={regime}",
                            lambda sim=sim: sim.run(st0, STEPS))
              for regime, sim in sims.items()}
    final = finals["two_launch"]
    f2, g2 = final.f.reshape(19, -1), final.g.reshape(19, -1)
    phi = g2.sum(0, keepdim=True)
    grad, lap = stencil.gradients(phi.reshape(GRID))
    fo, go = drive("ops.lb_collision", lambda: ops.lb_collision(
        f2, g2, phi, grad.reshape(3, -1), lap.reshape(1, -1),
        **params.as_kwargs()))
    fused_ops = {}
    for mode in ("one_launch", "two_launch"):
        for tgt in ("cuda_windowed", "cuda"):
            fused_ops[(mode, tgt)] = drive(
                f"ops.lb_fused_step {mode} {tgt}",
                lambda mode=mode, tgt=tgt: ops.lb_fused_step(
                    f2, g2, grid_shape=GRID, mode=mode, target=Target(tgt),
                    **params.as_kwargs()))
    for regime, st in finals.items():
        obs = sims[regime].observables(st)
        record.setdefault("observables", {})[str(regime)] = obs
        if obs["nan"]:
            problems.append(f"regime {regime}: NaN in the state")
        if not np.isclose(obs["mass"], obs0["mass"], rtol=1e-5, atol=0):
            problems.append(f"regime {regime}: mass {obs['mass']} vs "
                            f"{obs0['mass']}")
    names = list(finals)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            for fld in ("f", "g"):
                x, y = getattr(finals[a], fld), getattr(finals[b], fld)
                if not torch.allclose(x, y, rtol=2e-4, atol=2e-5):
                    problems.append(
                        f"{fld}: regimes {a} and {b} differ by "
                        f"{float((x - y).abs().max())}")
    for out in (fo, go, *[t for pair in fused_ops.values() for t in pair]):
        if not torch.isfinite(out).all():
            problems.append("non-finite output of an ops entry point")
    for mode in ("one_launch", "two_launch"):
        for i in range(2):
            a, b = fused_ops[(mode, "cuda_windowed")][i], fused_ops[(mode, "cuda")][i]
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                problems.append(f"lb_fused_step {mode}: windowed and gathered "
                                f"differ by {float((a - b).abs().max())}")
    # small input against the plain path on the CPU (held to the JAX
    # package by the CPU tests)
    small = {}
    for regime in (False, "one_launch", "two_launch"):
        outs = []
        for device in ("cuda", "cpu"):
            sim = BinaryFluidSim((16, 16, 16), params, fused=regime,
                                 device=device)
            st = sim.run(sim.init_spinodal(seed=3, noise=0.05), 10)
            outs.append((st.f.cpu(), st.g.cpu()))
        err = max(float((a - b).abs().max()) for a, b in zip(*outs))
        small[str(regime)] = err
        if not all(torch.allclose(a, b, rtol=2e-4, atol=2e-5)
                   for a, b in zip(*outs)):
            problems.append(f"16^3 regime {regime}: card vs CPU plain path "
                            f"differ by {err}")
    del fo, go, fused_ops, grad, lap, phi, final, f2, g2
    torch.cuda.empty_cache()
    record["tuning"] = tuning_path(drive, sims, st0, finals["one_launch"],
                                   params, problems)
    print(json.dumps({"tuning": record["tuning"]}, default=str), flush=True)
    torch.cuda.empty_cache()
    t_tdp = time.perf_counter()
    record["tdp_surface"] = tdp_surface(drive, problems)
    record["tdp_surface"]["phase_s"] = time.perf_counter() - t_tdp
    print(json.dumps({"tdp_surface": record["tdp_surface"]}, default=str),
          flush=True)

    # gemma2-2b, then falcon-mamba-7b, served at full width
    cfg = configs.get_config("gemma2-2b")
    record["serving"] = {"gemma2-2b": serve_model(cfg, SERVE_PROMPT, drive,
                                                  problems)}
    h = torch.randn(SERVE_BATCH * SERVE_PROMPT, cfg.d_ff, device=dev)
    act_out = drive("ops.gated_act ungated gelu",
                    lambda: ops.gated_act(h, None, kind="gelu"))
    if not torch.allclose(act_out, ref.gated_act_ref(h, kind="gelu"), **LM_TOL):
        problems.append("ops.gated_act ungated: kernel and plain disagree")
    del h, act_out
    torch.cuda.empty_cache()
    mcfg = configs.get_config("falcon-mamba-7b")
    record["serving"]["falcon-mamba-7b"] = serve_model(
        mcfg, MAMBA_PROMPT, drive, problems)
    g_layers, m_layers = cfg.n_layers, mcfg.n_layers
    decode = f"decode x{SERVE_DECODE}"
    expected = {
        f"{cfg.name} prefill (cuda)": {
            ("flash_attention", "flash_attention"): g_layers,
            ("tdp_gathered", "rmsnorm"): 2 * g_layers + 1,
            ("tdp_gathered", "gated"): g_layers},
        f"{cfg.name} {decode} (cuda)": {
            ("tdp_gathered", "rmsnorm"): (2 * g_layers + 1) * SERVE_DECODE,
            ("tdp_gathered", "gated"): g_layers * SERVE_DECODE},
        f"{mcfg.name} prefill (cuda)": {
            ("tdp_gathered", "mamba"): m_layers,
            ("tdp_gathered", "rmsnorm"): m_layers + 1},
        f"{mcfg.name} {decode} (cuda)": {
            ("tdp_gathered", "rmsnorm"): (m_layers + 1) * SERVE_DECODE},
        # calibrate(reps=5): one warm-up and five timed launches of each
        "costmodel.calibrate": {("calibrate", "add"): 6,
                                ("calibrate", "fma"): 6}}
    for name in (cfg.name, mcfg.name):
        expected[f"{name} prefill (torch)"] = {}
        expected[f"{name} {decode} (torch)"] = {}
    expected["autotune lb_fused_one 128^3 (cache)"] = {}
    nv = 4   # the sequence launches each example site function at VVL 1-8
    expected["tdp surface: III-C sequence"] = {
        ("tdp_gathered", s): nv for s in _build.EXAMPLE_SITES}
    # sum, max and min: one launch of the one-pass reduce each
    expected["tdp surface: reduce"] = {("tdp_gathered", "reduce"): 3}
    expected["tdp surface: launch_stencil"] = {("tdp_gathered", "stream"): 1,
                                               ("tdp_gathered", "grad6"): 1}
    expected["tdp surface: Fig. 1 SoA kernels"] = {
        ("tdp_gathered", "collide"): 1, ("tdp_gathered", "stream"): 1}
    for regime, kernel in (("cuda", "tdp_gathered"),
                           ("one_launch", "tdp_windowed"),
                           ("two_launch", "tdp_windowed")):
        counts = by_path.get(f"tdp surface: lb_spinodal {regime}", {})
        if kernel not in {k for k, _ in counts}:
            problems.append(f"lb_spinodal {regime}: launches {counts}")
    # the tuned run launches the default run's kernels, at its own VVL, or
    # their AoSoA twins if the tuner chose that layout
    expected["BinaryFluidSim one_launch tuned"] = {
        (k + ("_aosoa" if record["tuning"]["lb_fused_one"]["layout"]
              == "aosoa" else ""), s): n
        for (k, s), n in by_path.get("BinaryFluidSim fused=one_launch",
                                     {}).items()}
    for path, counts in expected.items():
        if by_path.get(path) != counts:
            problems.append(f"{path}: launches {by_path.get(path)}, "
                            f"expected {counts}")

    launches = {e: sum(p.get(e, 0) for p in by_path.values())
                for e in all_entries}
    launches_by_path = {e: {path: p[e] for path, p in by_path.items() if e in p}
                        for e in all_entries}
    for (k, s), n in launches.items():
        if n == 0:
            problems.append(f"{k}.{s} was not launched on the main path")
    per_path = {path: {f"{k}.{s}": n for (k, s), n in p.items()}
                for path, p in by_path.items()}
    record["main_path"] = {"launches_by_path": per_path,
                           "card_vs_cpu_16cubed_max_abs": small}
    print(json.dumps({"main_path_launches_by_path": per_path}), flush=True)

    # -- 5. times at 128^3 -----------------------------------------------------
    # Each kernel is also held to its plain version once more here, at the
    # main path's size and VVL.
    nsites = int(np.prod(GRID))
    rows = []
    for kernel, site in entries():
        spec = stencil.SPECS[site]
        shape = GRID if spec.has_stencil else (nsites,)
        xs = make_inputs(spec, shape, (0,) * len(shape),
                         seed=100 + _build.SITE_ID[site])
        prepared = prepare(spec, xs, shape, (0,) * len(shape))
        if kernel == "lb_collision":
            def kern():
                return lb_collision.lb_collision(*xs, **PHYS)

            def plain():
                return lb_collision.collision_site_kernel(
                    *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
        else:
            plan = lb_plan(kernel, site, shape)

            def kern():
                return execute(kernel, plan, prepared)

            def plain():
                return tdp_pointwise.fields_plain(plan, prepared)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        compare(site, got, want, f"{kernel}.{site} 128^3", problems)
        err128 = max_abs(got, want)
        max_err[(kernel, site)] = max(max_err[(kernel, site)], err128)
        lib = (None if kernel == "lb_collision"
               else library_call(site, prepared, nsites))
        library_ms = lib_err = None
        if lib is not None:
            call, split = lib
            lib_out = split(call())
            torch.cuda.synchronize()
            # the library is held to the plain version at the non-copy
            # tolerance whatever the site: it need not round as the port
            compare("library", lib_out, want,
                    f"library call for {kernel}.{site} 128^3", problems)
            lib_err = max_abs(lib_out, want)
            del lib_out
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        if lib is not None:
            library_ms = time_ms(lib[0])
        name = f"{kernel}.{site}"
        if (kernel, site) == ("tdp_windowed", "fused"):
            record["fused_ms_by_plane_block"] = {
                pb: time_ms(lambda pb=pb: execute(kernel, lb_plan(
                    kernel, site, shape, plane_block=pb), prepared))
                for pb in PLANE_BLOCKS}
            log(f"phase 5: {name} ms by plane_block "
                f"{record['fused_ms_by_plane_block']}")
        record.setdefault("earlier_ms", {})[name] = EARLIER_MS.get(name)
        b_ms, b_by = bound(site, nsites)
        rows.append({"name": name, "route": "cuda",
                     **KERNELS[kernel], "launches": launches[(kernel, site)],
                     "launches_by_path": launches_by_path[(kernel, site)],
                     "max_abs_err": max_err[(kernel, site)], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        record.setdefault("checks_128cubed", {})[name] = {
            "max_abs_err": err128, "library_max_abs_err": lib_err}
        log(f"phase 5: {name} ms={ms:.4f} (before the redesign "
            f"{EARLIER_MS.get(name)}) plain={plain_ms:.4f} "
            f"library={library_ms} bound={b_ms:.4f} err128={err128} "
            f"library_err={lib_err}")
        del xs, lib
        prepared = None
        torch.cuda.empty_cache()

    # LM kernels at the full-width shapes of the serving path: rmsnorm at
    # both models' prefill and decode shapes (one row each), gated and act
    # over gemma2's MLP activations
    g = torch.Generator(device=dev).manual_seed(12)
    ntok, d, nff = SERVE_BATCH * SERVE_PROMPT, cfg.d_model, cfg.d_ff

    def rms_case(suffix, d, ntok):
        name = "tdp_gathered.rmsnorm" + suffix
        return (name, "tdp_gathered.rmsnorm", lm.rmsnorm_spec(d),
                [torch.randn(d, ntok, device=dev, generator=g)],
                {"weight": torch.randn(d, device=dev, generator=g),
                 "eps": 1e-6, "scale_offset": 1.0},
                8 * d * ntok + 4 * d, 5 * d * ntok)

    md = mcfg.d_model
    for name, kernel, spec, xs, consts, nbytes, flops in (
            rms_case("", d, ntok),
            rms_case(".decode_d2304", d, SERVE_BATCH),
            rms_case(".decode_d4096", md, SERVE_BATCH),
            rms_case(".prefill_d4096", md, SERVE_BATCH * MAMBA_PROMPT),
            ("tdp_gathered.gated", "tdp_gathered.gated",
             lm.gated_act_spec("geglu", True),
             [3.0 * torch.randn(1, ntok * nff, device=dev, generator=g),
              torch.randn(1, ntok * nff, device=dev, generator=g)], {},
             12 * ntok * nff, 10 * ntok * nff),
            ("tdp_gathered.act", "tdp_gathered.act",
             lm.gated_act_spec("gelu", False),
             [3.0 * torch.randn(1, ntok * nff, device=dev, generator=g)], {},
             8 * ntok * nff, 9 * ntok * nff)):
        plan = launch_plan(spec, Target("cuda", vvl=1), consts=consts)
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_PER_S * 1e3
        rows.append(lm_row(
            name, KERNELS[kernel], ("tdp_gathered", kernel.split(".")[1]),
            lambda plan=plan, xs=xs: tdp_pointwise.cuda_execute(plan, xs),
            lambda plan=plan, xs=xs: torch_executor(plan, xs),
            lm_library_call(name, xs, consts),
            (t_b, "bytes") if t_b >= t_o else (t_o, "operations"),
            launches, launches_by_path, max_err, problems, record,
            max_err_key=kernel))
        rows[-1]["shape"] = list(xs[0].shape)
        rows[-1]["ms_by_vvl"] = ms_by_vvl(spec, xs, consts)
        log(f"phase 5: {name} ms by VVL {rows[-1]['ms_by_vvl']}")
        del xs
        torch.cuda.empty_cache()
    a = cfg.attn
    q = torch.randn(SERVE_BATCH, a.n_heads, SERVE_PROMPT, a.head_dim,
                    device=dev, generator=g)
    k, v = (torch.randn(SERVE_BATCH, a.n_kv_heads, SERVE_PROMPT, a.head_dim,
                        device=dev, generator=g) for _ in range(2))
    import torch.nn.functional as F
    for variant, window, softcap in (("local", a.window, a.softcap),
                                     ("attn", 0, a.softcap), ("causal", 0, 0.0)):
        kw = dict(causal=True, window=window, softcap=softcap)
        lib = None
        if variant == "causal":
            lib = ((lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)), (lambda o: (o,)))
        shape = (SERVE_BATCH, a.n_heads, a.n_kv_heads, SERVE_PROMPT,
                 SERVE_PROMPT, a.head_dim, True, window)
        name = f"flash_attention.{variant}"
        # bound_ms: the kernel's own work, TF32_SPLIT products on the tensor
        # cores; the float32 CUDA-core bound beside it, in the record
        rows.append(lm_row(
            name, KERNELS["flash_attention"],
            ("flash_attention", "flash_attention"),
            lambda kw=kw: flash_attention.flash_attention(q, k, v, **kw),
            lambda kw=kw: ref.attention_ref(q, k, v, **kw), lib,
            attn_bound(*shape, split=flash_attention.TF32_SPLIT),
            launches, launches_by_path, max_err, problems, record,
            max_err_key="flash_attention"))
        record.setdefault("earlier_ms", {})[name] = EARLIER_LM_MS[name]
        record.setdefault("bound_fp32_ms", {})[name] = attn_bound(*shape)[0]
        log(f"phase 5: {name} (before the redesign {EARLIER_LM_MS[name]}) "
            f"bound on the CUDA cores in float32 "
            f"{record['bound_fp32_ms'][name]:.4f} ms")
        torch.cuda.empty_cache()
    del q, k, v
    rows += dense_rows(launches, launches_by_path, max_err, problems, record)
    rows += dense_rows(launches, launches_by_path, max_err, problems, record,
                       rms_rows=MOE_RMS_ROWS, ew_rows=MOE_EW_ROWS,
                       attn_rows=MOE_ATTN_ROWS)
    rows += ssd_rows(launches, launches_by_path, max_err, problems, record)
    rows += mla_rows(launches, launches_by_path, max_err, problems, record)
    rows += whisper_rows(launches, launches_by_path, max_err, problems,
                         record)

    # the mamba site function at falcon-mamba-7b's full-width prefill shape:
    # one launch = one layer, both batch rows
    length, nstate = MAMBA_PROMPT, mcfg.ssm.d_state
    n = mcfg.ssm.expand * mcfg.d_model
    rows_ = SERVE_BATCH * length
    xs = [torch.randn(rows_, n, device=dev, generator=g),
          torch.nn.functional.softplus(torch.randn(rows_, n, device=dev,
                                                   generator=g)),
          -torch.exp(torch.randn(nstate, n, device=dev, generator=g)),
          torch.ones(1, n, device=dev)]
    consts = {"b": torch.randn(rows_, nstate, device=dev, generator=g),
              "c": torch.randn(rows_, nstate, device=dev, generator=g)}
    spec = lm.mamba_scan_spec(length, nstate, SERVE_BATCH)
    plan = launch_plan(spec, Target("cuda", vvl=1), consts=consts)
    # x, dt read and y written per (step, channel); a, d read once; b, c
    # read and h written once per row.  L·n·N exponentials a row on the
    # SFUs, 6 float32 operations per (step, channel, state) and 3 per (step,
    # channel) on the CUDA cores.
    nbytes = 4 * (3 * rows_ * n + nstate * n + n
                  + SERVE_BATCH * (nstate * n + 2 * length * nstate))
    bounds = [(nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
              (rows_ * n * nstate / PEAK_SFU_PER_S * 1e3, "operations"),
              ((6 * nstate + 3) * rows_ * n / PEAK_F32_PER_S * 1e3,
               "operations")]
    rows.append(lm_row(
        "tdp_gathered.mamba", KERNELS["tdp_gathered.mamba"],
        ("tdp_gathered", "mamba"),
        lambda: tdp_pointwise.cuda_execute(plan, xs),
        lambda: torch_executor(plan, xs), None, max(bounds),
        launches, launches_by_path, max_err, problems, record,
        plain_reps=MAMBA_PLAIN_REPS, plain_wall=True))
    rows[-1]["shape"] = [SERVE_BATCH, length, n, nstate]
    record.setdefault("earlier_ms", {})["tdp_gathered.mamba"] = \
        EARLIER_LM_MS["tdp_gathered.mamba"]
    rows[-1]["ms_by_vvl"] = ms_by_vvl(spec, xs, consts)
    log(f"phase 5: tdp_gathered.mamba (before the redesign "
        f"{EARLIER_LM_MS['tdp_gathered.mamba']}) ms by VVL "
        f"{rows[-1]['ms_by_vvl']}")
    del xs, consts, plan
    torch.cuda.empty_cache()
    rows += calibrate_rows(launches, launches_by_path, max_err, problems)
    t_tdp = time.perf_counter()
    rows += tdp_rows(launches, launches_by_path, max_err, problems)
    record.setdefault("earlier_ms", {}).update(EARLIER_EXAMPLE_MS)
    record["tdp_surface"]["rows_s"] = time.perf_counter() - t_tdp

    # -- 6. the AoSoA layout ---------------------------------------------------
    aosoa_rows, record["aosoa"] = aosoa_phase(
        drive, by_path, make_inputs, prepare, finals, st0, rows, params,
        problems)
    rows += aosoa_rows

    # -- 7. the domain decompositions ------------------------------------------
    record["decompositions"] = decomposition_phase(
        drive, by_path, sims, finals, st0, params, problems)
    del finals
    torch.cuda.empty_cache()
    print(json.dumps({"aosoa": {k: record["aosoa"][k] for k in (
        "phase_s", "mlups_128cubed_20_steps", "max_abs_vs_soa",
        "max_abs_vs_soa_128cubed")}}, default=str), flush=True)

    mlups = {}
    for regime, sim in sims.items():
        sim.run(st0, 2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.run(st0, STEPS)
        torch.cuda.synchronize()
        mlups[str(regime)] = nsites * STEPS / (time.perf_counter() - t) / 1e6
    record["mlups_128cubed_20_steps"] = mlups
    print(json.dumps({"mlups_128cubed_20_steps": mlups}), flush=True)
    # no later phase runs the 128³ LB state: its memory goes back to the
    # LM phases (deepseek's serving peaks near the card's size)
    del sims, st0
    torch.cuda.empty_cache()

    # -- 8. fleets -------------------------------------------------------------
    fleet_rows, record["fleet"] = fleet_phase(
        drive, by_path, make_inputs, prepare, lb_plan, lb_cases, params,
        mlups, problems)
    rows += fleet_rows
    print(json.dumps({"fleet": {k: record["fleet"][k] for k in (
        "phase_s", "bits", "throughput", "driver")}}, default=str),
        flush=True)

    # -- 9. training -------------------------------------------------------------
    record["training"] = training_phase(drive, by_path, problems)
    merge_training_launches(rows, by_path, record["training"])
    tr = record["training"]
    print(json.dumps({"training": {
        "phase_s": tr["phase_s"], "gemma2-2b": {k: v for k, v in tr[
            "gemma2-2b"].items() if k != "profile"},
        "gemma2-2b_profile": {k: tr["gemma2-2b"]["profile"][k] for k in (
            "device_ms", "device_ms_by_part", "plain_backward_ms",
            "plain_backward_share")},
        "resume": tr["resume"], "falcon-mamba-7b": tr["falcon-mamba-7b"]}},
        default=str), flush=True)

    # -- 10. the dense archs -------------------------------------------------------
    record["dense_archs"] = dense_archs_phase(drive, by_path, problems)
    merge_launches(rows, by_path, record["dense_archs"]["paths"])
    print(json.dumps({"dense_archs": record["dense_archs"]}, default=str),
          flush=True)

    # -- 11. Mixture-of-Experts: granite-moe-1b-a400m whole ----------------------
    record["moe"] = moe_phase(drive, by_path, problems)
    merge_launches(rows, by_path, record["moe"]["paths"])
    print(json.dumps({"moe": record["moe"]}, default=str), flush=True)

    # -- 12. Mamba-2 SSD and the tied block: zamba2-2.7b whole --------------------
    record["ssd"] = ssd_phase(drive, by_path, problems)
    merge_launches(rows, by_path, record["ssd"]["paths"])
    print(json.dumps({"ssd": record["ssd"]}, default=str), flush=True)

    # -- 13. MLA and MTP: deepseek-v3-671b at full width ------------------------
    record["mla"] = mla_phase(drive, by_path, problems)
    merge_launches(rows, by_path, record["mla"]["paths"])
    print(json.dumps({"mla": record["mla"]}, default=str), flush=True)

    # -- 14. the encoder and cross-attention: whisper-medium whole ------------
    record["whisper"] = whisper_phase(drive, by_path, problems)
    merge_launches(rows, by_path, record["whisper"]["paths"])
    print(json.dumps({"whisper": record["whisper"]}, default=str), flush=True)

    # -- 15. bfloat16 parameters and caches --------------------------------------
    record["bf16"] = bf16_phase(drive, by_path, problems, ptxas=ptxas)
    rows += record["bf16"]["rows"]
    print(json.dumps({"bf16": record["bf16"]}, default=str), flush=True)

    # -- 16. bfloat16 for the Mamba, MoE, MLA and whisper families ----------
    record["bf16_families"] = bf16_families_phase(drive, by_path, problems,
                                                  ptxas=ptxas)
    rows += record["bf16_families"]["rows"]
    print(json.dumps({"bf16_families": record["bf16_families"]},
                     default=str), flush=True)

    # -- 17. bfloat16 in the LB and example kernels --------------------------
    record["lb_bf16"] = lb_bf16_phase(drive, by_path, problems, ptxas=ptxas)
    rows += record["lb_bf16"]["rows"]
    print(json.dumps({"lb_bf16": record["lb_bf16"]}, default=str), flush=True)
    record["kernels"] = rows
    record["time_ms_loops"] = TIMED
    log(f"time_ms: {TIMED}")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                        default=str))

    if problems:
        for p in problems:
            log(f"FAIL: {p}")
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
