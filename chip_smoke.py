"""Drive the PyTorch/CUDA port of FT-CAQR on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. report and build: the card's name and power limit; every CUDA kernel
   built from ``src/repro_torch/csrc`` (one nvcc per source, in parallel;
   the build's seconds and each source's),
   while this process runs the CPU's work meanwhile: the dry run (26) and
   the adafactor phase's CPU step (25).
2. kernels: K1-K6 at the sweep's first-panel shapes against their plain
   PyTorch versions, timed with CUDA events beside the plain version and
   one PyTorch call computing the same function (K1-K4) or the stepped
   kernels doing the same work (K5: K1+K2; K6: the stepped panel); the
   check that one lane of a P-lane launch equals a launch of it alone
   (K1-K5), and that K3 gives the two lanes of a butterfly pair, which
   stack the same two R factors, equal bits; every kernel's device time
   (torch.profiler); K3's and K6's shared memory a block, and K6's blocks
   per SM; K2 and K4 also at a late panel (w = 512) and on one lane (the
   REBUILD replay), bit-equal at two column tiles, and K1 on one lane (the
   REBUILD replay) and at the last panel's row start (rs = 3968) beside
   ``torch.geqrf`` on the same rows, all timed on the device alone
   (torch.profiler) beside the events' time, which for a short kernel
   includes the host's time to issue it; each kernel's registers and
   spills from its build log; one JSON line per kernel, and one with K1's
   team (its size, shared memory, and how many teams the card holds at
   once, from cudaOccupancyMaxActiveClusters).
3. sweep: the windowed FT-CAQR sweep of a 32768 x 4096 f32 matrix over
   P = 8 lanes at panel width 128 (32 panels, 3 butterfly levels), with
   the launch counters at 0 before it; checks that K1-K4 ran, that R is
   replicated bitwise, the Gram identity, Q^T A = [R; 0] and a
   least-squares solve. Then device time by kernel over one more sweep,
   from torch.profiler.
4. fused leaf: ``householder.panel_qr_apply`` (K5) on the first panel's
   window, counters at 0 before it, bit-equal to the stepped leaf.
5. state machine + fused: the same matrix through ``run_steps`` and,
   separately, ``run_panel_fused`` over all 32 panels (K6, counters at 0
   before it; no K1-K4 launch inside), each with ``finalize``: seconds,
   launches, peak memory; both bit-equal to the sweep's R, factors and
   bundles, and to each other at every panel boundary.
6. FT driver: ``ft_caqr_sweep`` on the same matrix with four kills (an
   early leaf point, a tsqr point and a trailing point of the panel's
   root lane mid-sweep, the last panel's last trailing point), R, factors
   and bundles bit-equal to the failure-free sweep, one single-source
   event per kill, each REBUILD's seconds; and with the same lanes killed
   at the ends of those panels (the fused path's boundaries).
7. online: ``ft_caqr_sweep_online`` on the same matrix, stepped and fused
   without a death, stepped with the four kills (a ``ScriptedKiller``,
   found by the NaN sentinel), fused with the panel-end kills, and
   stepped with double-buffered segments: R, factors and bundles
   bit-equal to the failure-free (and so to the scheduled) sweep, the
   event ledgers equal to the scheduled runs'; seconds, segments,
   boundaries, poll and recovery seconds, peak memory and launches. Then
   fused under ``MDSScheme(f=2)`` with two simultaneous non-buddy deaths
   at one boundary, decoded jointly and bit-equal to failure-free, with
   the refresh seconds per boundary and the parity's bytes.
8. spmd: one process per lane. Eight ranks spawned once
   (``repro_torch.launch.spmd_qr.make_lane_group``, start method spawn)
   in a gloo group, all on the one card, after the kernels are built here
   (the ranks load the built libraries and start no nvcc); every
   collective goes through pinned host buffers. On the tall matrix:
   ``caqr_factorize_spmd`` at b = 128 (R bit-equal to the sweep phase's,
   the Gram identity), ``caqr_lstsq`` over ``AxisComm`` (within 1e-3 of
   float64), ``ft_caqr_sweep_spmd`` with the FT driver's four kills (R,
   factors and bundles bit-equal to the failure-free sweep, the ledger
   equal to that phase's), the ``MDSScheme(f=2)`` parity after panel 0
   (bytes equal to the single-process encode, and the seconds of one
   refresh across the ranks), and ``caqr_factorize_spmd`` at b = 256
   (R bit-equal to the single-process b = 256 sweep: each rank's K1 is
   the one cooperative launch of ``csrc/panel_qr_wide.cu``). The
   ``MDSScheme(f=2)`` run with two simultaneous non-buddy deaths at one
   point runs on a 4096 x 512 matrix (``SPMD_MDS``), not on the tall one:
   bit-equal to failure-free, the ledger and the parity bytes equal to a
   single-process run's. The scheduled tall joint decode across ranks is
   not run: the scheduled driver re-encodes every protected leaf at each
   of its points across the ranks (the online run below decodes the tall
   matrix instead, encoding on the parent). Prints each run's seconds and
   each rank's K1-K6 launches (K1-K4 must be above 0 on every rank),
   seconds, collectives
   and the bytes it staged between the card and host memory and sent
   through gloo. Then the online and elastic paths over the same ranks
   (``ft_caqr_sweep_online_spmd``, ``ft_caqr_sweep_elastic_spmd``: the
   host orchestrator here holds the global state, each rank runs one
   ``sweep_step`` a point and gets only the leaves that changed): failure-
   free and with the four kills (bit-equal to the failure-free sweep, the
   scheduled ledger); ``MDSScheme(f=2)`` on the tall matrix with two
   simultaneous non-buddy deaths, a panel a segment (one refresh a panel
   on the parent's global state), bit-equal to failure-free and to the
   single-process online run with the same hooks and segments, a joint
   decode; SHRINK with one kill, fold 8 -> 4 onto a subgroup of the first
   four ranks (R bit-equal to the single-process online SHRINK under the
   fold policy, its transitions and ledger, and within the f32 tolerance
   of the failure-free R up to row signs). Each records its seconds,
   segments, boundaries, points, the parent's seconds a point outside the
   ranks, the runner's leaves and bytes shipped and joined, and each
   rank's report. Once the group is closed, no rank process may be left;
   three single-process sweeps (``SPMD_RESIDUE``) are timed
   SPREAD_RUNS times each just before the ranks are spawned and again
   after, so the record shows whether the phase left the single process
   slower.
9. shrink: SHRINK after one death, scheduled (stepped) and online (fused):
   R bit-equal between the two, the Gram identity, the new world (8 slots,
   7 live, the adopter's slice doubled to 8192 rows), and K1 and K6 at
   that height against their plain versions.
10. recovery: the FT trailing update of one panel with lane 3 killed after
   level 1 and rebuilt from one buddy, bitwise equal to the clean run.
11. square: a 4096 x 4096 sweep (m_loc = 512, so the tree root walks lanes
   0-7 and lanes are consumed): fused == stepped at every panel boundary,
   both equal to ``caqr_factorize``, and a kill of a root lane recovered
   bitwise.
12. ragged: an unaligned 32000 x 4000 sweep checked by the Gram identity,
   and fused == stepped at every panel boundary.
13. serve: the QR service (``repro_torch.serve.QRService``) at P = 8,
   b = 128, buckets (m_loc, n) = (1024, 1024) and (4096, 2048), 8 slots:
   24 ragged requests from ``--seed`` (half drawn for each bucket, m in
   [b, P m_loc], n in [b, n - 2], a quarter of the tall ones least
   squares with 2 rhs columns), one submitted a tick. Three runs of that
   traffic: failure-free, lane 2 killed at tick 2 (healed mid-batch by
   the single-source REBUILD), and ``drain_batched`` in groups of four
   requests. Checks: every R meets the Gram identity against its own A,
   every lstsq x is within 1e-3 of the float64 solution (on the card),
   kill == failure-free and drain_batched == continuous bit for bit, every
   tenant resident at the kill healed by one single-source event, K1-K4
   launched on each run, and K1-K4 at each bucket's shapes against their
   plain versions (on a served tenant zero-padded into the bucket and on
   random data: K1 at row start 0 and at the last panel's, on 8 lanes and
   one; K2 at the first, a middle and the last window and on one lane; K3;
   K4 at the first and the last window). Prints requests per second, p50
   and p99 latency, ticks and the median tick, heal seconds per tenant,
   peak memory, and, over a second failure-free drain under torch.profiler
   and against that drain's own wall time, the card's compute share (K1-K4
   and the other kernels) apart from its copy share (Memcpy and Memset).
14. train: the FT training runtime (``repro_torch.train.ftrun``) at
   TinyLlama-1.1B's published width (d_model 2048, 32 heads, 4 kv heads,
   head_dim 64, d_ff 5632, vocab 32000, swiglu, bf16 params), cut to 2
   layers, sequence 1024, global batch 8 over 4 data lanes, 4 steps
   (``TRAIN_REDUCED``), random weights from ``--seed``: ``caqr_muon``
   through ``FTTrainer`` with ``FTRunConfig(qr_lanes=4, panel_width=128)``,
   so 14 full-width online FT-CAQR sweeps a step on K1-K4, under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
   set before CUDA starts). Runs: failure-free; lane 1 killed at a
   mid-sweep point of step 2's first ``w_in`` sweep (bit-equal params and
   losses, one single-source REBUILD event, no rewind; with the runs
   below, each bit-equal to the failure-free run, also the determinism
   check, which a second failure-free run would only repeat); async double-buffered segments with the same
   kill; suspended to disk inside step 2 and resumed with
   ``FTTrainer.resume``; a training-level lane death at step 3 (diskless
   restore, replay); the PowerSGD bridge (``adamw``, rank 4) for 2 steps,
   failure-free and with a kill in its first sweep; the plain
   ``Trainer(adamw)``. Every run bit-equal to its failure-free run. Checks
   besides: finite losses that fall, every sweep's R of the failure-free
   run against the Gram identity of its momentum slice, K1-K4 launched and
   K5/K6 not on the ``train``, ``train_kill`` and ``train_psgd`` paths, and
   K1-K4 at the path's shapes (``TRAIN_SHAPES``) against their plain
   versions on 4 lanes and one. Prints each run's step seconds, the split
   into grad phase, task loop (engine seconds, polls, sweeps, boundaries,
   segments) and finish phase, heal seconds and peak memory, and device
   time by kernel over one more step under torch.profiler.
15. train_moe: the FT training runtime on mixtral-8x22b at its published
   width (d_model 6144, 48 heads, 8 kv heads, head_dim 128, 8 experts top-2,
   d_ff_expert 16384, vocab 32768, window 4096, rope theta 1e6, bf16
   params), cut to 1 layer, sequence 1024, global batch 8 over 4 data
   lanes, 3 steps (``MOE_REDUCED``), random weights from ``--seed``:
   ``caqr_muon`` through ``FTTrainer`` with ``FTRunConfig(qr_lanes=4,
   panel_width=128)``, so 29 full-width online FT-CAQR sweeps a step on
   K1-K4 (24 expert slices of 16384 x 6144, wq and wo 6144 x 6144, wk and
   wv 6144 x 1024, the router 6144 x 8), under torch's deterministic mode.
   Runs: failure-free; lane 1 killed at a mid-sweep point of step 2
   inside the fourth w_gate expert's sweep (params bit-equal, optimizer
   states with equal digests, equal losses, one single-source REBUILD
   event, no rewind: also the determinism check, which a second
   failure-free run would only repeat). Checks: finite losses, every
   sweep's R of the first run against the Gram identity of its momentum
   slice, K1-K4 launched and K5/K6 not on the ``train_moe`` and
   ``train_moe_kill`` paths, and K1-K4 at the path's shapes
   (``MOE_SHAPES``) against their plain versions on 4 lanes and one (on
   random data and on a momentum slice; the router's has rank 7, since
   softmax's logit gradients sum to zero over the experts, so there K1's
   and K3's outputs are held where the first 7 reflectors fix them). Prints
   each run's step seconds and their split, the engine's sweeps,
   boundaries, poll and heal seconds, peak memory, the share of token
   assignments dropped at capacity, and the column norms of the router
   sweep's Q.
16. lm_serve: the LLM token engine (``repro_torch.serve.Engine``, prefill
   then cached decode, no QR) on gemma2-2b at its published width and
   depth (26 layers alternating local and global attention, d_model 2304,
   8 heads, 4 kv heads, head_dim 256, d_ff 9216, vocab 256000, window
   4096, softcaps 50 and 30, tied embeddings), random weights from
   ``--seed``, under torch's deterministic mode. (a) bf16, 4 prompts of
   4160 tokens (past the window), 32 greedy tokens, counters at 0 before
   it: every local layer's decode cache holds 4096 slots and every global
   layer's 4192, every logit finite, every token in the vocabulary, a
   second ``generate`` bit-equal to the first, K1-K6 not launched; prints
   the prefill's seconds, decode ms a token (median and p90, each step
   between two synchronises), tokens per second (a second run without
   those synchronises), peak memory and a decode step's bound (the weights
   and caches read once at 3.35 TB/s); then one prefill and three decode
   steps under torch.profiler: wall and device ms, the card's busy share,
   kernels a call and the five costliest. (b) f32 at the same widths and
   depth, 2 prompts of 4160 tokens, 8 decode steps: the prefill's logits
   within (2e-4, 2e-4) of the no-cache forward's last position, each
   step's within (3e-3, 3e-3) of the no-cache forward on the same prefix,
   and each token the no-cache greedy choice where its top-two margin
   exceeds 6e-3. Then the gate's controls: the same 8 steps with a fault
   planted in the engine (each step's k/v written one slot early; the
   local layers' prefill crop left unrolled), fed the same tokens and held
   to the same no-cache logits, must each fail the gate.
17. lm_long: the token engine on gemma2-2b at its published width and
   depth on prompts of 8192 tokens, where every layer's prefill takes the
   streaming ``chunked_attention`` (the "scan" schedule, chunks of 2048;
   the local layers visit every chunk up to the causal front and mask
   their window of 4096), random weights from ``--seed``, deterministic
   mode. (a) bf16, 2 prompts, 16 greedy tokens, counters at 0 before it
   (path ``lm_long``): every local layer's cache holds 4096 slots and every
   global layer's 8208, every logit finite, a second ``generate``
   bit-equal, K1-K6 not launched; prefill seconds, decode ms a token
   (median, p90), tokens/s, peak memory, a decode step's bound. (b) f32
   cut to 4 layers (two L/G periods), 1 prompt: the streaming prefill's
   last logits within (2e-4, 2e-4) of the same model with its chunk
   threshold raised past the prompt (full attention), and 4 decode steps
   within (3e-3, 3e-3) of that model's no-cache forward. (c) the attention
   alone at gemma2's head geometry (B = 1, S = 8192, 8 heads, 4 kv heads,
   head dim 256, softcap 50, window 4096 and none): both schedules against
   ``full_attention``, the output and the q, k and v gradients within
   (3e-4, 3e-4) scaled by max |want|.
18. lm_families: the families of the SSM, RG-LRU, encoder and VLM mixers,
   one at a time at their published width and depth, random bf16 weights
   from ``--seed``:
   mamba2-2.7b (64 Mamba2 SSD layers, path ``lm_ssm``), recurrentgemma-9b
   (38 layers of R, R, L: RG-LRU and local attention, ``lm_hybrid``),
   whisper-base (6 encoder and 6 decoder layers with cross-attention over
   1500 frame embeddings, ``lm_audio``) and pixtral-12b (40 layers, 1024
   patch embeddings over the first positions, ``lm_vlm``); 2 prompts of
   2048, 2112 (past the 2048 window), 440 and 2048 tokens, with random
   frame or patch embeddings, 16 greedy tokens, twice: finite logits, the
   second run bit-equal, the caches' (KV, SSM and LRU states') shapes and
   dtypes those of ``init_caches``, K1-K6 not launched; prefill seconds,
   decode ms a token, tokens/s, peak memory, a decode step's bound. Then
   f32 cut to 2 layers (recurrentgemma: one R, R, L period): the prefill's
   last logits within (2e-4, 2e-4) and decode steps within (3e-3, 3e-3) of
   the no-cache forward on the same prefix (mamba2: a prompt of 1792 held
   at step 256, prefix 2048, since its forward takes a multiple of the SSD
   chunk; the others their first 8 steps), and for the two recurrent
   mixers the gate's control: the same steps with every conv tail zeroed
   before a step (mamba2 4 steps before the step held, recurrentgemma at
   the first) must fail the gate.
19. train_families: the two new mixers through ``FTTrainer`` with
   ``caqr_muon`` at their published widths (mamba2 cut to 2 layers,
   recurrentgemma to 3, one period), 4 data and QR lanes, b = 128,
   sequence 1024, batch 8, 2 steps, deterministic mode: failure-free
   (paths ``train_ssm``, ``train_hybrid``; every sweep's R held to the Gram
   identity) and with lane 1 killed inside a sweep of step 1 (``_kill``
   paths): params, optimizer state and losses bit-equal, one single-source
   REBUILD event; K1-K4 launched and K5/K6 not; K1-K4 at the paths' Muon
   shapes against their plain versions on 4 lanes and one; step seconds
   and their split, peak memory.
20. train_mesh: one process per lane in training. Four ranks spawned once
   (``make_lane_group``) on the card, shared with train_pod and closed
   before wide. TinyLlama-1.1B at its published width cut to 1 layer,
   sequence 1024, batch 8 over 4 data lanes, ``caqr_muon`` through
   ``FTTrainer(FTRunConfig(use_mesh=True, qr_lanes=4, panel_width=256))``
   on a lane mesh over the four ranks: every point of the step's 7 sweeps
   is a ``sweep_step`` in each rank (``QREngine(mesh=)``; K1 and K3 the one
   wide launch, K2 and K4 the wide routes). One step
   failure-free (path ``train_mesh``) and one with lane 1 killed inside the
   first ``w_in`` sweep (``train_mesh_kill``), under torch's deterministic
   mode: params and loss bit-equal to each other and to the same step on
   the SimComm engine, one single-source REBUILD event; every sweep's R of
   the failure-free step held to the Gram identity of its momentum slice;
   K1-K4 at the sweeps' shapes at b = 256 (``MESH_SHAPES``) against their
   plain versions on the step's momentum, on 4 lanes and on one; K1-K4
   launched on every rank and ``wide_gemm`` inside them, K5/K6 on none (the
   paths count the ranks' launches and the parent's). Prints the step
   seconds, boundaries, a point's round trip
   (the runners' seconds a point, and of those the wait for the ranks),
   and each rank's seconds, collectives and seconds inside them.
21. train_pod: the multi-pod step (``make_pod_train_step``) over the first
   two of the same ranks, one a pod: TinyLlama at its published width, 4
   layers, per-pod batch 4 x 1024, ``adamw``, two steps with PowerSGD-QR
   at rank 4 (path ``train_pod``) and two with the plain pmean (rank 0),
   deterministic mode (4 layers, not 2: at 2 or 3 the stacked norms are
   compressible matrices with fewer rows than the rank, where the
   reference's TSQR chain asserts, as the port's does). Checks: the
   params bit-equal across the pods after every step, the first step's
   returned state, loss and each pod's own state bit-equal to the same
   step run as two threads of this process (the one-process per-pod
   emulation; the later steps run the same code), finite losses, K1 launched in the
   ranks, and K1 at the compressed TSQR chain's shapes ((256, 4) and
   (260, 4) for the embedding, (512, 4) and (516, 4) for the head, (4, 4)
   for the norm stacks) within
   (3e-4, 3e-4) of its plain version, timed beside its bound and
   ``torch.geqrf``. Prints each step's seconds, the bytes each rank sends
   and stages in the gradient reduction at rank 4 and at 0, and each
   rank's and this process's peak memory.
22. wide: K1-K4 above 128 columns: K1 (and K3, K1's route on the stacked
   triangles) in one cooperative launch (``csrc/panel_qr_wide.cu``: K1's
   team on sub-panels of 128 columns, on clusters or, for 8 lanes of 4096
   rows, a plain grid; the products between them and in the T join as
   tile phases), K2 and K4
   through the products of ``csrc/wide.cu``. Against their plain versions,
   timed (events, device time, bound, plain, ``torch.geqrf`` or the
   ``torch.matmul`` chain), and K1's and K3's one launch bit-equal to the
   composed route (the same blocked route as separate launches of K1's
   team kernel and ``wide_gemm``, ``panel_qr.panel_qr_composed``) and timed
   beside it (events and device time), with the launch's cluster size and
   grid: K1 on (8, 4096, 256) at
   row start 0 and at the last b = 256 panel's, at the plain CAQR-Muon
   path's shapes (2048, 2048), (5632, 2048), (512, 256) and (768, 256), and
   on a ragged (1000, 200) at row start 37; K2 on Y (8, 4096, 256) and C
   (8, 4096, 4096) with Y's T and with a random upper-triangular T; K3 on
   two (8, 256, 256) R factors; K4 with C' (8, 256, 4096) and a random T;
   the products' kernel alone. Every product inside those records' first
   calls is held bit for bit to the oracle of its summation order
   (``wide.gemm_order``) and to K5/K6's in-block instantiation of the same
   tile routine (``fused_sweep.gemm_in_block``). Bitwise at b = 256: one
   lane == eight lanes (K1, K2, K4), the two lanes of a butterfly pair
   (K3), two column tiles (K2, K4), K5 == K1 then K2. K5 and K6 at b = 256
   on the first window (one cooperative launch each), against their plain
   versions, timed beside their bound and the stepped wide route. The
   sweep of the tall matrix at b = 256 (16 panels, counters at 0 before
   it; path ``wide``): R replicated bitwise, the Gram identity, Q^T A =
   [R; 0], least squares, K1-K4 launched and K5/K6 not; ``ft_caqr_sweep``
   with two kills (a leaf point and a trailing point of the root lane;
   path ``wide_kill``), bit-equal to failure-free, one single-source event
   a kill; ``run_panel_fused`` over the 16 panels (path ``wide_fused``, K6
   only), bit-equal to failure-free and to the stepped state machine at
   every panel boundary; the online sweep with fused segments and the same
   lanes killed at those panels' ends (path ``wide_online_fused``),
   bit-equal to failure-free and to the stepped online sweep, with the
   scheduled run's ledger; three runs of ``caqr_factorize``, the two-kill
   FT sweep and the fused state machine (median, min-max). Then the plain
   ``Trainer(caqr_muon)`` at
   ``TRAIN_REDUCED`` for 3 steps, twice, under torch's deterministic mode
   (path ``muon``): params and losses bit-equal, finite losses, every
   full-rank momentum slice's Q orthonormal within 1e-3 at step 0, K1 at
   the path's shapes on momentum slices against its plain version (within
   the tolerance on the leading columns whose condition number is at most
   1 / DEPENDENT_PIVOT) and against the float64 plain version (no worse
   than four times the f32 plain version, on the columns ``leading_rank``
   keeps), K1 launched and no sub-kernel (K1's team kernel, ``wide_gemm``);
   step seconds, each ``_orth2d`` shape's share of the step, peak memory.
23. spread: each full-width sweep (``caqr_factorize``, the state machine
   stepped and fused, the four-kill FT sweep, the online sweeps stepped,
   fused and double-buffered) run three times: median and min-max seconds.
24. autotune (run after phase 5, while the sweep's result is held): the
   autotuner (``repro_torch.kernels.autotune``) times every bit-neutral
   candidate of its DEFAULT_CELLS (K2 on the tall sweep's first and a late
   window, K4 on the first C', both again at b = 256: the column tile, and
   above 128 columns the products' tile and k range), each output held
   bit for bit to the static tile's; ``save``, ``clear`` and ``load``
   adopt every cell, a file of another fingerprint none; with the tuned
   cells loaded the tall sweep (counters at 0 before it, path
   ``autotune``) gives R, factors and bundles bit-equal to the untuned
   sweep's, each b = 128 cell consulted on it. One JSON line a cell: the
   winner, its ms and the static tile's.
25. adafactor: one ``make_train_step(cfg, adafactor(), constant(1e-3))``
   step at TinyLlama's width, 2 layers, 2 x 256 tokens, f32 (path
   ``adafactor``, deterministic mode): twice on the card, bit-equal, and
   params, ``vr`` and ``vc`` within 1e-4 (scaled by each leaf's max) of
   the same step on the CPU (run while the kernels build); the step's seconds and the optimizer state's
   bytes beside an AdamW step's.
26. dryrun (run while the kernels build): ``repro_torch.launch.dryrun``
   on meta tensors: the ``caqr``
   cell (``paper_qr.PRODUCTION``, 65536 x 4096 at b = 128 over 256 lanes)
   and kimi-k2 x train_4k (adafactor) at mesh ``single`` (path
   ``dryrun``: no kernel launched); both records printed.
27. bf16 (run after phase 7): the tall matrix cast to bf16 through the
   bf16 kernels (b = 128). K1-K6 one at a time at the first panel's
   shapes, K2 and K4 also at w = 512: K1-K4 equal to the f32 kernel on
   the widened inputs rounded once, bit for bit; K5 equal to K1 then K2
   at bf16; each within the bf16 pair of ``ref.tolerances`` of its plain
   version on the card (scaled by max(1, |plain|)); one lane of the
   P-lane launch equal to a launch of it alone (K1-K5); timed (events and
   device alone) beside the plain version, the f32 twin, the library
   call (the ``torch.matmul`` chain in bf16; ``torch.geqrf`` on the
   widened input for K1 and K3, which takes no bf16; the stepped bf16
   kernels for K5/K6) and the bound (989 TFLOP/s, 2 bytes an element).
   Then, counters at 0 before each: ``caqr_factorize`` (path
   ``bf16_sweep``: K1-K4 at bf16 launched, R replicated bitwise, its
   float64 Gram residual at most 0.1, printed beside the floor, the f32
   sweep of the same matrix with R rounded to bf16); ``ft_caqr_sweep``
   with the four kills (``bf16_kill``: bit-equal to failure-free, the
   f32 sweep's ledger); the state machine stepped and fused
   (``bf16_stepped``, ``bf16_fused``: both bit-equal to the sweep, K6
   once a panel); the fused leaf entry (``bf16_fused_leaf``: K5, equal to
   K1 then K2). The kernels line lists the bf16 records (``*_bf16``)
   beside the f32 ones, their launches counted in
   ``backend.BF16_LAUNCHES`` on the bf16 paths.
28. bf16_wide (run after phase 22, whose f32 ledger it reuses): the tall
   matrix cast to bf16 at b = 256 (16 panels, L = 3) through the bf16
   kernels above 128 columns (``csrc/panel_qr_wide_bf16.cu``,
   ``csrc/wide_bf16.cu``, ``csrc/fused_wide_bf16.cu``). K1 (at row start
   0 and at the last panel's row starts), K2 (Y (8, 4096, 256), C the
   (8, 4096, 4096) window), K3 (two (8, 256, 256) triangles), K4 (C'
   (8, 256, 4096)), K5 and K6 at the first panel's shapes, each held to
   its bitwise oracle (K1-K4 the f32 kernel on the widened inputs rounded
   once, K5 K1 then K2, K6 the stepped bf16 panel), a lane alone to its
   lane (K1-K5), and to the plain version through ``held_bf16``; timed
   beside the f32 twin, the plain version, the library call (as in phase
   27) and the bound. Then, counters at 0 before each: ``caqr_factorize``
   (``bf16_wide_sweep``: K1-K4 at bf16 launched, ``BF16_LAUNCHES ==
   LAUNCHES``, R replicated bitwise, its float64 Gram residual at most
   0.1 beside its floor, the f32 b = 256 sweep with R rounded once);
   ``ft_caqr_sweep`` with ``WIDE_KILLS`` (``bf16_wide_kill``: bit-equal
   to failure-free, phase 22's f32 ledger); the state machine stepped and
   fused (``bf16_wide_stepped``, ``bf16_wide_fused``: bit-equal to the
   sweep, K6 launched 16 times); the fused leaf entry
   (``bf16_wide_fused_leaf``: K5 == K1 then K2). The kernels line lists
   these records (``*_bf16_wide``) with their launches on these paths.

The kernels line gives each kernel's launches on every path above, each
counted from 0 just before the path ran (``lm_serve``, ``lm_long`` and
the four ``lm_families`` paths: 0 for every kernel; on the spmd paths ``spmd``,
``spmd_kill``, ``spmd_mds`` and ``spmd_b256``, the sum of the ranks' own
counters; on ``train_mesh``, ``train_mesh_kill`` and ``train_pod`` the
ranks' counters and this process's); its ``wide_gemm`` record counts
the products' kernel's launches inside the wide calls
(``backend.SUB_LAUNCHES``: K2's and K4's wide routes; K1 and K3 launch no
sub-kernel, and the muon path none at all). The line before it holds the
wide phase's records of K1-K4.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Needs CUDA; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import multiprocessing as mp
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time

# cuBLAS reads its workspace setting when CUDA starts; the train phase's
# deterministic mode needs the fixed one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import SimComm, caqr_apply_qt, caqr_factorize, ft_tsqr  # noqa: E402
from repro_torch.core import block_row_layout, householder, panel_geometry, recovery  # noqa: E402
from repro_torch.core import sweep_geometry  # noqa: E402
from repro_torch.core.lstsq import caqr_lstsq  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    Semantics,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    iter_sweep_points,
    sweep_point,
)
from repro_torch.ft.online import state as sm  # noqa: E402
from repro_torch.kernels import autotune, backend, build, ops, ref  # noqa: E402
from repro_torch.kernels import fused_sweep as tfs  # noqa: E402
from repro_torch.kernels import panel_qr as tpq  # noqa: E402
from repro_torch.kernels import stacked_qr as tsa  # noqa: E402
from repro_torch.kernels import wide  # noqa: E402
from repro_torch.kernels import wy_apply as twy  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.dist import compat  # noqa: E402
from repro_torch.launch import dryrun, spmd_qr  # noqa: E402
from repro_torch.launch.serve_qr import make_requests  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serve import Engine, QRService, ServeConfig  # noqa: E402
from repro_torch.optim import powersgd  # noqa: E402
from repro_torch.optim.adafactor import adafactor  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.train import (  # noqa: E402
    PodTrainState,
    TrainConfig,
    Trainer,
    TrainState,
    make_pod_train_step,
    make_train_step,
)
from repro_torch.train.ftrun import (  # noqa: E402
    FTRunConfig,
    FTTrainer,
    StepSweepKiller,
    TrainingSuspended,
)
from repro_torch.train.ftrun.tasks import task_slice  # noqa: E402

P, M_LOC, N, B = 8, 4096, 4096, 128
L = P.bit_length() - 1
PEAK_FP32 = 67e12    # FLOP/s, H100 SXM outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3
GRAM_TOL = 1e-3       # relative, float64 Gram identity R^T R = A^T A
QTA_TOL = 1e-3        # relative to max |R|
LSTSQ_TOL = 1e-3      # relative to the normal-equations solution
# a panel column whose pivot is below this share of the largest depends on
# the columns before it to within f32 round-off over the f32 tolerance
# (1.2e-7 / 3e-4): its reflector is not fixed by the data
DEPENDENT_PIVOT = 4e-4

KERNELS = {
    "panel_qr": ("src/repro_torch/csrc/panel_qr.cu",
                 "src/repro/kernels/panel_qr.py:149"),
    "wy_apply": ("src/repro_torch/csrc/wy_apply.cu",
                 "src/repro/kernels/wy_apply.py:80"),
    "stacked_qr": ("src/repro_torch/csrc/stacked_qr.cu",
                   "src/repro/kernels/stacked_qr.py:108"),
    "stacked_apply": ("src/repro_torch/csrc/stacked_qr.cu",
                      "src/repro/kernels/stacked_qr.py:171"),
    "panel_qr_apply": ("src/repro_torch/csrc/fused_panel_f32.cu",
                       "src/repro/kernels/fused_sweep.py:226"),
    "fused_panel": ("src/repro_torch/csrc/fused_panel_f32.cu",
                    "src/repro/kernels/fused_sweep.py:167"),
}
STEPPED = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")
LATE_W = 512  # a late panel's window width (panel 28 of 32)
# the FT driver's four kills {point: lane}: an early leaf point, a tsqr and
# a trailing point mid-sweep (the latter of the root lane: every panel of
# the tall cell is rooted at lane 0) and the last panel's last point
KILLS = {sweep_point(1, "leaf"): 2,
         sweep_point(12, "tsqr", 1): 5,
         sweep_point(16, "trailing", 0): 0,
         sweep_point(N // B - 1, "trailing", L - 1): 7}
# fused boundaries are panel ends: the same lanes at the last point of the
# same four panels
PANEL_END_KILLS = {sweep_point(k, "trailing", L - 1): lane
                   for (k, _, _), lane in KILLS.items()}
SPREAD_RUNS = 3
# the spmd phase: one rank a lane, every collective through gloo; the
# (m_loc, n) of its MDS f = 2 cell (the scheduled driver re-encodes every
# protected leaf across the ranks at each point), that cell's two deaths,
# the point after which the tall matrix's parity is encoded across the
# ranks, and the group's timeout (collectives and each task)
SPMD_MDS = (512, 512)
SPMD_MDS_KILL = (sweep_point(2, "trailing", L - 1), [2, 5])
SPMD_PARITY_POINT = sweep_point(1, "leaf")
SPMD_TIMEOUT_S = 300.0
# the online runs over the ranks: the tall MDS f = 2 run's two non-buddy
# deaths on a panel boundary (its segments are whole panels, so one refresh
# a panel), and the elastic run's kill (lane, point): fold 8 -> 4
SPMD_ONLINE_MDS_KILL = (sweep_point(20, "trailing", L - 1), [2, 5])
SPMD_SHRINK_KILL = (3, sweep_point(8, "trailing", L - 1))
# single-process sweeps of the spread phase timed before and after it
SPMD_RESIDUE = ("caqr_factorize", "ft_sweep_four_kills",
                "online_async_four_kills")
# the serve phase: the larger bucket's tenants reach 32768 x 2046, 16 panels
SERVE_BUCKETS = ((1024, 1024), (4096, 2048))
SERVE_SLOTS = 8
SERVE_REQUESTS = 24
SERVE_LSTSQ_FRAC = 0.25
SERVE_KILL_LANE, SERVE_KILL_TICK = 2, 2
# requests a drain_batched call takes: four of the larger bucket's tenants
# with their bundles are about 9 GB, twice that while the batch is stacked
SERVE_GROUP = 4
# the train phase: TinyLlama-1.1B at its published width, cut in depth
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2, 1024, 8, 4
TRAIN_LANES, TRAIN_B = 4, 128
TRAIN_LR, TRAIN_WARMUP = 1e-2, 1
TRAIN_REDUCED = {
    "n_layers": "22 -> 2: time (each layer adds 7 full-width sweeps a step)",
    "seq_len": "2048 -> 1024: time (the grad phase is not what is held here)",
    "global_batch": "8 rows over 4 data lanes: time",
    "steps": "4: enough for a loss that falls, a mid-step kill at step 2, "
             "a suspension inside step 2 and a lane death at step 3",
}
# the mid-sweep kill: lane 1, step 2, inside the first w_in sweep
TRAIN_KILL = dict(at_step=2, lane=1, task="groups/l0/ffn/.w_in#0",
                  point=sweep_point(8, "tsqr", 1))
TRAIN_FAIL = {3: [2]}     # the training-level lane death (REBUILD replay)
TRAIN_PSGD_RANK, TRAIN_PSGD_STEPS = 4, 2
# K1-K4's shapes on the train path (m_loc, n, b): the Muon sweeps of w_in,
# w_gate and w_out (5632 x 2048), of wq and wo (2048 x 2048) and of wk and
# wv (2048 x 256), then the PowerSGD projections (m x r) of wq-like,
# w_out-like and embedding slices
TRAIN_SHAPES = ((1408, 2048, 128), (512, 2048, 128), (512, 256, 128),
                (512, 4, 4), (1408, 4, 4), (8000, 4, 4))
# the MoE phase: mixtral-8x22b at its published width, cut in depth
MOE_ARCH = "mixtral-8x22b"
MOE_LAYERS, MOE_SEQ, MOE_BATCH, MOE_STEPS = 1, 1024, 8, 3
MOE_REDUCED = {
    "n_layers": "56 -> 1: memory and time (one layer's expert banks, 2.4 G "
                "parameters, with their float32 momentum and second moment "
                "and the trainer's step fill most of the card; each layer "
                "adds 29 full-width sweeps a step)",
    "seq_len": "4096 (the train_4k shape) -> 1024: time (the window of 4096 "
               "then masks nothing; the CPU tests hold the window)",
    "global_batch": "8 rows over 4 data lanes: time",
    "steps": "3: a kill inside step 2 and a step after it",
}
# the mid-sweep kill: lane 1, step 2, inside the fourth w_gate expert's sweep
# (48 panels), after panel 20's last butterfly level
MOE_KILL = dict(at_step=2, lane=1, task="groups/l0/ffn/.w_gate#3",
                point=sweep_point(20, "tsqr", 1))
# K1-K4's shapes on the MoE path (m_loc, n, b): the expert slices (16384 x
# 6144: w_gate and w_in transposed, w_out as it is), wq and wo (6144 x
# 6144), wk and wv (6144 x 1024), and the router (6144 x 8), whose sweep is
# one panel as wide as the matrix (the engine clamps b to n)
MOE_SHAPES = ((4096, 6144, 128), (1536, 6144, 128), (1536, 1024, 128),
              (1536, 8, 8))
MOE_ROUTER = "groups/l0/ffn/.w_router#0"   # the router's sweep task
MOE_SWEEPS = 29                            # sweeps a step (the tasks)
# the wide phase: K1-K4 above 128 columns (the blocked routes of
# kernels/wide.py) on the tall cell's matrix at b = 256 (16 panels)
WIDE_B = 256
# the wide FT sweep's two kills {point: lane}: a leaf point and a trailing
# point of the panel's root lane, mid-sweep
WIDE_KILLS = {sweep_point(3, "leaf"): 5, sweep_point(9, "trailing", 1): 0}
# the same lanes killed at those panels' ends, for the fused online sweep
WIDE_END_KILLS = {sweep_point(3, "trailing", L - 1): 5,
                  sweep_point(9, "trailing", L - 1): 0}
# K1 at the plain CAQR-Muon path's shapes at TinyLlama's width (m, b): wq and
# wo (one leaf), the MLP matrices made tall (one leaf), and wk and wv's
# leaf and chain steps ([R; tile] of 256 + 512 rows)
MUON_K1 = {"wq": (2048, 2048), "w_mlp": (5632, 2048), "wk_leaf": (512, 256),
           "wk_step": (768, 256)}
MUON_STEPS = 3
# the lm_serve phase: the token engine on gemma2-2b at its published width
# and depth, prompts longer than its sliding window of 4096 (bf16, greedy);
# then the f32 parity run, held to the no-cache forward
LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 4160, 32
LM_F32_BATCH, LM_F32_STEPS = 2, 8
LM_PREFILL_TOL = (2e-4, 2e-4)   # prefill logits against the no-cache forward
LM_DECODE_TOL = (3e-3, 3e-3)    # the reference's decode tolerance
LM_MARGIN = 6e-3                # top-two margin above which tokens must agree
# faults planted in the engine for the decode gate's controls: each must
# fail the gate that the sound run passes
LM_FAULTS = ("stale_slot", "no_roll")
# the lm_long phase: gemma2-2b at its published width and depth on prompts
# of 8192 tokens, where every layer's prefill streams (chunked_attention,
# the "scan" schedule, chunks of 2048); then f32 at 4 layers against the
# same model with the chunk threshold raised past the prompt (full
# attention), and the attention alone at gemma2's head geometry
LONG_BATCH, LONG_PROMPT, LONG_NEW = 2, 8192, 16
LONG_F32_LAYERS, LONG_F32_STEPS = 4, 4
LONG_ATTN = dict(B=1, S=8192, H=8, Kv=4, Dh=256, cap=50.0, window=4096)
LONG_ATTN_TOL = (3e-4, 3e-4)    # scaled by max |want|, as max_err scales it
# the lm_families phase: the four families of the SSM, RG-LRU, encoder and
# VLM mixers at their published width and depth (bf16, 16 greedy tokens,
# twice), then at f32 cut in depth against the no-cache forward. mamba2's
# no-cache forward takes a multiple of its SSD chunk (256), so its f32 run
# prefills 1792 tokens and is held at step 256 (prefix 2048). The planted
# control of a recurrent mixer zeroes every conv tail before decode step
# ``plant_at`` (mamba2's state forgets within a few dozen steps, so it is
# planted 4 steps before the step held)
FAMILY_BATCH, FAMILY_NEW = 2, 16
FAMILIES = {
    "mamba2-2.7b": dict(path="lm_ssm", prompt=2048, f32_layers=2,
                        f32_prompt=1792, f32_steps=256, held=(256,), plant_at=252),
    "recurrentgemma-9b": dict(path="lm_hybrid", prompt=2112, f32_layers=3,
                              f32_prompt=2112, f32_steps=8, held=tuple(range(1, 9)),
                              plant_at=0),
    "whisper-base": dict(path="lm_audio", prompt=440, f32_layers=2,
                         f32_prompt=440, f32_steps=8, held=tuple(range(1, 9)),
                         plant_at=None),
    "pixtral-12b": dict(path="lm_vlm", prompt=2048, f32_layers=2,
                        f32_prompt=2048, f32_steps=8, held=tuple(range(1, 9)),
                        plant_at=None),
}
FAMILY_REDUCED = {
    "f32 depth": "mamba2 64 -> 2, recurrentgemma 38 -> 3 (one R, R, L "
                 "period), whisper 6 -> 2 decoder layers (6 encoder layers), "
                 "pixtral 40 -> 2: time (the no-cache forwards)",
}
# the train_families phase: the two new mixers through FTTrainer with
# caqr_muon at their published widths, cut in depth, as the train phase
# (4 data and QR lanes, b = 128, sequence 1024, batch 8): 2 failure-free
# steps, and 2 steps with a lane killed inside a sweep of step 1
TRAIN_FAMILY_STEPS = 2
TRAIN_FAMILIES = {
    "mamba2-2.7b": dict(
        path="train_ssm", layers=2,
        kill=dict(at_step=1, lane=1, task="groups/l0/ssm/.w_in#1",
                  point=sweep_point(8, "tsqr", 1)),
        # K1-K4 at the Muon sweeps' shapes (m_loc, n, b): w_in transposed
        # (10576 x 2560), w_out (5120 x 2560), conv_w transposed (5376 x 4)
        shapes=((2644, 2560, 128), (1280, 2560, 128), (1344, 4, 4))),
    "recurrentgemma-9b": dict(
        path="train_hybrid", layers=3,
        kill=dict(at_step=1, lane=1, task="groups/l1/lru/.w_x#0",
                  point=sweep_point(8, "tsqr", 1)),
        # the LRU's w_in transposed (8192 x 4096), its gates and w_out and
        # attention's wq and wo (4096 x 4096), the MLP's (12288 x 4096), wk
        # and wv (4096 x 256), conv_w transposed (4096 x 4)
        shapes=((2048, 4096, 128), (1024, 4096, 128), (3072, 4096, 128),
                (1024, 256, 128), (1024, 4, 4))),
}
TRAIN_FAMILY_REDUCED = {
    "n_layers": "mamba2 64 -> 2, recurrentgemma 38 -> 3 (one R, R, L "
                "period): time (each layer adds 3 or 7-8 full-width sweeps "
                "a step)",
    "seq_len": "1024, as the train phase: time (recurrentgemma's window of "
               "2048 then masks nothing; the CPU tests hold the window)",
    "steps": "2: a kill inside step 1",
}
# the train_mesh and train_pod phases: four ranks on the card (one a lane,
# or one a pod for the first two); TinyLlama at its published width, cut in
# depth. The mesh trainer's one step at panel width 256 and its kill,
# inside step 0's first w_in sweep (8 panels) after panel 4's last
# butterfly level
MESH_RANKS = 4
MESH_LAYERS, MESH_STEPS, MESH_B = 1, 1, 256
MESH_KILL = dict(at_step=0, lane=1, task="groups/l0/ffn/.w_in#0",
                 point=sweep_point(4, "tsqr", 1))
# K1-K4's shapes on the mesh trainer's sweeps (m_loc, n, b), one lane a
# rank: w_in, w_gate and w_out (5632 x 2048), wq and wo (2048 x 2048), wk
# and wv (2048 x 256)
MESH_SHAPES = ((1408, 2048, MESH_B), (512, 2048, MESH_B), (512, 256, MESH_B))
MESH_REDUCED = {
    "n_layers": "22 -> 1: time (each layer adds 7 sweeps of about 60 "
                "points a step, each point a round trip to the ranks)",
    "seq_len": "2048 -> 1024, as the train phase",
    "steps": "1 failure-free and 1 with a kill inside a sweep",
    "panel_width": "128 -> 256: time (half the points a sweep; the whole "
                   "script passed 840 s at 128)",
}
POD_PODS, POD_BATCH, POD_LAYERS, POD_STEPS = 2, 4, 4, 2
POD_RANK, POD_LR = 4, 1e-3
# K1's shapes on the compressed reduction's TSQR chain (m, b): the
# embedding's P (32000 x 4) in tiles of 256, the head's (2048 x 4) in 512,
# the stacked norms' (4 x 4) in one tile
POD_K1 = ((256, 4), (260, 4), (512, 4), (516, 4), (4, 4))
POD_REDUCED = {
    "n_layers": "22 -> 4: time. At 2 or 3 layers the stacked norms "
                "(n_layers, 2048) reach compress_tree's min_size of 4096 "
                "with fewer rows than the rank, and the TSQR chain asserts "
                "tile_rows >= rank, in the reference as in the port",
    "seq_len": "2048 -> 1024, as the train phase",
    "pods": "2 (the reference's multi-pod mesh has 2 pods) on one card",
    "steps": "2 at compression rank 4 and 2 at rank 0 (plain pmean)",
}
# launches of every kernel on every path, counters at 0 before each path
AUTOTUNE_REPS = 5
# the adafactor phase: the train phase's TinyLlama config on 2 x 256 tokens,
# so the CPU's run of the same step stays within seconds
ADA_BATCH, ADA_SEQ = 2, 256
ADA_TOL = 1e-4       # card against CPU, scaled by max |CPU| a leaf
ADA_REDUCED = {
    "n_layers": "22 -> 2, the train phase's cut: the CPU runs the same step",
    "tokens": "2 x 256: the CPU's step within seconds",
    "dtype": "bfloat16 -> float32: a parameter's bf16 rounding flips on a "
             "1e-7 difference of its update, 4e-3 of it, past the tolerance",
}
# the dry run's cells here: the paper's own and the 1T adafactor cell
DRYRUN_CELLS = (("kimi-k2-1t-a32b", "train_4k"),)

PATH_LAUNCHES = {}
# the wide paths' launches of the kernels inside a wide call
# (backend.SUB_LAUNCHES), from the same runs
PATH_SUB = {}


# wall seconds of each phase of main(), by name
PHASE_SECONDS = {}
T_START = time.perf_counter()


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0


def build_kernels(out: dict) -> None:
    """``build.build_all()``, its seconds and any error into ``out`` (run
    on a thread beside the CPU's work)."""
    t0 = time.perf_counter()
    try:
        build.build_all()
    except Exception as e:  # noqa: BLE001 - raised again by the caller
        out["error"] = e
    out["seconds"] = time.perf_counter() - t0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def device_ms(fn, reps: int, kernel: str = ""):
    """Device time per call of ``fn``: the kernels' own time under
    torch.profiler over ``reps`` calls. Unlike ``time_ms`` it leaves out
    the host's time to issue each call, which bounds the eager time of a
    kernel shorter than about 0.05 ms. The trace must hold at least
    ``reps`` records of ``kernel`` (a name prefix; any kernel if empty):
    the profiler has been seen to drop records, so it tries three times,
    then gives None (not measured) rather than a short sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in events
                   if e.key.removeprefix("void ").startswith(kernel))
        if seen >= reps:
            return sum(_device_us(e) for e in events) / reps / 1e3
    return None


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_err(got, want):
    """(largest |got - want| over all outputs, the same with each output's
    difference over max(1, max|want|)); the second is held to the
    tolerance."""
    diffs = [(float((g - w).abs().max()), max(1.0, float(w.abs().max())))
             for g, w in zip(got, want)]
    return max(d for d, _ in diffs), max(d / s for d, s in diffs)


def as_tuple(x):
    if isinstance(x, dict):
        return tuple(x[f] for f in x if f != "tops")
    return x if isinstance(x, tuple) else (x,)


def same_bits(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(as_tuple(got), as_tuple(want)))


def wy_cost(P, m, b, n, eb=4.0):
    """(FLOPs, bytes) of K2: Y^T C and Y W at 2mbn each, T^T W1 at b^2 n
    (T triangular, counted once); Y, T, C read and out written once, at
    ``eb`` bytes an element."""
    return (P * (4.0 * m * b * n + b * b * n),
            eb * P * (m * b + b * b + 2 * m * n))


def sa_cost(P, b, n, eb=4.0):
    """(FLOPs, bytes) of K4: three triangular products at b^2 n each;
    Y2, T, Ct, Cb read and ot, ob, W written once."""
    return P * 3.0 * b * b * n, eb * P * (2 * b * b + 5 * b * n)


def wy_library(Y, T, C):
    return C - Y @ (T.mT @ (Y.mT @ C))


def sa_library(Y2, T2, Ct, Cb):
    W = T2.mT @ (Ct + Y2.mT @ Cb)
    return Ct - W, Cb - Y2 @ W, W


def template_args(mangled: str) -> list:
    """The template arguments at the start of a mangled name's remainder
    (``I...E``): Li128E (int 128), Lb1E (true), f (float), a named type
    (13__nv_bfloat16, shown as bf16), and a view's element types
    (N5repro9GemmViewTI...EE, shown as the types of A, B, D, out and out2,
    ``b`` for bf16 and ``f`` for float)."""
    if not mangled.startswith("I"):
        return []
    args, i = [], 1
    while i < len(mangled) and mangled[i] != "E":
        if m := re.match(r"L([ib])(\d+)E", mangled[i:]):
            t, v = m.groups()
            args.append(v if t == "i" else ("false", "true")[int(v)])
            i += m.end()
        elif mangled[i] == "f":
            args.append("float")
            i += 1
        elif m := re.match(r"N5repro9GemmViewTI(.*?)EE", mangled[i:]):
            # bf16 is spelled once, then by its substitution (S1_, S2_, ...)
            types = re.findall(r"13__nv_bfloat16|S\d*_|f", m.group(1))
            args.append("view " + "".join("f" if t == "f" else "b" for t in types))
            i += m.end()
        elif m := re.match(r"(\d+)", mangled[i:]):
            n = int(m.group(1))
            name = mangled[i + m.end():i + m.end() + n]
            args.append("bf16" if name == "__nv_bfloat16" else name)
            i += m.end() + n
        else:
            break
    return args


def ptxas(source: str, kernel: str) -> dict:
    """Registers and spill bytes of every instance of ``kernel`` (a
    ``__global__`` name) in the build log of ``source``."""
    out = {}
    for fn, use in build.resource_usage(pathlib.Path(source).stem).items():
        m = re.match(r"_Z(\d+)", fn)  # the name's length, then the name
        end = m.end() + int(m.group(1)) if m else 0
        if m and fn[m.end():end] == kernel:
            args = template_args(fn[end:])
            out[kernel + (f"<{', '.join(args)}>" if args else "")] = use
    return out


def leaf_cost(P, m, b, rs, eb=4.0):
    """(FLOPs, bytes) of K1 on P panels whose column loops start at row rs:
    3 m' b^2 - b^3 / 3 a lane over the m' = m - rs rows the loop touches;
    those rows read, Y (m x b), T and R written once."""
    ma = m - rs
    return (P * (3.0 * ma * b * b - b ** 3 / 3.0),
            eb * P * (ma * b + m * b + 2 * b * b))


def k1_record(panel: torch.Tensor, rs: int, reps: int) -> dict:
    """K1 on one lane's (m x b) panel at row start rs, beside the plain
    version and ``torch.geqrf`` of the rows the column loop touches."""
    m, b = panel.shape
    run = lambda: ops.panel_qr(panel, rs)  # noqa: E731
    active = panel[rs:].contiguous()
    lib = lambda: torch.geqrf(active)  # noqa: E731
    err, scaled = max_err(run(), ref.panel_qr(panel, rs))
    check(scaled <= ref.tolerances(torch.float32)[0],
          f"panel_qr: scaled error {scaled} at rs = {rs}")
    bms, by = bound_ms(*leaf_cost(1, m, b, rs))
    return dict(shape=[m, b], row_start=rs, team=backend.team_blocks(m, b),
                max_abs_err=err, scaled_err=scaled, ms=time_ms(run, reps),
                device_ms=device_ms(run, reps, "panel_qr_kernel"),
                bound_ms=bms, bound_by=by,
                library_ms=time_ms(lib, reps),
                library_device_ms=device_ms(lib, reps),
                library_shape=list(active.shape))


def team_record() -> dict:
    """K1's lane team at the tall and square cells' panels: its size,
    shared memory a block, and how many teams the card holds at once; the
    registers and spills of K1, K5 and K6 from their build logs."""
    out = {}
    for cell, m in (("tall", M_LOC), ("square", N // P)):
        C = backend.team_blocks(m, B)
        out[cell] = dict(m=m, b=B, team=C,
                         slab_in_smem=backend.team_slab_in_smem(m, B, C),
                         smem_bytes=tpq.smem_bytes(m, B, C),
                         max_active_clusters=tpq.max_active_clusters(m, B))
    out["ptxas"] = {**ptxas(KERNELS["panel_qr"][0], "panel_qr_kernel"),
                    **ptxas(KERNELS["fused_panel"][0], "panel_qr_apply_kernel"),
                    **ptxas(KERNELS["fused_panel"][0], "fused_panel_kernel")}
    return out


def shape_record(op: str, args: tuple, cost: tuple, lib, reps: int) -> dict:
    """One kernel at other shapes than the first panel's: time, bound,
    library time and error against the plain version."""
    run = getattr(ops, op)
    got, want = as_tuple(run(*args)), as_tuple(getattr(ref, op)(*args))
    err, scaled = max_err(got, want)
    del got, want
    check(scaled <= ref.tolerances(torch.float32)[0],
          f"{op}: scaled error {scaled} at {[tuple(a.shape) for a in args]}")
    bms, by = bound_ms(*cost)
    C = args[2]
    P = C.shape[0] if C.dim() == 3 else 1
    return dict(shapes=[list(a.shape) for a in args], bn=backend.tile_bn(
        P, C.shape[-1], backend.sm_count(0)),
        max_abs_err=err, scaled_err=scaled, ms=time_ms(lambda: run(*args), reps),
        device_ms=device_ms(lambda: run(*args), reps, op + "_kernel"),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lambda: lib(*args), reps),
        library_device_ms=device_ms(lambda: lib(*args), reps))


def kernel_phase(A: torch.Tensor) -> list:
    """K1-K6 on the first panel's data of the sweep, against their plain
    versions; returns one record per kernel."""
    rtol, _ = ref.tolerances(torch.float32)
    f = 4.0  # bytes per float
    panel = A[..., :B].contiguous()
    rows = [(i, i ^ 1) for i in range(P)]
    C = A  # panel 0's live window is the whole width
    comm = SimComm(P)
    cases = {}
    Y, T, R = ops.panel_qr(panel, 0)
    leaf_flops = 3.0 * M_LOC * B * B - B ** 3 / 3.0
    apply_flops = 4.0 * M_LOC * B * N + B * B * N
    flops, nbytes = leaf_cost(P, M_LOC, B, 0)
    cases["panel_qr"] = dict(
        run=lambda: ops.panel_qr(panel, 0), plain=lambda: ref.panel_qr(panel, 0),
        lib=lambda: torch.geqrf(panel), flops=flops, nbytes=nbytes, reps=20)
    flops, nbytes = wy_cost(P, M_LOC, B, N)
    cases["wy_apply"] = dict(
        run=lambda: ops.wy_apply(Y, T, C), plain=lambda: ref.wy_apply(Y, T, C),
        lib=lambda: wy_library(Y, T, C), flops=flops, nbytes=nbytes, reps=10)
    R_top = R.contiguous()
    R_bot = R[[j for _, j in rows]].contiguous()
    Y2, T2, _ = ops.stacked_qr(R_top, R_bot)
    stack = torch.cat([R_top, R_bot], dim=1)
    cases["stacked_qr"] = dict(
        run=lambda: ops.stacked_qr(R_top, R_bot),
        plain=lambda: ref.stacked_qr(R_top, R_bot),
        lib=lambda: torch.geqrf(stack),
        flops=P * float(B ** 3), nbytes=f * P * 5 * B * B, reps=10)
    Ct = ops.wy_apply(Y, T, C)[:, :B].contiguous()
    Cb = Ct[[j for _, j in rows]].contiguous()
    flops, nbytes = sa_cost(P, B, N)
    cases["stacked_apply"] = dict(
        run=lambda: ops.stacked_apply(Y2, T2, Ct, Cb),
        plain=lambda: ref.stacked_apply(Y2, T2, Ct, Cb),
        lib=lambda: sa_library(Y2, T2, Ct, Cb), flops=flops, nbytes=nbytes,
        reps=10)

    def k1_k2():
        Yl, Tl, _ = ops.panel_qr(A[..., :B], 0)
        return ops.wy_apply(Yl, Tl, A)

    cases["panel_qr_apply"] = dict(
        run=lambda: ops.panel_qr_apply(A, 0, B),
        plain=lambda: ref.panel_qr_apply(A, 0, B),
        stepped=k1_k2, stepped_route="K1+K2 (panel_qr, wy_apply)",
        flops=P * (leaf_flops + apply_flops),
        nbytes=f * P * (2 * M_LOC * N + M_LOC * B + 2 * B * B + B * N),
        reps=3)
    s0 = sm.initial_sweep_state(comm, A, B)
    pts = sm.panel_points(s0.geom)
    cases["fused_panel"] = dict(
        run=lambda: ops.fused_panel(A, 0, b=B, m_loc_pad=M_LOC, levels=L),
        plain=lambda: ref.fused_panel(A, 0, b=B, m_loc_pad=M_LOC, levels=L),
        stepped=lambda: sm.run_steps(comm, s0, pts),
        stepped_route="the stepped panel (K1, 3 x K3, K2, 3 x K4)",
        flops=P * (leaf_flops + apply_flops + L * (B ** 3 + 3.0 * B * B * N)),
        nbytes=f * P * (2 * M_LOC * N + M_LOC * B + (3 + 2 * L) * B * B
                        + (1 + 3 * L) * B * N),
        reps=3)

    # Determinism: one lane of the P-lane launch equals a launch of it alone.
    k = P - 3
    check(same_bits(tuple(x[k] for x in (Y, T, R)), ops.panel_qr(panel[k], 0)),
          "panel_qr: lane bits depend on the launch")
    one = ops.stacked_qr(R_top[k], R_bot[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_qr(R_top, R_bot), one)),
          "stacked_qr: lane bits depend on the launch")
    # K3 on a butterfly pair's stacks, as ft_tsqr_level gives them at level
    # 0: both lanes of a pair stack the same two R factors, top lane first.
    pair = ops.stacked_qr(R[[p & ~1 for p in range(P)]].contiguous(),
                          R[[p | 1 for p in range(P)]].contiguous())
    pair_bitwise = all(torch.equal(x[p], x[p ^ 1]) for x in pair for p in range(P))
    check(pair_bitwise, "stacked_qr: the two lanes of a butterfly pair differ")
    del pair
    one = ops.wy_apply(Y[k], T[k], C[k])
    check(torch.equal(ops.wy_apply(Y, T, C)[k], one),
          "wy_apply: lane bits depend on the launch")
    one = ops.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_apply(Y2, T2, Ct, Cb), one)),
          "stacked_apply: lane bits depend on the launch")
    fused_leaf = ops.panel_qr_apply(A, 0, B)
    check(same_bits(tuple(x[k] for x in fused_leaf),
                    ops.panel_qr_apply(A[k], 0, B)),
          "panel_qr_apply: lane bits depend on the launch")
    # K5 shares K1's and K2's device code: bit-equal to the two launches.
    Yk, Tk, Rk = ops.panel_qr(A[..., :B], 0)
    Ck = ops.wy_apply(Yk, Tk, A)
    check(same_bits(fused_leaf, (Yk, Tk, Rk, Ck, Ck[:, :B])),
          "panel_qr_apply differs from panel_qr then wy_apply")
    del fused_leaf, Yk, Tk, Rk, Ck
    # K2 and K4: the column tile does not change the bits.
    bn_bitwise = {
        "wy_apply": same_bits(twy.wy_apply(Y, T, C, bn=32),
                              twy.wy_apply(Y, T, C, bn=128)),
        "stacked_apply": same_bits(tsa.stacked_apply(Y2, T2, Ct, Cb, bn=32),
                                   tsa.stacked_apply(Y2, T2, Ct, Cb, bn=128)),
    }
    check(all(bn_bitwise.values()), f"column tiles change the bits: {bn_bitwise}")
    # K2 and K4 at a late panel's window and on one lane (a REBUILD replay)
    late = N - LATE_W
    Ctl, Cbl = Ct[..., :LATE_W].contiguous(), Cb[..., :LATE_W].contiguous()
    other_shapes = {
        "panel_qr": {
            "one_lane": k1_record(panel[k], 0, 20),
            "late_panel": k1_record(panel[0], M_LOC - B, 50)},
        "wy_apply": {
            "late_panel": shape_record("wy_apply", (Y, T, A[..., late:]),
                                       wy_cost(P, M_LOC, B, LATE_W), wy_library, 20),
            "one_lane": shape_record("wy_apply", (Y[k], T[k], A[k]),
                                     wy_cost(1, M_LOC, B, N), wy_library, 20)},
        "stacked_apply": {
            "late_panel": shape_record("stacked_apply", (Y2, T2, Ctl, Cbl),
                                       sa_cost(P, B, LATE_W), sa_library, 50),
            "one_lane": shape_record("stacked_apply", (Y2[k], T2[k], Ct[k], Cb[k]),
                                     sa_cost(1, B, N), sa_library, 50)},
    }
    del Ctl, Cbl

    records = []
    for name, c in cases.items():
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        err, scaled = max_err(as_tuple(got), as_tuple(want))
        del got, want
        check(scaled <= rtol, f"{name}: scaled error {scaled} over tolerance {rtol}")
        ms = time_ms(c["run"], c["reps"])
        slow_plain = name in ("panel_qr", "panel_qr_apply", "fused_panel")
        plain_ms = time_ms(c["plain"], 1 if slow_plain else c["reps"])
        bms, by = bound_ms(c["flops"], c["nbytes"])
        source, replaces = KERNELS[name]
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, scaled_err=scaled,
                   tolerance=rtol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by,
                   library_ms=time_ms(c["lib"], c["reps"]) if "lib" in c else None)
        rec["device_ms"] = device_ms(c["run"], c["reps"], name + "_kernel")
        if "lib" in c:
            rec["library_device_ms"] = device_ms(c["lib"], c["reps"])
        if "stepped" in c:
            # no single PyTorch call computes K5 or K6: the yardstick is the
            # stepped kernels doing the same work
            rec["stepped_ms"] = time_ms(c["stepped"], c["reps"])
            rec["stepped_route"] = c["stepped_route"]
        if name == "stacked_qr":
            rec["smem_bytes"] = tsa.smem_bytes(B)
            rec["pair_bitwise"] = pair_bitwise
        if name == "fused_panel":
            bn = backend.tile_bn(P, N, backend.sm_count(0))
            rec["smem_bytes"] = tfs.smem_bytes(M_LOC, B, bn)
            rec["blocks_per_sm"] = tfs.blocks_per_sm(M_LOC, B, bn)
        if name in other_shapes:
            if name in bn_bitwise:
                rec["bn"] = backend.tile_bn(P, N, backend.sm_count(0))
                rec["bn_bitwise"] = bn_bitwise[name]
            rec.update(other_shapes[name])
        rec["ptxas"] = {k: v for k, v in ptxas(source, name + "_kernel").items()
                        if "bf16" not in k}
        emit({"kernel": rec})
        records.append(rec)
    return records


def gram_error(A_flat64: torch.Tensor, R: torch.Tensor) -> float:
    G = A_flat64.T @ A_flat64
    R64 = R.double()
    return float((R64.T @ R64 - G).abs().max() / G.abs().max())


def sweep_phase(A: torch.Tensor, rng):
    """The slice-1 main path, launch counters at 0 before it; returns the
    launches, the sweep's seconds and its (R, factors, bundles)."""
    comm = SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    check(all(launches[op] > 0 for op in STEPPED),
          f"a kernel was not launched by the sweep: {launches}")
    check(bool((res.R == res.R[:1]).all()), "R is not replicated bitwise")
    m = P * M_LOC
    flops = 2.0 * m * N * N - 2.0 * N ** 3 / 3.0
    A64 = A.reshape(-1, N).double()
    R0 = res.R[0]
    gram = gram_error(A64, R0)
    check(gram <= GRAM_TOL, f"Gram identity: {gram} > {GRAM_TOL}")
    QtA = caqr_apply_qt(A, res.factors, comm).reshape(-1, N)
    rmax = float(R0.abs().max())
    top = float((QtA[:N] - R0).abs().max()) / rmax
    rest = float(QtA[N:].abs().max()) / rmax
    del QtA
    check(max(top, rest) <= QTA_TOL, f"Q^T A != [R; 0]: {top}, {rest}")
    rhs = block_row_layout(rng.standard_normal((m, 1)).astype(np.float32), P)
    x = caqr_lstsq(A, rhs, comm, B, result=res._replace(bundles=None)).double()
    b64 = rhs.reshape(-1, 1).double()
    x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
    lst = float((x - x_ne).norm() / x_ne.norm())
    check(lst <= LSTSQ_TOL, f"lstsq vs normal equations: {lst}")
    out = dict(shape=[m, N], P=P, b=B, panels=N // B, levels=L,
               seconds=seconds, gflops=flops / seconds / 1e9,
               launches=launches, gram_rel_err=gram, qta_top_rel_err=top,
               qta_rest_rel=rest, lstsq_rel_err=lst,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"sweep": out})
    PATH_LAUNCHES["sweep"] = dict(launches)
    return launches, seconds, res


def profile_phase(A: torch.Tensor, sweep_seconds: float) -> None:
    """Device time by kernel over the same sweep run once more under
    torch.profiler: where the sweep's time goes. The tracer slows the host
    several-fold, so the busy share is taken against the unprofiled
    sweep's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        caqr_factorize(A, SimComm(P), B, use_scan=False, collect_bundles=True)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, other = device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) + other
    emit({"profile": dict(profiled_wall_ms=wall_ms, kernel_ms=by_kernel,
                          other_device_ms=other, device_ms=busy,
                          device_busy_share=busy / (sweep_seconds * 1e3))})


def device_time_by_kernel(prof):
    """(ms of K1-K4 by name, ms of every other device op) in a
    torch.profiler trace."""
    by_kernel = {name: 0.0 for name in STEPPED}
    other = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        key = e.key.removeprefix("void ")  # templated kernels carry it
        name = next((k for k in STEPPED if key.startswith(k + "_kernel")), None)
        if name is None:
            other += us / 1e3
        else:
            by_kernel[name] += us / 1e3
    return by_kernel, other


def fused_leaf_phase(A: torch.Tensor) -> dict:
    """K5's path: the fused leaf entry point on the first panel's window,
    counters at 0 before it; bit-equal to the stepped leaf (K1 then K2)."""
    comm = SimComm(P)
    _c0, _t, row_start, _act = panel_geometry(comm, 0, B, M_LOC)
    backend.reset_launches()
    wy, C, Cp = householder.panel_qr_apply(A, row_start, B)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    wy1 = householder.householder_qr_masked(A[..., :B], row_start)
    C1 = householder.apply_qt(wy1.Y, wy1.T, A)
    same = same_bits((*wy, C, Cp), (*wy1, C1, C1[:, :B]))
    emit({"fused_leaf": dict(window=list(A.shape), launches=launches,
                             bitwise_equal_stepped=same)})
    PATH_LAUNCHES["fused_leaf"] = launches
    check(launches["panel_qr_apply"] == 1 and
          all(launches[op] == 0 for op in STEPPED),
          f"fused leaf launches: {launches}")
    check(same, "fused leaf differs from the stepped leaf")
    return launches


def states_equal(a: sm.SweepState, b: sm.SweepState) -> bool:
    fa, fb = sm.flat_arrays(a), sm.flat_arrays(b)
    return (a.cursor == b.cursor and fa.keys() == fb.keys()
            and all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
                    for k in fa))


def lockstep(A: torch.Tensor, b: int = B) -> int:
    """Fused and stepped sweeps at panel width ``b`` side by side; checks
    the states bit for bit at every panel boundary and the finalized
    outputs; returns the number of boundaries compared."""
    comm = SimComm(P)
    s_f = s_s = sm.initial_sweep_state(comm, A, b)
    pts = sm.panel_points(s_s.geom)
    n = 0
    while s_f.cursor is not None:
        s_f = sm.run_panel_fused(comm, s_f)
        s_s = sm.run_steps(comm, s_s, pts)
        check(states_equal(s_f, s_s),
              f"fused state differs from stepped at boundary {s_s.cursor}")
        n += 1
    check(same_bits(flat_result(sm.finalize(comm, s_f)),
                    flat_result(sm.finalize(comm, s_s))),
          "fused and stepped finalize differ")
    return n


def flat_result(res) -> tuple:
    R, factors, bundles = res[:3]
    return (R, *factors, *bundles)


def timed_sweep(A: torch.Tensor, fused: bool, b: int = B):
    """One state-machine sweep at panel width ``b`` to completion with
    finalize, counters and peak memory reset before it; returns (result,
    seconds, launches, GB): the peak is counted above what was allocated
    before the sweep."""
    comm = SimComm(P)
    s = sm.initial_sweep_state(comm, A, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    if fused:
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
    else:
        s = sm.run_steps(comm, s)
    out = sm.finalize(comm, s)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del s
    return (out, seconds, dict(backend.LAUNCHES),
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def state_machine_phase(A: torch.Tensor, want: tuple) -> dict:
    """K6's path: the full-width sweep stepped and fused, each alone
    (seconds, launches, peak memory) and bit-equal to the sweep's
    outputs, then side by side, equal at every panel boundary."""
    res_s, sec_s, launch_s, mem_s = timed_sweep(A, fused=False)
    ok_s = same_bits(flat_result(res_s), want)
    del res_s
    res_f, sec_f, launch_f, mem_f = timed_sweep(A, fused=True)
    ok_f = same_bits(flat_result(res_f), want)
    del res_f
    boundaries = lockstep(A)
    PATH_LAUNCHES["state_machine_stepped"] = launch_s
    PATH_LAUNCHES["state_machine_fused"] = launch_f
    emit({"state_machine": dict(
        shape=[P * M_LOC, N], stepped_seconds=sec_s, fused_seconds=sec_f,
        stepped_launches=launch_s, fused_launches=launch_f,
        stepped_peak_mem_gb_above_live=mem_s,
        fused_peak_mem_gb_above_live=mem_f,
        stepped_equals_sweep=ok_s, fused_equals_sweep=ok_f,
        boundaries_bitwise=boundaries)})
    check(ok_s, "stepped state machine differs from caqr_factorize")
    check(ok_f, "fused sweep differs from caqr_factorize")
    check(launch_f["fused_panel"] == N // B and
          all(launch_f[op] == 0 for op in STEPPED),
          f"fused sweep launches: {launch_f}")
    check(all(launch_s[op] > 0 for op in STEPPED) and
          launch_s["fused_panel"] == 0, f"stepped launches: {launch_s}")
    return launch_f


def kill_check(A: torch.Tensor, comm, kills: dict, want: tuple,
               b: int = B) -> dict:
    """ft_caqr_sweep at panel width ``b`` under ``kills`` ({point: lane});
    bit-equal to ``want``, one single-source event per kill."""
    sched = FailureSchedule(events={pt: [lane] for pt, lane in kills.items()})
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    got = ft_caqr_sweep(A, comm, b, schedule=sched)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same = same_bits(flat_result(got), want)
    events = [dict(point=list(e.point), lane=e.lane, reads=e.reads,
                   rebuild_seconds=e.elapsed_s) for e in got.events]
    check([(tuple(e["point"]), e["lane"]) for e in events] == list(kills.items()),
          f"events {events} do not match the kills {kills}")
    check(all(e["lane"] not in e["reads"].values() for e in events),
          "a rebuild read from the dead lane")
    check(same, "the FT sweep with kills differs from the failure-free sweep")
    return dict(seconds=seconds, events=events, bitwise_equal=same,
                launches=dict(backend.LAUNCHES), ledger=ledger(got.events))


def ledger(events) -> list:
    """(point, lane, reads) of each RecoveryEvent."""
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def ft_driver_phase(A: torch.Tensor, want: tuple) -> dict:
    """The scheduled FT sweep with the four kills and, for the fused online
    run, with the same lanes killed at those panels' ends; returns both
    event ledgers."""
    out = kill_check(A, SimComm(P), KILLS, want)
    ends = kill_check(A, SimComm(P), PANEL_END_KILLS, want)
    PATH_LAUNCHES["ft_driver"] = out["launches"]
    ledgers = {"kills": out.pop("ledger"),
               "panel_end_kills": ends.pop("ledger")}
    emit({"ft_driver": dict(shape=[P * M_LOC, N], **out,
                            panel_end_kills=dict(
                                seconds=ends["seconds"],
                                events=ends["events"]))})
    return ledgers


BF16 = torch.bfloat16
PEAK_BF16 = 989e12     # FLOP/s, H100 SXM dense bf16 (tensor cores)
BF16_GRAM_TOL = 0.1    # float64 Gram residual of the bf16 sweep's R
# the bf16 kernels' sources (K5/K6's bf16 instances are a file of their own)
BF16_SOURCES = {**{op: src for op, (src, _) in KERNELS.items()},
                "panel_qr_apply": "src/repro_torch/csrc/fused_panel_bf16.cu",
                "fused_panel": "src/repro_torch/csrc/fused_panel_bf16.cu"}
# each bf16 path's bf16 launches (backend.BF16_LAUNCHES), by path
PATH_LAUNCHES_BF16 = {}
# above 128 columns: each op's bf16 source and the kernel its records time
# (the profiler's name prefix, the ptxas log's name)
BF16_WIDE = {
    "panel_qr": ("src/repro_torch/csrc/panel_qr_wide_bf16.cu",
                 "panel_qr_wide_bf16_global_kernel"),
    "wy_apply": ("src/repro_torch/csrc/wide_bf16.cu", "wide_gemm_kernel"),
    "stacked_qr": ("src/repro_torch/csrc/panel_qr_wide_bf16.cu",
                   "panel_qr_wide_bf16_kernel"),
    "stacked_apply": ("src/repro_torch/csrc/wide_bf16.cu", "wide_gemm_kernel"),
    "panel_qr_apply": ("src/repro_torch/csrc/fused_wide_bf16.cu",
                       "fused_wide_bf16_kernel"),
    "fused_panel": ("src/repro_torch/csrc/fused_wide_bf16.cu",
                    "fused_wide_bf16_kernel"),
}
# the f32 wide sweep's ledger under WIDE_KILLS (wide_sweeps), which the bf16
# sweep at b = WIDE_B must reproduce
WIDE_LEDGER = {}


def widened(x, dtype=torch.float32):
    return tuple(t.to(dtype) for t in as_tuple(x))


def held_bf16(name: str, got: tuple, want: tuple, want64: tuple) -> dict:
    """Each bf16 output against the plain version at bf16 (``want``), within
    ref.tolerances(bf16) scaled by max(1, |plain|). The plain version's
    column loop runs in bf16, and where a pivot's entry is below bf16's
    round-off of its column (|x0| < 2^-8 ||x||: its sign is not fixed at
    bf16) it can choose the other reflector, a different valid QR whose Y,
    T and R row differ from the kernel's by O(1); its K4 rounds W before
    C_bot - Y2 W. The kernel keeps f32 state, as the JAX package's kernels
    accumulate in f32. So an output off its bf16 plain version passes only
    where that plain version is itself off the plain version in float64 on
    the widened inputs (``want64``) by more than the tolerance, and the
    kernel is within the tolerance of the float64 one. Returns the errors
    against what each output was held to (max_abs_err, scaled_err), against
    the bf16 and the float64 plain versions, and the outputs held to
    float64."""
    tol = ref.tolerances(BF16)[0]
    held, on64 = [], []
    for i, (g, w, w64) in enumerate(zip(got, want, want64)):
        err, e = max_err((g.float(),), (w.float(),))
        err64, e64 = max_err((g.double(),), (w64,))
        if e > tol:
            _, off = max_err((w.double(),), (w64,))
            check(off > tol and e64 <= tol,
                  f"{name}: bf16 output {i} scaled error {e} over {tol} "
                  f"(float64 plain: {e64}; bf16 plain off float64 by {off})")
            on64.append(dict(output=i, plain_bf16_scaled_err=e,
                             float64_scaled_err=e64, plain_off_float64=off))
            err, e = err64, e64
        held.append((err, e))
    return dict(max_abs_err=max(a for a, _ in held),
                scaled_err=max(e for _, e in held),
                plain_bf16_scaled_err=max_err(widened(got), widened(want))[1],
                float64_scaled_err=max_err(widened(got, torch.float64), want64)[1],
                held_to_float64=on64)


def bf16_record(name: str, run, plain, plain64, cost: tuple, reps: int, *,
                f32=None, stepped=None, lane=None, lib=None, lib_route=None,
                slow_plain: bool = False, twin=None, wide_b: bool = False,
                witness=None, split=None) -> dict:
    """One bf16 kernel at the first panel's shapes: ``f32`` (K1, K3) the f32
    kernel on the widened inputs, whose outputs rounded once must equal the
    bf16 kernel's bit for bit; ``witness`` and ``split`` (K2, K4, whose
    products run on wgmma, csrc/wgmma_bf16.cuh) that f32 kernel and the
    split emulation (``ref.wy_apply_split``, ``ref.stacked_apply_split``):
    each output within one bf16 ulp of the emulation at the larger of its
    magnitude and its terms' (``ref.bf16_ulp_ok``),
    and its float64 scaled error at most 1.25 x the witness's rounded
    outputs' + 1e-3; ``stepped`` (K5) the stepped bf16 kernels,
    equal bit for bit; ``lane`` (k, one-lane call), equal to lane k of the
    P-lane launch; each output within ref.tolerances(bf16) of the plain
    version on the card, scaled by max(1, |plain|) (``held_bf16``;
    ``plain64`` the plain version in float64 on the widened inputs); timed
    (events and device alone) beside the plain version, the f32 twin
    (``f32``, or ``twin`` where the bf16 kernel is not its rounding: K5/K6),
    the library call and the bound at 989 TFLOP/s and 2 bytes an element.
    ``wide_b``: a kernel above 128 columns (``BF16_WIDE``)."""
    got = as_tuple(run())
    torch.cuda.synchronize()
    source, kernel = BF16_WIDE[name] if wide_b else (BF16_SOURCES[name],
                                                     name + "_kernel")
    rec = dict(name=f"{name}_bf16" + ("_wide" if wide_b else ""), op=name,
               dtype="bfloat16", route="cuda", source=source,
               replaces=KERNELS[name][1], launches=0,
               engine=backend.products_report()[name])
    check(rec["engine"] == backend.product_engine(name, BF16),
          f"{name}: bf16 products ran on {rec['engine']}")
    witness64 = None
    if witness is not None:
        check(rec["engine"] == backend.ENGINE_WGMMA,
              f"{name}: bf16 products not on wgmma")
        outs, scales = split()
        rec["emulation_ulp_ok"] = all(
            ref.bf16_ulp_ok(g, e, sc)
            for g, e, sc in zip(got, as_tuple(outs), as_tuple(scales)))
        del outs, scales
        check(rec["emulation_ulp_ok"],
              f"{name}: bf16 kernel off its split emulation by over one ulp")
        witness64 = max_err(widened(tuple(x.to(BF16) for x in as_tuple(witness())),
                                    torch.float64), as_tuple(plain64()))[1]
        rec["witness_float64_scaled_err"] = witness64
        rec["f32_ms"] = time_ms(witness, reps)
    if f32 is not None:
        rounded = tuple(x.to(BF16) for x in as_tuple(f32()))
        rec["f32_rounded_bitwise"] = same_bits(got, rounded)
        check(rec["f32_rounded_bitwise"],
              f"{name}: bf16 kernel != f32 kernel rounded once")
        rec["f32_ms"] = time_ms(f32, reps)
    if twin is not None:
        rec["f32_ms"] = time_ms(twin, reps)
    if stepped is not None:
        rec["stepped_bitwise"] = same_bits(got, stepped())
        check(rec["stepped_bitwise"], f"{name}: bf16 differs from the stepped kernels")
        rec["stepped_ms"] = time_ms(stepped, reps)
    if lane is not None:
        k, one = lane
        rec["lane_bitwise"] = all(torch.equal(g[k], o)
                                  for g, o in zip(got, as_tuple(one())))
        check(rec["lane_bitwise"], f"{name}: bf16 lane bits depend on the launch")
    rec.update(held_bf16(name, got, as_tuple(plain()), as_tuple(plain64())))
    if witness64 is not None:
        check(rec["float64_scaled_err"] <= 1.25 * witness64 + 1e-3,
              f"{name}: bf16 float64 error {rec['float64_scaled_err']} over "
              f"1.25 x the witness's {witness64} + 1e-3")
    del got
    bms, by = bound_ms(*cost, peak=PEAK_BF16)
    rec.update(tolerance=ref.tolerances(BF16)[0], ms=time_ms(run, reps),
               device_ms=device_ms(run, reps, kernel),
               plain_ms=time_ms(plain, 1 if slow_plain else reps),
               bound_ms=bms, bound_by=by,
               library_ms=time_ms(lib, reps) if lib is not None else None,
               library_route=lib_route,
               ptxas={k: v for k, v in ptxas(source, kernel).items()
                      if wide_b or "bf16" in k})
    return rec


def bf16_kernel_records(Ab: torch.Tensor) -> list:
    """K1-K6 at bf16 on the first panel's data of the bf16 sweep, K2 and
    K4 also at a late panel's window (w = LATE_W)."""
    eb = 2.0  # bytes an element
    k = P - 3
    panel = Ab[..., :B].contiguous()
    Y, T, R = ops.panel_qr(panel, 0)
    rows = [i ^ 1 for i in range(P)]
    R_top, R_bot = R.contiguous(), R[rows].contiguous()
    Y2, T2, _ = ops.stacked_qr(R_top, R_bot)
    Ct = ops.wy_apply(Y, T, Ab)[:, :B].contiguous()
    Cb = Ct[rows].contiguous()
    late = N - LATE_W
    Ctl, Cbl = Ct[..., :LATE_W].contiguous(), Cb[..., :LATE_W].contiguous()
    panel32, stack32 = panel.float(), torch.cat([R_top, R_bot], 1).float()
    # the f32 twins' inputs, widened once outside the timed calls
    A32, Y32, T32, Rt32, Rb32, Y2_32, T2_32, Ct32, Cb32, Ctl32, Cbl32 = widened(
        (Ab, Y, T, R_top, R_bot, Y2, T2, Ct, Cb, Ctl, Cbl))

    def f64(fn, *xs, **kw):  # the plain version in float64 on widened inputs
        return lambda: fn(*widened(xs, torch.float64), **kw)

    recs = [
        bf16_record("panel_qr", lambda: ops.panel_qr(panel, 0),
                    lambda: ref.panel_qr(panel, 0),
                    f64(ref.panel_qr, panel, row_start=0),
                    leaf_cost(P, M_LOC, B, 0, eb),
                    20, f32=lambda: ops.panel_qr(panel32, 0),
                    lane=(k, lambda: ops.panel_qr(panel[k], 0)),
                    lib=lambda: torch.geqrf(panel32),
                    lib_route="torch.geqrf on the panel widened to f32 "
                              "(geqrf takes no bf16)", slow_plain=True),
        bf16_record("wy_apply", lambda: ops.wy_apply(Y, T, Ab),
                    lambda: ref.wy_apply(Y, T, Ab), f64(ref.wy_apply, Y, T, Ab),
                    wy_cost(P, M_LOC, B, N, eb),
                    10, witness=lambda: ops.wy_apply(Y32, T32, A32),
                    split=lambda: ref.wy_apply_split(Y, T, Ab, scale=True),
                    lane=(k, lambda: ops.wy_apply(Y[k], T[k], Ab[k])),
                    lib=lambda: wy_library(Y, T, Ab),
                    lib_route="the torch.matmul chain in bf16"),
        bf16_record("stacked_qr", lambda: ops.stacked_qr(R_top, R_bot),
                    lambda: ref.stacked_qr(R_top, R_bot),
                    f64(ref.stacked_qr, R_top, R_bot),
                    (P * float(B ** 3), eb * P * 5 * B * B), 10,
                    f32=lambda: ops.stacked_qr(Rt32, Rb32),
                    lane=(k, lambda: ops.stacked_qr(R_top[k], R_bot[k])),
                    lib=lambda: torch.geqrf(stack32),
                    lib_route="torch.geqrf on the stack widened to f32 "
                              "(geqrf takes no bf16)"),
        bf16_record("stacked_apply", lambda: ops.stacked_apply(Y2, T2, Ct, Cb),
                    lambda: ref.stacked_apply(Y2, T2, Ct, Cb),
                    f64(ref.stacked_apply, Y2, T2, Ct, Cb),
                    sa_cost(P, B, N, eb), 10,
                    witness=lambda: ops.stacked_apply(Y2_32, T2_32, Ct32, Cb32),
                    split=lambda: ref.stacked_apply_split(Y2, T2, Ct, Cb, scale=True),
                    lane=(k, lambda: ops.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k])),
                    lib=lambda: sa_library(Y2, T2, Ct, Cb),
                    lib_route="the torch.matmul chain in bf16"),
    ]
    recs[1]["late_panel"] = bf16_record(
        "wy_apply", lambda: ops.wy_apply(Y, T, Ab[..., late:]),
        lambda: ref.wy_apply(Y, T, Ab[..., late:]),
        f64(ref.wy_apply, Y, T, Ab[..., late:]),
        wy_cost(P, M_LOC, B, LATE_W, eb), 20,
        witness=lambda: ops.wy_apply(Y32, T32, A32[..., late:]),
        split=lambda: ref.wy_apply_split(Y, T, Ab[..., late:], scale=True),
        lib=lambda: wy_library(Y, T, Ab[..., late:]),
        lib_route="the torch.matmul chain in bf16")
    recs[3]["late_panel"] = bf16_record(
        "stacked_apply", lambda: ops.stacked_apply(Y2, T2, Ctl, Cbl),
        lambda: ref.stacked_apply(Y2, T2, Ctl, Cbl),
        f64(ref.stacked_apply, Y2, T2, Ctl, Cbl), sa_cost(P, B, LATE_W, eb),
        50, witness=lambda: ops.stacked_apply(Y2_32, T2_32, Ctl32, Cbl32),
        split=lambda: ref.stacked_apply_split(Y2, T2, Ctl, Cbl, scale=True),
        lib=lambda: sa_library(Y2, T2, Ctl, Cbl),
        lib_route="the torch.matmul chain in bf16")
    for sub in (recs[1]["late_panel"], recs[3]["late_panel"]):
        for key in ("name", "op", "dtype", "route", "source", "replaces",
                    "launches", "ptxas"):
            sub.pop(key)
    del Ctl, Cbl, A32, Y32, T32, Rt32, Rb32, Y2_32, T2_32, Ct32, Cb32, Ctl32, Cbl32

    def k1_k2():
        Yl, Tl, Rl = ops.panel_qr(Ab[..., :B], 0)
        C = ops.wy_apply(Yl, Tl, Ab)
        return Yl, Tl, Rl, C, C[:, :B]

    leaf_flops = 3.0 * M_LOC * B * B - B ** 3 / 3.0
    apply_flops = 4.0 * M_LOC * B * N + B * B * N
    recs.append(bf16_record(
        "panel_qr_apply", lambda: ops.panel_qr_apply(Ab, 0, B),
        lambda: ref.panel_qr_apply(Ab, 0, B),
        f64(ref.panel_qr_apply, Ab, row_start=0, b=B),
        (P * (leaf_flops + apply_flops),
         eb * P * (2 * M_LOC * N + M_LOC * B + 2 * B * B + B * N)), 3,
        stepped=k1_k2, lane=(k, lambda: ops.panel_qr_apply(Ab[k], 0, B)),
        slow_plain=True))
    comm = SimComm(P)
    s0 = sm.initial_sweep_state(comm, Ab, B)
    pts = sm.panel_points(s0.geom)
    recs.append(bf16_record(
        "fused_panel",
        lambda: ops.fused_panel(Ab, 0, b=B, m_loc_pad=M_LOC, levels=L),
        lambda: ref.fused_panel(Ab, 0, b=B, m_loc_pad=M_LOC, levels=L),
        f64(ref.fused_panel, Ab, k=0, b=B, m_loc_pad=M_LOC, levels=L),
        (P * (leaf_flops + apply_flops + L * (B ** 3 + 3.0 * B * B * N)),
         eb * P * (2 * M_LOC * N + M_LOC * B + (3 + 2 * L) * B * B
                   + (1 + 3 * L) * B * N)), 3, slow_plain=True))
    # no single PyTorch call computes K5 or K6: the yardstick is the stepped
    # bf16 kernels doing the same work
    recs[-1]["stepped_ms"] = time_ms(lambda: sm.run_steps(comm, s0, pts), 3)
    recs[-1]["stepped_route"] = "the stepped bf16 panel (K1, 3 x K3, K2, 3 x K4)"
    recs[-2]["stepped_route"] = "K1+K2 at bf16 (panel_qr, wy_apply)"
    return recs


def bf16_phase(A: torch.Tensor, ledgers: dict) -> list:
    """The sweep of a bf16 matrix (the tall matrix cast to bf16) through the
    bf16 kernels K1-K6 at b = 128; returns their records."""
    Ab = A.to(BF16)
    records = bf16_kernel_records(Ab)
    comm = SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = caqr_factorize(Ab, comm, B, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.BF16_LAUNCHES)
    PATH_LAUNCHES_BF16["bf16_sweep"] = launches
    check(all(launches[op] > 0 for op in STEPPED)
          and launches == backend.LAUNCHES,
          f"a bf16 kernel was not launched by the bf16 sweep: {launches}, "
          f"all launches {backend.LAUNCHES}")
    check(res.R.dtype == BF16 and bool((res.R == res.R[:1]).all()),
          "bf16 R is not replicated bitwise")
    want = flat_result(res)
    A64 = Ab.reshape(-1, N).double()
    gram = gram_error(A64, res.R[0])
    # the floor: the f32 sweep of the same (widened) matrix, R rounded once
    floor = gram_error(A64, caqr_factorize(Ab.float(), comm, B,
                                           use_scan=False).R[0].to(BF16))
    del A64, res
    check(gram <= BF16_GRAM_TOL, f"bf16 Gram residual {gram} > {BF16_GRAM_TOL}")
    kill = kill_check(Ab, SimComm(P), KILLS, want)
    PATH_LAUNCHES_BF16["bf16_kill"] = dict(backend.BF16_LAUNCHES)
    check(kill["ledger"] == ledgers["kills"],
          "the bf16 kill ledger differs from the f32 sweep's")
    res_s, sec_s, _, _ = timed_sweep(Ab, fused=False)
    PATH_LAUNCHES_BF16["bf16_stepped"] = dict(backend.BF16_LAUNCHES)
    ok_s = same_bits(flat_result(res_s), want)
    del res_s
    res_f, sec_f, _, _ = timed_sweep(Ab, fused=True)
    launch_f = PATH_LAUNCHES_BF16["bf16_fused"] = dict(backend.BF16_LAUNCHES)
    ok_f = same_bits(flat_result(res_f), want)
    del res_f
    check(ok_s and ok_f, f"bf16 state machine differs from caqr_factorize: "
                         f"stepped {ok_s}, fused {ok_f}")
    check(launch_f["fused_panel"] == N // B and
          all(launch_f[op] == 0 for op in STEPPED),
          f"bf16 fused sweep launches: {launch_f}")
    # K5's path: the fused leaf entry on the first window, bit-equal to K1
    # then K2
    _c0, _t, row_start, _act = panel_geometry(comm, 0, B, M_LOC)
    backend.reset_launches()
    wy, C, Cp = householder.panel_qr_apply(Ab, row_start, B)
    torch.cuda.synchronize()
    PATH_LAUNCHES_BF16["bf16_fused_leaf"] = dict(backend.BF16_LAUNCHES)
    wy1 = householder.householder_qr_masked(Ab[..., :B], row_start)
    C1 = householder.apply_qt(wy1.Y, wy1.T, Ab)
    leaf_same = same_bits((*wy, C, Cp), (*wy1, C1, C1[:, :B]))
    check(leaf_same and PATH_LAUNCHES_BF16["bf16_fused_leaf"]["panel_qr_apply"] == 1,
          "bf16 fused leaf differs from the stepped leaf or did not launch K5")
    del wy, C, Cp, wy1, C1
    probe = backend.probe_report()
    check(all(v["engine"] == backend.ENGINE_CUDA for v in probe.values()),
          f"an op's last engine is not the CUDA kernel: {probe}")
    emit({"bf16": dict(
        shape=[P * M_LOC, N], P=P, b=B, dtype="bfloat16", sweep_seconds=seconds,
        launches=launches, gram_rel_err=gram, gram_floor_f32_rounded=floor,
        gram_tol=BF16_GRAM_TOL, ft_kills=dict(
            seconds=kill["seconds"], events=kill["events"],
            bitwise_equal=kill["bitwise_equal"],
            ledger_equals_f32=True),
        state_machine=dict(stepped_seconds=sec_s, fused_seconds=sec_f,
                           stepped_equals_sweep=ok_s, fused_equals_sweep=ok_f,
                           fused_launches=launch_f),
        fused_leaf_bitwise_equal_stepped=leaf_same, probe=probe)})
    return records


def bf16_wide_kernel_records(Ab: torch.Tensor) -> list:
    """K1-K6 at bf16 above 128 columns on the bf16 sweep's first panel at
    b = WIDE_B (K1 also at the last panel's row starts): each held to its
    bitwise oracle (K1-K4 the f32 kernel on the widened inputs rounded
    once, K5 K1 then K2, K6 the stepped bf16 panel), a lane alone to its
    lane, and to the plain version through ``held_bf16``; timed beside its
    f32 twin, the plain version, the library call (or for K5/K6 the stepped
    bf16 kernels) and the bound."""
    b, eb, k = WIDE_B, 2.0, P - 3
    comm = SimComm(P)
    panel = Ab[..., :b].contiguous()
    rs_last = panel_geometry(comm, N // b - 1, b, M_LOC)[2]
    Y, T, R = ops.panel_qr(panel, 0)
    rows = [i ^ 1 for i in range(P)]
    R_top, R_bot = R.contiguous(), R[rows].contiguous()
    Y2, T2, _ = ops.stacked_qr(R_top, R_bot)
    Ct = ops.wy_apply(Y, T, Ab)[:, :b].contiguous()
    Cb = Ct[rows].contiguous()
    stack32 = torch.cat([R_top, R_bot], 1).float()
    # the f32 twins' inputs, widened once outside the timed calls
    panel32, A32, Y32, T32, Rt32, Rb32, Y2_32, T2_32, Ct32, Cb32 = widened(
        (panel, Ab, Y, T, R_top, R_bot, Y2, T2, Ct, Cb))

    def f64(fn, *xs, **kw):  # the plain version in float64 on widened inputs
        return lambda: fn(*widened(xs, torch.float64), **kw)

    late = [leaf_cost(1, M_LOC, b, int(r), eb) for r in rs_last]
    recs = [
        bf16_record("panel_qr", lambda: ops.panel_qr(panel, 0),
                    lambda: ref.panel_qr(panel, 0),
                    f64(ref.panel_qr, panel, row_start=0),
                    leaf_cost(P, M_LOC, b, 0, eb), 5,
                    f32=lambda: ops.panel_qr(panel32, 0),
                    lane=(k, lambda: ops.panel_qr(panel[k], 0)),
                    lib=lambda: torch.geqrf(panel32),
                    lib_route="torch.geqrf on the panel widened to f32 "
                              "(geqrf takes no bf16)", slow_plain=True,
                    wide_b=True),
        bf16_record("wy_apply", lambda: ops.wy_apply(Y, T, Ab),
                    lambda: ref.wy_apply(Y, T, Ab), f64(ref.wy_apply, Y, T, Ab),
                    wy_cost(P, M_LOC, b, N, eb), 5,
                    witness=lambda: ops.wy_apply(Y32, T32, A32),
                    split=lambda: ref.wy_apply_split(Y, T, Ab, scale=True),
                    lane=(k, lambda: ops.wy_apply(Y[k], T[k], Ab[k])),
                    lib=lambda: wy_library(Y, T, Ab),
                    lib_route="the torch.matmul chain in bf16", wide_b=True),
        bf16_record("stacked_qr", lambda: ops.stacked_qr(R_top, R_bot),
                    lambda: ref.stacked_qr(R_top, R_bot),
                    f64(ref.stacked_qr, R_top, R_bot),
                    (P * float(b ** 3), eb * P * 5 * b * b), 10,
                    f32=lambda: ops.stacked_qr(Rt32, Rb32),
                    lane=(k, lambda: ops.stacked_qr(R_top[k], R_bot[k])),
                    lib=lambda: torch.geqrf(stack32),
                    lib_route="torch.geqrf on the stack widened to f32 "
                              "(geqrf takes no bf16)", wide_b=True),
        bf16_record("stacked_apply", lambda: ops.stacked_apply(Y2, T2, Ct, Cb),
                    lambda: ref.stacked_apply(Y2, T2, Ct, Cb),
                    f64(ref.stacked_apply, Y2, T2, Ct, Cb),
                    sa_cost(P, b, N, eb), 10,
                    witness=lambda: ops.stacked_apply(Y2_32, T2_32, Ct32, Cb32),
                    split=lambda: ref.stacked_apply_split(Y2, T2, Ct, Cb, scale=True),
                    lane=(k, lambda: ops.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k])),
                    lib=lambda: sa_library(Y2, T2, Ct, Cb),
                    lib_route="the torch.matmul chain in bf16", wide_b=True),
    ]
    rs0 = int(rs_last[0])
    recs[0]["last_panel"] = bf16_record(
        "panel_qr", lambda: ops.panel_qr(panel, rs_last),
        lambda: ref.panel_qr(panel, rs_last),
        f64(ref.panel_qr, panel, row_start=rs_last),
        tuple(map(sum, zip(*late))), 5,
        f32=lambda: ops.panel_qr(panel32, rs_last),
        lane=(0, lambda: ops.panel_qr(panel[0], rs0)),
        lib=lambda: (torch.geqrf(panel32[1:]), torch.geqrf(panel32[0, rs0:])),
        lib_route="torch.geqrf on the widened panel below each row start",
        slow_plain=True, wide_b=True)
    recs[0]["last_panel"]["row_start"] = rs_last.tolist()
    for key in ("name", "op", "dtype", "route", "source", "replaces", "launches",
                "ptxas"):
        recs[0]["last_panel"].pop(key)
    del Ct, Cb, Y32, T32, Rt32, Rb32, Y2_32, T2_32, Ct32, Cb32, stack32

    def k1_k2():
        Yl, Tl, Rl = ops.panel_qr(Ab[..., :b], 0)
        C = ops.wy_apply(Yl, Tl, Ab)
        return Yl, Tl, Rl, C, C[:, :b]

    leaf_flops = leaf_cost(1, M_LOC, b, 0)[0]
    apply_flops = 4.0 * M_LOC * b * N + b * b * N
    recs.append(bf16_record(
        "panel_qr_apply", lambda: ops.panel_qr_apply(Ab, 0, b),
        lambda: ref.panel_qr_apply(Ab, 0, b),
        f64(ref.panel_qr_apply, Ab, row_start=0, b=b),
        (P * (leaf_flops + apply_flops),
         eb * P * (2 * M_LOC * N + M_LOC * b + 2 * b * b + b * N)), 3,
        stepped=k1_k2, lane=(k, lambda: ops.panel_qr_apply(Ab[k], 0, b)),
        twin=lambda: ops.panel_qr_apply(A32, 0, b), slow_plain=True,
        wide_b=True))
    recs[-1]["stepped_route"] = "K1+K2 at bf16 above 128 (panel_qr, wy_apply)"
    s0 = sm.initial_sweep_state(comm, Ab, b)
    pts = sm.panel_points(s0.geom)
    rec6 = bf16_record(
        "fused_panel",
        lambda: ops.fused_panel(Ab, 0, b=b, m_loc_pad=M_LOC, levels=L),
        lambda: ref.fused_panel(Ab, 0, b=b, m_loc_pad=M_LOC, levels=L),
        f64(ref.fused_panel, Ab, k=0, b=b, m_loc_pad=M_LOC, levels=L),
        (P * (leaf_flops + apply_flops + L * (b ** 3 + 3.0 * b * b * N)),
         eb * P * (2 * M_LOC * N + M_LOC * b + (3 + 2 * L) * b * b
                   + (1 + 3 * L) * b * N)), 3,
        twin=lambda: ops.fused_panel(A32, 0, b=b, m_loc_pad=M_LOC, levels=L),
        slow_plain=True, wide_b=True)
    # K6's oracle: the panel's state through run_panel_fused (one K6 launch)
    # equals it through the stepped bf16 kernels, bit for bit
    rec6["stepped_bitwise"] = states_equal(sm.run_panel_fused(comm, s0),
                                           sm.run_steps(comm, s0, pts))
    check(rec6["stepped_bitwise"], "fused_panel: bf16 above 128 differs from "
                                   "the stepped bf16 panel")
    rec6["stepped_ms"] = time_ms(lambda: sm.run_steps(comm, s0, pts), 3)
    rec6["stepped_route"] = "the stepped bf16 panel (K1, 3 x K3, K2, 3 x K4)"
    recs.append(rec6)
    del A32, panel32, s0
    for rec in recs:
        rec["b"] = b
    return recs


def bf16_wide_phase(A: torch.Tensor) -> list:
    """The tall matrix cast to bf16 at b = WIDE_B (16 panels, L = 3) through
    the bf16 kernels above 128 columns: their records, then the sweep (R
    replicated bitwise, its float64 Gram residual beside its floor), the FT
    sweep with WIDE_KILLS (bit-equal to failure-free, with the f32 wide
    ledger), the state machine stepped and fused (bit-equal to the sweep,
    K6 launched a panel) and the fused-leaf entry (K5 == K1 then K2).
    Returns the kernel records."""
    b, comm = WIDE_B, SimComm(P)
    Ab = A.to(BF16)
    records = bf16_wide_kernel_records(Ab)
    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = caqr_factorize(Ab, comm, b, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.BF16_LAUNCHES)
    sub = dict(backend.SUB_LAUNCHES)
    PATH_LAUNCHES_BF16["bf16_wide_sweep"] = launches
    check(all(launches[op] > 0 for op in STEPPED)
          and launches == backend.LAUNCHES and sub["wide_round_bf16"] > 0,
          f"a bf16 kernel was not launched by the bf16 sweep at b = {b}: "
          f"{launches}, all launches {backend.LAUNCHES}, {sub}")
    check(res.R.dtype == BF16 and bool((res.R == res.R[:1]).all()),
          "bf16 R at b = 256 is not replicated bitwise")
    want = flat_result(res)
    A64 = Ab.reshape(-1, N).double()
    gram = gram_error(A64, res.R[0])
    # the floor: the f32 sweep of the same (widened) matrix, R rounded once
    floor = gram_error(A64, caqr_factorize(Ab.float(), comm, b,
                                           use_scan=False).R[0].to(BF16))
    del A64, res
    check(gram <= BF16_GRAM_TOL, f"bf16 Gram residual at b = {b}: {gram} > "
                                 f"{BF16_GRAM_TOL}")
    kill = kill_check(Ab, SimComm(P), WIDE_KILLS, want, b=b)
    PATH_LAUNCHES_BF16["bf16_wide_kill"] = dict(backend.BF16_LAUNCHES)
    check(kill.pop("ledger") == WIDE_LEDGER["kills"],
          "the bf16 kill ledger at b = 256 differs from the f32 wide sweep's")
    res_s, sec_s, _, _ = timed_sweep(Ab, fused=False, b=b)
    PATH_LAUNCHES_BF16["bf16_wide_stepped"] = dict(backend.BF16_LAUNCHES)
    ok_s = same_bits(flat_result(res_s), want)
    del res_s
    res_f, sec_f, _, _ = timed_sweep(Ab, fused=True, b=b)
    launch_f = PATH_LAUNCHES_BF16["bf16_wide_fused"] = dict(backend.BF16_LAUNCHES)
    ok_f = same_bits(flat_result(res_f), want)
    del res_f, want
    check(ok_s and ok_f, f"bf16 state machine at b = {b} differs from "
                         f"caqr_factorize: stepped {ok_s}, fused {ok_f}")
    check(launch_f["fused_panel"] == N // b and
          all(launch_f[op] == 0 for op in STEPPED),
          f"bf16 fused sweep launches at b = {b}: {launch_f}")
    # K5's path: the fused leaf entry on the first window, bit-equal to K1
    # then K2
    _c0, _t, row_start, _act = panel_geometry(comm, 0, b, M_LOC)
    backend.reset_launches()
    wy, C, Cp = householder.panel_qr_apply(Ab, row_start, b)
    torch.cuda.synchronize()
    PATH_LAUNCHES_BF16["bf16_wide_fused_leaf"] = dict(backend.BF16_LAUNCHES)
    wy1 = householder.householder_qr_masked(Ab[..., :b], row_start)
    C1 = householder.apply_qt(wy1.Y, wy1.T, Ab)
    leaf_same = same_bits((*wy, C, Cp), (*wy1, C1, C1[:, :b]))
    check(leaf_same and
          PATH_LAUNCHES_BF16["bf16_wide_fused_leaf"]["panel_qr_apply"] == 1,
          "bf16 fused leaf at b = 256 differs from the stepped leaf or did not "
          "launch K5")
    del wy, C, Cp, wy1, C1
    probe = backend.probe_report()
    check(all(v["engine"] == backend.ENGINE_CUDA for v in probe.values()),
          f"an op's last engine is not the CUDA kernel: {probe}")
    emit({"bf16_wide": dict(
        shape=[P * M_LOC, N], P=P, b=b, panels=N // b, levels=L,
        dtype="bfloat16", sweep_seconds=seconds, launches=launches,
        sub_launches=sub, gram_rel_err=gram, gram_floor_f32_rounded=floor,
        gram_tol=BF16_GRAM_TOL, ft_kills=dict(
            seconds=kill["seconds"], events=kill["events"],
            bitwise_equal=kill["bitwise_equal"], ledger_equals_f32=True),
        state_machine=dict(stepped_seconds=sec_s, fused_seconds=sec_f,
                           stepped_equals_sweep=ok_s, fused_equals_sweep=ok_f,
                           fused_launches=launch_f),
        fused_leaf_bitwise_equal_stepped=leaf_same, probe=probe)})
    return records


class TimedScheme:
    """A coding scheme that times each ``refresh`` (the device synchronised
    before and after) and records the parity's bytes; everything else is
    the wrapped scheme's."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.f, self.joint = inner.name, inner.f, inner.joint
        self.seconds = []
        self.parity_bytes = 0

    def refresh(self, comm, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.refresh(comm, state)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.parity_bytes = max(self.parity_bytes,
                                sum(c.numel() for c in out.code))
        return out

    def decode_lanes(self, comm, state, newly, dead):
        return self.inner.decode_lanes(comm, state, newly, dead)


def online_run(A: torch.Tensor, kills: dict, b: int = B, **kw):
    """``ft_caqr_sweep_online`` on the tall cell at panel width ``b`` with a
    ``ScriptedKiller`` at ``kills`` ({point: [lanes]}), launch counters at 0
    just before it and peak memory counted above what was live; returns
    (result, the orchestrator's statistics, seconds, launches, peak GB)."""
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    res = ft_caqr_sweep_online(
        A, SimComm(P), b, fault_hooks=[ScriptedKiller(kills)],
        boundary_hooks=[lambda orch: seen.append(orch)], **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    orch = seen[-1]
    stats = dict(seconds=seconds, segments_run=orch.segments_run,
                 boundaries=orch.boundaries, poll_s=orch.poll_s,
                 recover_s=orch.recover_s,
                 peak_mem_gb_above_live=(torch.cuda.max_memory_allocated()
                                         - base) / 1e9)
    return res, stats, dict(backend.LAUNCHES)


def online_phase(A: torch.Tensor, want: tuple, ledgers: dict) -> None:
    """The online path on the tall cell: stepped and fused without a
    death; stepped with the FT driver's four kills, fused with the same
    lanes killed at those panels' ends, and stepped with double-buffered
    segments; each bit-equal to the failure-free sweep (so to the
    scheduled runs, which equal it too) with the scheduled run's event
    ledger. Then fused under MDSScheme(f=2) with
    two simultaneous non-buddy deaths at one boundary, decoded jointly."""
    kills = {pt: [lane] for pt, lane in KILLS.items()}
    ends = {pt: [lane] for pt, lane in PANEL_END_KILLS.items()}
    out = {}
    for path, k, led, kw in (
            ("online_stepped_failure_free", {}, [], {}),
            ("online_fused_failure_free", {}, [], dict(fused=True)),
            ("online_stepped", kills, ledgers["kills"], {}),
            ("online_fused", ends, ledgers["panel_end_kills"], dict(fused=True)),
            ("online_async", kills, ledgers["kills"],
             dict(async_segments=True))):
        res, stats, launches = online_run(A, k, **kw)
        same = same_bits(flat_result(res), want)
        got_ledger = ledger(res.events)
        del res
        PATH_LAUNCHES[path] = launches
        out[path] = dict(stats, bitwise_equal_scheduled=same,
                         ledger_equal_scheduled=got_ledger == led,
                         launches=launches)
        check(same, f"{path}: differs from the scheduled sweep")
        check(got_ledger == led, f"{path}: ledger {got_ledger} != {led}")
        if kw.get("fused"):
            check(launches["fused_panel"] == N // B and
                  (k or all(launches[op] == 0 for op in STEPPED)),
                  f"{path}: K6 launches {launches}")
        else:
            check(all(launches[op] > 0 for op in STEPPED)
                  and launches["fused_panel"] == 0,
                  f"{path}: launches {launches}")
    emit({"online": dict(shape=[P * M_LOC, N], **out)})

    pair = [2, 5]  # no butterfly level pairs them
    point = sweep_point(20, "trailing", L - 1)
    scheme = TimedScheme(MDSScheme(f=2))
    res, stats, launches = online_run(A, {point: pair}, fused=True,
                                      scheme=scheme)
    same = same_bits(flat_result(res), want)
    events = [dict(point=list(e.point), lane=e.lane, reads=e.reads,
                   decode_seconds=e.elapsed_s) for e in res.events]
    del res
    PATH_LAUNCHES["online_mds"] = launches
    sec = sorted(scheme.seconds)
    emit({"online_mds": dict(
        f=2, killed=pair, point=list(point), **stats,
        refresh_seconds_median=sec[len(sec) // 2],
        refresh_seconds_min=sec[0], refresh_seconds_max=sec[-1],
        refreshes=len(sec), parity_bytes_max=scheme.parity_bytes,
        events=events, bitwise_equal_failure_free=same, launches=launches)})
    check(same, "MDS joint decode differs from the failure-free sweep")
    check([e["lane"] for e in events] == pair and
          all(e["reads"].get("coded.parity1") == P + 1 for e in events),
          f"MDS events are not a joint decode: {events}")
    check(launches["fused_panel"] == N // B, f"online_mds launches {launches}")


def spmd_ranks(group, seconds: float) -> dict:
    """One spmd run's record: its seconds and each rank's report (seconds,
    launches, collectives, bytes staged through host memory and sent
    through gloo); checks that K1-K4 ran on every rank."""
    reps = group.last_reports
    for r in reps:
        check(all(r.launches[op] > 0 for op in STEPPED),
              f"rank {r.rank} did not launch K1-K4: {r.launches}")
    return dict(seconds=seconds, ranks=[r._asdict() for r in reps])


def spmd_launches(group, parent=None) -> dict:
    """The ranks' launches of one run, summed by kernel, and the parent's
    (``parent``, counted from 0 before the run) where it launched too."""
    parent = parent or {}
    return {op: sum(r.launches[op] for r in group.last_reports)
            + parent.get(op, 0) for op in backend.OPS}


def spmd_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sim_parity(A: torch.Tensor, b: int, point) -> tuple:
    """The single-process ``MDSScheme(f=2)`` parity after ``point``."""
    comm = SimComm(P)
    s = sm.initial_sweep_state(comm, A, b)
    pts = list(iter_sweep_points(s.geom.n_panels, s.geom.levels))
    s = sm.run_steps(comm, s, pts.index(point) + 1)
    return MDSScheme(f=2).refresh(comm, s).code


def spmd_online(group, Af: torch.Tensor, kills: dict, elastic: bool = False,
                **kw):
    """``ft_caqr_sweep_online_spmd`` (or ``ft_caqr_sweep_elastic_spmd``) on
    the whole matrix ``Af`` with a ``ScriptedKiller`` at ``kills``; returns
    (result, record): seconds, the orchestrator's segments and boundaries,
    the points the ranks ran, the parent's seconds a point outside the
    ranks (everything but the wait for their answers: the orchestrator's
    refresh, hooks, poll and recovery and the runner's shipping and
    joins), the parent's peak memory above what was live and the card's
    use after, the parent's own launches (REBUILD replays), the runners'
    account and each rank's report."""
    seen = []
    entry = (spmd_qr.ft_caqr_sweep_elastic_spmd if elastic
             else spmd_qr.ft_caqr_sweep_online_spmd)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    res, sec = spmd_timed(lambda: entry(
        Af, B, group=group, fault_hooks=[ScriptedKiller(kills)],
        boundary_hooks=[seen.append], **kw))
    orch, steps = seen[-1], group.last_steps
    free, total = torch.cuda.mem_get_info()
    return res, dict(
        spmd_ranks(group, sec),
        parent_peak_gb_above_live=(torch.cuda.max_memory_allocated() - base)
        / 1e9, card_used_gb_after=(total - free) / 1e9,
        parent_launches=dict(backend.LAUNCHES),
        segments_run=orch.segments_run,
        boundaries=orch.boundaries, points=steps["points"],
        parent_seconds_per_point=(sec - steps["rank_seconds"])
        / steps["points"],
        poll_s=orch.poll_s, recover_s=orch.recover_s, runner=steps)


def row_signs_close(R: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |R - want| after each row's sign is fixed by its
    diagonal, over the f32 tolerance (atol + rtol |want|): at most 1
    passes."""
    def fix(X):
        s = torch.sign(torch.diagonal(X))
        return X * torch.where(s == 0, torch.ones_like(s), s)[:, None]

    rtol, atol = ref.tolerances(torch.float32)
    R, want = fix(R.double()), fix(want.double())
    return float(((R - want).abs() / (atol + rtol * want.abs())).max())


def spmd_online_phase(group, A: torch.Tensor, want: tuple,
                      ledgers: dict) -> dict:
    """The online and elastic paths over the ranks on the tall matrix: the
    host orchestrator here holds the global state, each rank runs one
    ``sweep_step`` a point. Failure-free and with the FT driver's four
    kills (bit-equal to the failure-free sweep, so to the scheduled runs,
    the ledger equal to the scheduled run's); ``MDSScheme(f=2)`` with two
    simultaneous non-buddy deaths, a panel a segment (bit-equal to
    failure-free and to the single-process online run with the same hooks
    and segments, the same ledger, a joint decode); SHRINK with one kill,
    fold 8 -> 4 (R bit-equal to the single-process online run, its
    transitions and ledger, and within the f32 tolerance of the
    failure-free R up to row signs)."""
    Af = A.reshape(-1, N)
    out = {}
    # the parent holds the global state now and the ranks their slices:
    # give the card back what the parent's allocator keeps cached
    torch.cuda.empty_cache()
    for path, kills, led in (
            ("online_free", {}, []),
            ("online_kills", {pt: [lane] for pt, lane in KILLS.items()},
             ledgers["kills"])):
        res, rec = spmd_online(group, Af, kills)
        same = same_bits(flat_result(res), want)
        got = ledger(res.events)
        del res
        torch.cuda.empty_cache()
        PATH_LAUNCHES[f"spmd_{path}"] = spmd_launches(
            group, rec["parent_launches"])
        out[path] = dict(rec, bitwise_equal_scheduled=same,
                         ledger_equal_scheduled=got == led)
        check(same, f"spmd {path} differs from the scheduled sweep")
        check(got == led, f"spmd {path} ledger {got} != {led}")

    point, pair = SPMD_ONLINE_MDS_KILL
    seg = sm.panel_points(sweep_geometry(P, M_LOC, N, B))
    scheme = TimedScheme(MDSScheme(f=2))
    res, rec = spmd_online(group, Af, {point: pair}, scheme=scheme,
                           segment_points=seg)
    t0 = time.perf_counter()
    one = ft_caqr_sweep_online(
        A, SimComm(P), B, fault_hooks=[ScriptedKiller({point: pair})],
        scheme=MDSScheme(f=2), segment_points=seg)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same = same_bits(flat_result(res), want)
    same_one = same_bits(flat_result(res), flat_result(one))
    led_same = ledger(res.events) == ledger(one.events)
    events = [dict(lane=e.lane, reads=e.reads, decode_seconds=e.elapsed_s)
              for e in res.events]
    del res, one
    torch.cuda.empty_cache()
    PATH_LAUNCHES["spmd_online_mds"] = spmd_launches(
        group, rec["parent_launches"])
    sec = sorted(scheme.seconds)
    out["online_mds"] = dict(
        rec, f=2, killed=pair, point=list(point), segment_points=seg,
        refreshes=len(sec), refresh_seconds_median=sec[len(sec) // 2],
        refresh_seconds_min=sec[0], refresh_seconds_max=sec[-1],
        parity_bytes_max=scheme.parity_bytes, events=events,
        single_process_seconds=one_s, bitwise_equal_failure_free=same,
        bitwise_equal_single_process=same_one,
        ledger_equal_single_process=led_same)
    check(same and same_one,
          "spmd online MDS differs from failure-free or the single process")
    check(led_same, "spmd online MDS ledger differs from the single process")
    check([e["lane"] for e in events] == pair and
          all(e["reads"].get("coded.parity1") == P + 1 for e in events),
          f"spmd online MDS events are not a joint decode: {events}")

    lane, point = SPMD_SHRINK_KILL
    res, rec = spmd_online(group, Af, {point: [lane]}, elastic=True)
    t0 = time.perf_counter()
    one = ft_caqr_sweep_online(
        A, SimComm(P), B, fault_hooks=[ScriptedKiller({point: [lane]})],
        semantics=Semantics.SHRINK, elastic_policy="fold")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same = torch.equal(res.R, one.R)
    trans = res.transitions == one.transitions and res.world == one.world
    led_same = ledger(res.events) == ledger(one.events)
    scaled = row_signs_close(res.R, want[0][0])
    (t,) = res.transitions
    PATH_LAUNCHES["spmd_elastic"] = spmd_launches(
        group, rec["parent_launches"])
    out["elastic_shrink"] = dict(
        rec, killed=lane, point=list(point), frontier=t.frontier,
        world_after=dict(n_slots=t.world_after.n_slots,
                         live=list(t.world_after.live)),
        single_process_seconds=one_s, R_bitwise_single_process=same,
        transitions_equal=trans, ledger_equal=led_same,
        R_scaled_err_failure_free=scaled)
    del res, one
    check(same, "spmd SHRINK R differs from the single-process online R")
    check(trans and led_same, "spmd SHRINK transitions or ledger differ")
    check(t.world_after.n_slots == P // 2 and rec["runner"]["worlds"]
          == [P, P // 2], f"spmd SHRINK worlds {rec['runner']['worlds']}")
    check(scaled <= 1.0, f"spmd SHRINK R vs failure-free: {scaled} x tol")
    return out


def spmd_phase(A: torch.Tensor, want: tuple, ledgers: dict, seed: int,
               device: str = "cuda") -> None:
    """One process per lane on the one card (see the module docstring);
    counters of each run are the ranks' own, counted from 0 at its start."""
    rng = np.random.default_rng([seed, 8])
    Af = A.reshape(-1, N)
    sweeps = spread_sweeps(A)
    out = {"single_process_before": {name: spread_times(sweeps[name])
                                     for name in SPMD_RESIDUE}}
    t0 = time.perf_counter()
    with spmd_qr.make_lane_group(P, device=device,
                                 timeout_s=SPMD_TIMEOUT_S) as group:
        out["spawn_seconds"] = time.perf_counter() - t0

        res, sec = spmd_timed(lambda: spmd_qr.caqr_factorize_lanes(
            Af, B, group, use_scan=False))
        same = torch.equal(res.R, want[0])
        gram = gram_error(Af.double(), res.R[0])
        out["caqr"] = dict(spmd_ranks(group, sec), r_bitwise_equal=same,
                           gram_rel_err=gram)
        PATH_LAUNCHES["spmd"] = spmd_launches(group)
        del res
        check(same, "spmd R differs from the single-process sweep's")
        check(gram <= GRAM_TOL, f"spmd Gram identity: {gram}")

        rhs = rng.standard_normal((P * M_LOC, 1)).astype(np.float32)
        x, sec = spmd_timed(lambda: spmd_qr.caqr_lstsq_lanes(
            Af, torch.from_numpy(rhs).to(A.device), B, group))
        A64 = Af.double()
        b64 = torch.from_numpy(rhs).to(A.device).double()
        x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
        lst = float((x.double() - x_ne).norm() / x_ne.norm())
        del A64
        out["lstsq"] = dict(spmd_ranks(group, sec), rel_err=lst)
        check(lst <= LSTSQ_TOL, f"spmd lstsq vs normal equations: {lst}")

        sched = FailureSchedule(events={pt: [lane] for pt, lane in KILLS.items()})
        got, sec = spmd_timed(lambda: spmd_qr.ft_caqr_sweep_spmd(
            Af, B, sched, group=group))
        same = same_bits(flat_result(got), want)
        led = ledger(got.events)
        del got
        out["ft_kills"] = dict(spmd_ranks(group, sec), bitwise_equal=same,
                               ledger_equal_single_process=led == ledgers["kills"])
        PATH_LAUNCHES["spmd_kill"] = spmd_launches(group)
        check(same, "spmd FT sweep with kills differs from failure-free")
        check(led == ledgers["kills"], f"spmd ledger {led} != {ledgers['kills']}")

        code, sec = spmd_timed(lambda: spmd_qr.mds_parity_lanes(
            Af, B, 2, SPMD_PARITY_POINT, group))
        same = same_bits(code, sim_parity(A, B, SPMD_PARITY_POINT))
        out["parity_tall"] = dict(
            point=list(SPMD_PARITY_POINT), seconds=sec,
            parity_bytes=sum(c.numel() for c in code), bytes_equal=same,
            ranks=[r._asdict() for r in group.last_reports])
        del code
        check(same, "spmd parity differs from the single-process encode")

        m_loc, n = SPMD_MDS
        Am = rng.standard_normal((P * m_loc, n)).astype(np.float32)
        As = block_row_layout(Am, P, device=device)
        point, pair = SPMD_MDS_KILL
        msched = FailureSchedule(events={point: pair})
        free = caqr_factorize(As, SimComm(P), B, collect_bundles=True,
                              use_scan=False)
        sim = ft_caqr_sweep(As, SimComm(P), B, schedule=msched,
                            scheme=MDSScheme(f=2))
        got, sec = spmd_timed(lambda: spmd_qr.ft_caqr_sweep_spmd(
            As.reshape(-1, n), B, msched, group=group, scheme=MDSScheme(f=2)))
        ranks = spmd_ranks(group, sec)
        PATH_LAUNCHES["spmd_mds"] = spmd_launches(group)
        same = same_bits(flat_result(got), flat_result(free))
        led_same = ledger(got.events) == ledger(sim.events)
        code = spmd_qr.mds_parity_lanes(As.reshape(-1, n), B, 2, point, group)
        par_same = same_bits(code, sim_parity(As, B, point))
        out["mds"] = dict(ranks, shape=[P * m_loc, n],
                          killed=pair, point=list(point), bitwise_equal=same,
                          ledger_equal_single_process=led_same,
                          parity_bytes_equal=par_same,
                          joint=[e.lane for e in got.events
                                 if e.reads.get("coded.parity1") == P + 1])
        check(same, "spmd MDS decode differs from failure-free")
        check(led_same, "spmd MDS ledger differs from the single-process one")
        check(par_same, "spmd MDS parity differs from the single-process one")
        check(out["mds"]["joint"] == pair, f"not a joint decode: {got.events}")
        del got, sim, free

        R256 = caqr_factorize(A, SimComm(P), WIDE_B, use_scan=False).R
        res, sec = spmd_timed(lambda: spmd_qr.caqr_factorize_lanes(
            Af, WIDE_B, group, use_scan=False))
        same = torch.equal(res.R, R256)
        del res, R256
        out["caqr_b256"] = dict(spmd_ranks(group, sec), r_bitwise_equal=same)
        PATH_LAUNCHES["spmd_b256"] = spmd_launches(group)
        if group.device.type == "cuda":
            # (cluster, grid) of the one wide launch, cluster 0 a plain
            # cooperative grid: K1 and K3 of one rank's lane, and K1 of the
            # single process (a card's query; the CPU has no such launch)
            out["caqr_b256"].update(
                k1_launch_each_rank=group.run(tpq.wide_launch_shape, 1,
                                              M_LOC, WIDE_B),
                k3_launch_each_rank=group.run(tpq.wide_launch_shape, 1,
                                              2 * WIDE_B, WIDE_B),
                k1_launch_single_process=tpq.wide_launch_shape(P, M_LOC,
                                                               WIDE_B))
        check(same, "spmd R at b = 256 differs from the single-process one")
        out.update(spmd_online_phase(group, A, want, ledgers))
    out["phase_seconds"] = time.perf_counter() - t0
    left = mp.active_children()
    check(not left, f"rank processes outlived their group: {left}")
    # the ranks' results were shared by CUDA IPC: release what this
    # process still maps of them, and the blocks its copies freed
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    out["single_process_after"] = {name: spread_times(sweeps[name])
                                   for name in SPMD_RESIDUE}
    emit({"spmd": dict(shape=[P * M_LOC, N], P=P, b=B, **out)})


def shrunk_kernel_check(device, m: int, w: int) -> dict:
    """K1 and K6 at the shrunken world's padded lane height against their
    plain versions (random data from a seeded generator), and their
    times."""
    g = torch.Generator().manual_seed(1)
    X = torch.randn(P, m, w, generator=g).to(device)
    tol = ref.tolerances(torch.float32)[0]
    out = {}
    for name, run, plain in (
            ("panel_qr", lambda: ops.panel_qr(X[..., :B].contiguous(), 0),
             lambda: ref.panel_qr(X[..., :B].contiguous(), 0)),
            ("fused_panel",
             lambda: ops.fused_panel(X, 0, b=B, m_loc_pad=m, levels=L),
             lambda: ref.fused_panel(X, 0, b=B, m_loc_pad=m, levels=L))):
        err, scaled = max_err(as_tuple(run()), as_tuple(plain()))
        check(scaled <= tol, f"{name} at m = {m}: scaled error {scaled}")
        C = backend.team_blocks(m, B)
        out[name] = dict(shape=[P, m, w], max_abs_err=err, scaled_err=scaled,
                         team=C, slab_in_smem=backend.team_slab_in_smem(m, B, C),
                         ms=time_ms(run, 5))
    return out


def shrink_phase(A: torch.Tensor) -> None:
    """SHRINK after one death: the scheduled elastic sweep (stepped) and
    the same kill online (fused), R bit-equal between the two and the Gram
    identity within GRAM_TOL. With P = 8 and one death under the "pad"
    policy the new world keeps 8 slots and the adopter's slice doubles, so
    the next epoch runs at m_loc_pad = 2 M_LOC."""
    lane, point = 3, sweep_point(8, "trailing", L - 1)
    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = ft_caqr_sweep(A, SimComm(P), B, semantics=Semantics.SHRINK,
                          schedule=FailureSchedule(events={point: [lane]}))
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    PATH_LAUNCHES["shrink_scheduled"] = dict(backend.LAUNCHES)
    res, stats, launches = online_run(A, {point: [lane]}, fused=True,
                                      semantics=Semantics.SHRINK)
    PATH_LAUNCHES["shrink_online"] = launches
    same = torch.equal(sched.R, res.R)
    gram = gram_error(A.reshape(-1, N).double(), res.R)
    (t,) = res.transitions
    emit({"shrink": dict(
        killed=lane, point=list(point), scheduled_seconds=sched_s,
        online=stats, R_bitwise_scheduled_online=same,
        transitions_equal=sched.transitions == res.transitions,
        ledger_equal=ledger(sched.events) == ledger(res.events),
        frontier=t.frontier, adopter=t.adopter,
        world_after=dict(n_slots=t.world_after.n_slots,
                         live=list(t.world_after.live)),
        gram_rel_err=gram, launches_scheduled=PATH_LAUNCHES["shrink_scheduled"],
        launches_online=launches,
        shrunk_kernels=shrunk_kernel_check(A.device, 2 * M_LOC, N - 9 * B))})
    check(same, "SHRINK: online R differs from the scheduled R")
    check(sched.transitions == res.transitions and
          ledger(sched.events) == ledger(res.events),
          "SHRINK: transitions or ledgers differ")
    check(t.world_after.n_slots == P and t.world_after.n_live == P - 1,
          f"SHRINK world {t.world_after}")
    check(gram <= GRAM_TOL, f"SHRINK Gram identity: {gram} > {GRAM_TOL}")
    check(launches["fused_panel"] == N // B,
          f"SHRINK online K6 launches {launches}")


def cell_b(op: str, geometry) -> int:
    """The panel width b of an autotuner cell: K2's (P, m, b, n), K4's
    (P, b, n)."""
    return geometry[2] if op == "wy_apply" else geometry[1]


def autotune_phase(A: torch.Tensor, want: tuple) -> None:
    """The autotuner on the card: ``tune_all(DEFAULT_CELLS)`` (``tune``
    raises if a candidate's output differs from the static tile's in a
    bit), ``save`` -> ``clear`` -> ``load`` adopting every cell, a file of
    another fingerprint adopting none, and, with the tuned cells loaded,
    the tall sweep bit-equal to the untuned sweep's R, factors and
    bundles (counters at 0 before it: path ``autotune``), with each cell
    consulted on that sweep counted. One JSON line a cell."""
    t_phase = time.perf_counter()
    autotune.clear()
    key = lambda op, g: autotune.cell_key(op, g, torch.float32, "cuda")  # noqa: E731
    tuned = autotune.tune_all(autotune.DEFAULT_CELLS, reps=AUTOTUNE_REPS)
    check(sorted(tuned) == sorted(key(op, g) for op, g in autotune.DEFAULT_CELLS),
          f"autotune: cells {sorted(tuned)}")
    for op, g in autotune.DEFAULT_CELLS:
        rec = tuned[key(op, g)]
        emit({"autotune_cell": dict(
            op=op, geometry=list(g), winner=rec["params"], ms=rec["us"] / 1e3,
            static_ms=rec["static_us"] / 1e3,
            candidates=len(autotune.candidates(op, "cuda", g)), reps=AUTOTUNE_REPS,
            static_tile=(backend.tile_bn(g[0], g[-1], backend.sm_count(0))
                         if cell_b(op, g) <= autotune.MAX_B else "gemm_plan"))})
    with tempfile.TemporaryDirectory() as d:
        path = autotune.save(os.path.join(d, "autotune.json"))
        autotune.clear()
        adopted = autotune.load(path)
        check(adopted == len(tuned), f"autotune: load adopted {adopted} of {len(tuned)}")
        check(all(autotune.lookup(op, g, torch.float32) == tuned[key(op, g)]["params"]
                  for op, g in autotune.DEFAULT_CELLS), "autotune: a loaded cell differs")
        with open(path) as f:
            payload = json.load(f)
        payload["cells"] = {"cuda:another card:sm_80:108sms": payload["cells"][
            backend.backend_fingerprint()]}
        foreign = os.path.join(d, "foreign.json")
        with open(foreign, "w") as f:
            json.dump(payload, f)
        autotune.clear()
        foreign_adopted = autotune.load(foreign)
        check(foreign_adopted == 0 and all(
            autotune.lookup(op, g, torch.float32) == {} for op, g in
            autotune.DEFAULT_CELLS), f"autotune: a foreign file adopted {foreign_adopted}")
        autotune.clear()
        autotune.load(path)
    hits = {}
    lookup = autotune.lookup

    def counted(op, geometry, dtype, variant="cuda"):
        k = key(op, geometry)
        if k in autotune._CELLS:  # consulted, whichever tile won
            hits[k] = hits.get(k, 0) + 1
        return lookup(op, geometry, dtype, variant)

    autotune.lookup = counted
    try:
        backend.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = caqr_factorize(A, SimComm(P), B, use_scan=False, collect_bundles=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        PATH_LAUNCHES["autotune"] = dict(backend.LAUNCHES)
    finally:
        autotune.lookup = lookup
        autotune.clear()
    same = same_bits(flat_result(res), want)
    del res
    consulted = {key(op, g): hits.get(key(op, g), 0)
                 for op, g in autotune.DEFAULT_CELLS if cell_b(op, g) <= B}
    emit({"autotune": dict(cells=len(tuned), adopted=adopted,
                           foreign_adopted=foreign_adopted, tuned_sweep_seconds=seconds,
                           tuned_sweep_bitwise_equal=same, consulted=consulted,
                           launches=PATH_LAUNCHES["autotune"],
                           fingerprint=backend.backend_fingerprint(),
                           phase_seconds=time.perf_counter() - t_phase)})
    check(same, "autotune: the tuned sweep differs from the untuned sweep")
    check(all(PATH_LAUNCHES["autotune"][op] > 0 for op in STEPPED),
          f"autotune: launches {PATH_LAUNCHES['autotune']}")
    check(all(consulted.values()), f"autotune: a b = {B} cell never consulted {consulted}")


def adafactor_step(cfg, params, batch, reps: int = 1) -> tuple:
    """``reps`` runs of one ``make_train_step(cfg, adafactor(), ...)`` step
    from the same state: [(new state, seconds)]."""
    opt = adafactor()
    step = make_train_step(cfg, opt, constant(1e-3))
    out = []
    for _ in range(reps):
        state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
        if params_on_card(params):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _ = step(state, batch)
        if params_on_card(params):
            torch.cuda.synchronize()
        out.append((new, time.perf_counter() - t0))
    return out


def params_on_card(params) -> bool:
    return tree.leaves(params)[0].device.type == "cuda"


def state_bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def adafactor_inputs(seed: int):
    """The adafactor phase's config, host params and batch, and the step's
    result and seconds on the CPU (run while the kernels build)."""
    cfg, _ = train_configs(seed)
    cfg = dataclasses.replace(cfg, dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=ADA_SEQ, global_batch=ADA_BATCH,
                      seed=seed + 80)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(dcfg, 0).items()}
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(seed + 81))
    (cpu, cpu_s), = adafactor_step(cfg, params, batch)
    return cfg, params, batch, cpu, cpu_s


def adafactor_phase(inputs: tuple, card: str) -> None:
    """One Adafactor train step at TinyLlama's width, 2 layers, 2 x 256
    tokens, f32 (``ADA_REDUCED``), deterministic mode (path
    ``adafactor``): twice on the card, bit-equal; against the same step on
    the CPU (``adafactor_inputs``), params, ``vr`` and ``vc`` within
    ADA_TOL scaled by each leaf's max |CPU|. Prints the step's seconds and
    the optimizer state's bytes beside an AdamW step's."""
    t_phase = time.perf_counter()
    cfg, host, host_batch, c, cpu_s = inputs
    params = tree.map(lambda x: x.cuda(), host)
    batch = {k: v.cuda() for k, v in host_batch.items()}
    with deterministic_mode():
        backend.reset_launches()
        (a, s1), (b, s2) = adafactor_step(cfg, params, batch, reps=2)
        PATH_LAUNCHES["adafactor"] = dict(backend.LAUNCHES)
        opt = adamw()
        step = make_train_step(cfg, opt, constant(1e-3))
        st = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw_state = step(st, batch)[0].opt_state
        torch.cuda.synchronize()
        adamw_s = time.perf_counter() - t0
    errs = {}
    for name, got, want in (("params", a.params, c.params),
                            ("vr", a.opt_state.vr, c.opt_state.vr),
                            ("vc", a.opt_state.vc, c.opt_state.vc)):
        errs[name] = max((float((g.cpu() - w).abs().max())
                          / max(float(w.abs().max()), 1e-30))
                         for g, w in zip(tree.leaves(got), tree.leaves(want))
                         if w.numel())
    twice = same_tree(a.params, b.params) and same_tree(a.opt_state, b.opt_state)
    emit({"adafactor": dict(
        arch=TRAIN_ARCH, d_model=cfg.d_model, n_layers=cfg.n_layers, dtype=cfg.dtype,
        batch=ADA_BATCH, seq_len=ADA_SEQ, reduced=ADA_REDUCED,
        step_seconds=[s1, s2], cpu_step_seconds=cpu_s, adamw_step_seconds=adamw_s,
        state_bytes=state_bytes(a.opt_state), adamw_state_bytes=state_bytes(adamw_state),
        param_bytes=state_bytes(params), scaled_err_vs_cpu=errs, tolerance=ADA_TOL,
        bitwise_equal_twice=twice, launches=PATH_LAUNCHES["adafactor"],
        phase_seconds=time.perf_counter() - t_phase, card=card)})
    check(twice, "adafactor: two card runs of the step differ")
    check(all(e <= ADA_TOL for e in errs.values()), f"adafactor vs CPU: {errs}")
    check(all(torch.isfinite(x).all() for x in tree.leaves(a.params)),
          "adafactor: a parameter is not finite")
    del a, b, c, params, adamw_state
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_phase(card: str) -> None:
    """The dry run on meta tensors (``repro_torch.launch.dryrun``): the
    ``caqr`` cell (``paper_qr.PRODUCTION`` over 256 lanes) and kimi-k2 x
    train_4k (the 1T adafactor cell) at mesh ``single``, counters at 0
    before them (path ``dryrun``: no kernel may launch). Prints both
    records."""
    t_phase = time.perf_counter()
    backend.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        recs = [dryrun.run_caqr_cell("single", d)]
        recs += [dryrun.run_cell(arch, shape, "single", d) for arch, shape in DRYRUN_CELLS]
    PATH_LAUNCHES["dryrun"] = dict(backend.LAUNCHES)
    seconds = time.perf_counter() - t_phase
    emit({"dryrun": dict(records=recs, phase_seconds=seconds, card=card)})
    check(not any(PATH_LAUNCHES["dryrun"].values()),
          f"dryrun: a kernel launched on meta tensors {PATH_LAUNCHES['dryrun']}")
    for r in recs:
        check(r["status"] == "ok" and r["cost"]["flops_global"] >= r["model_flops_global"] > 0
              and r["memory"]["argument_bytes"] > 0, f"dryrun: record {r}")
    check(recs[1]["optimizer"] == "adafactor" and recs[1]["n_params"] > 10 ** 12,
          f"dryrun: kimi-k2 {recs[1]['optimizer']} {recs[1]['n_params']}")


def spread_sweeps(A: torch.Tensor) -> dict:
    """The spread phase's full-width single-process sweeps by name."""
    comm = SimComm(P)
    kills = {pt: [lane] for pt, lane in KILLS.items()}
    ends = {pt: [lane] for pt, lane in PANEL_END_KILLS.items()}

    def fused():
        s = sm.initial_sweep_state(comm, A, B)
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
        return sm.finalize(comm, s)

    def online(k, **kw):
        return lambda: ft_caqr_sweep_online(
            A, comm, B, fault_hooks=[ScriptedKiller(k)], **kw)

    return {
        "caqr_factorize": lambda: caqr_factorize(
            A, comm, B, use_scan=False, collect_bundles=True),
        "state_machine_stepped": lambda: sm.finalize(
            comm, sm.run_steps(comm, sm.initial_sweep_state(comm, A, B))),
        "state_machine_fused": fused,
        "ft_sweep_four_kills": lambda: ft_caqr_sweep(
            A, comm, B, schedule=FailureSchedule(events=kills)),
        "online_stepped_four_kills": online(kills),
        "online_fused_four_kills": online(ends, fused=True),
        "online_async_four_kills": online(kills, async_segments=True),
    }


def spread_times(fn) -> dict:
    """``fn`` run SPREAD_RUNS times, each run ending in a synchronise:
    median and min-max seconds."""
    times = []
    for _ in range(SPREAD_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del res
    times.sort()
    return dict(median_s=times[len(times) // 2], min_s=times[0],
                max_s=times[-1], runs=times)


def spread_phase(A: torch.Tensor) -> None:
    """Run-to-run spread: every full-width sweep SPREAD_RUNS times."""
    out = {name: spread_times(fn) for name, fn in spread_sweeps(A).items()}
    emit({"spread": dict(shape=[P * M_LOC, N], runs=SPREAD_RUNS, **out)})


def recovery_phase(A: torch.Tensor) -> None:
    comm = SimComm(P)
    backend.reset_launches()
    fac = ft_tsqr(A[..., :B], comm)
    C = A[..., B:]
    clean = recovery.run_ft_trailing(C, fac, comm)
    faulty = recovery.run_ft_trailing(C, fac, comm, fail_at_level=1,
                                      failed_lane=3, A_stacked=C)
    torch.cuda.synchronize()
    same = torch.equal(clean, faulty)
    emit({"recovery": dict(panel=[P, M_LOC, B], trailing=list(C.shape),
                           killed_lane=3, after_level=1, bitwise_equal=same,
                           launches=dict(backend.LAUNCHES))})
    check(same, "recovered run differs from the clean run")


def square_phase(rng) -> None:
    """4096 x 4096 over P = 8 (m_loc = 512): the root walks lanes 0-7,
    consumed lanes and row_start clamping past lane 0 occur."""
    n = N
    m_loc = n // P
    A = block_row_layout(rng.standard_normal((n, n)).astype(np.float32), P)
    comm = SimComm(P)
    ref_res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    want = flat_result(ref_res)
    gram = gram_error(A.reshape(-1, n).double(), ref_res.R[0])
    check(gram <= GRAM_TOL, f"square Gram identity: {gram} > {GRAM_TOL}")
    boundaries = lockstep(A)
    k = 13                     # col0 = 1664: rooted at lane 3
    root = (k * B) // m_loc
    out = kill_check(A, comm, {sweep_point(k, "trailing", 1): root}, want)
    del out["ledger"]
    emit({"square": dict(shape=[n, n], m_loc=m_loc, gram_rel_err=gram,
                         boundaries_bitwise=boundaries, kill=out)})


def ragged_phase(rng) -> None:
    m_loc, n = 4000, 4000
    A_np = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    A = block_row_layout(A_np, P)
    res = caqr_factorize(A, SimComm(P), B, use_scan=False)
    torch.cuda.synchronize()
    check(tuple(res.R.shape) == (P, n, n), f"ragged R shape {res.R.shape}")
    gram = gram_error(A.reshape(-1, n).double(), res.R[0])
    check(gram <= GRAM_TOL, f"ragged Gram identity: {gram} > {GRAM_TOL}")
    del res
    boundaries = lockstep(A)
    emit({"ragged": dict(m_loc=m_loc, n=n, b=B, gram_rel_err=gram,
                         fused_boundaries_bitwise=boundaries)})


def serve_traffic(seed: int) -> list:
    """The serve phase's (A, rhs) requests from ``seed`` (the launcher's
    ``make_requests``): half drawn for each bucket, interleaved."""
    rng = np.random.default_rng(seed)
    halves = [make_requests(rng, SERVE_REQUESTS // 2, B, P * m_loc, n - 2,
                            SERVE_LSTSQ_FRAC) for m_loc, n in SERVE_BUCKETS]
    return [req for pair in zip(*halves) for req in pair]


def serve_service() -> QRService:
    """The serve phase's service on its default device (the card)."""
    return QRService(SimComm(P), panel_width=B, buckets=SERVE_BUCKETS,
                     max_slots=SERVE_SLOTS)


def serve_run(reqs: list, kill: bool = False) -> dict:
    """The service under ``reqs``, one request submitted a tick (the
    launcher's ``--arrive-every 1``), a synchronise after every tick; with
    ``kill``, lane SERVE_KILL_LANE dies at tick SERVE_KILL_TICK. Launch
    counters at 0 before it."""
    svc = serve_service()
    pending = list(reqs)
    rids, ticks, at_kill = [], [], []
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    while pending or svc.queue or svc.resident:
        if pending:
            rids.append(svc.submit(*pending.pop(0)))
        if kill and svc.tick_count == SERVE_KILL_TICK:
            svc.kill_lane(SERVE_KILL_LANE)
            at_kill = [s.req.rid for s in svc.slots if s is not None]
        t = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    return dict(results=svc.results, rids=rids, wall=wall, ticks=ticks,
                at_kill=at_kill, device=svc.device,
                launches=dict(backend.LAUNCHES))


def serve_checks(reqs: list, run: dict) -> dict:
    """Every tenant's R against the Gram identity of its own A and every
    lstsq x against the float64 solution, both on the service's device."""
    dev = run["device"]
    gram, lst = [], []
    for rid, (A, rhs) in zip(run["rids"], reqs):
        r = run["results"][rid]
        A64 = torch.from_numpy(A).to(dev).double()
        gram.append(gram_error(A64, torch.from_numpy(r.R).to(dev)))
        if rhs is not None:
            x_ref = torch.linalg.lstsq(
                A64, torch.from_numpy(rhs).to(dev).double()).solution
            x = torch.from_numpy(r.x).to(dev).double()
            lst.append(float((x - x_ref).norm() / x_ref.norm()))
        del A64
    check(max(gram) <= GRAM_TOL, f"serve Gram identity: {max(gram)} > {GRAM_TOL}")
    check(max(lst) <= LSTSQ_TOL, f"serve lstsq vs float64: {max(lst)} > {LSTSQ_TOL}")
    return dict(gram_rel_err_max=max(gram), lstsq_tenants=len(lst),
                lstsq_rel_err_max=max(lst))


def leading_rank(X: torch.Tensor, b: int) -> int:
    """How many leading columns of the first panel ``X[..., :b]`` of a
    (P, m_loc, n) block-row matrix are numerically independent on every
    lane: the columns before the first whose float64 pivot |R_jj| falls
    below DEPENDENT_PIVOT of the lane's largest."""
    d = torch.linalg.qr(X[..., :b].double(), mode="r").R.diagonal(
        dim1=-2, dim2=-1).abs()
    ok = d >= DEPENDENT_PIVOT * d.amax(-1, keepdim=True)
    return int(torch.cumprod(ok.int(), -1).sum(-1).min())


def determined(op: str, outs: tuple, rank: int) -> tuple:
    """The outputs of a panel QR (K1's Y, T, R; K3's Y2, T, R) that its
    first ``rank`` reflectors fix: a reflector past the rank of the columns
    before it is round-off in any QR, and so are the entries of Y and T
    that depend on it and the rows of R it makes. Other kernels' outputs
    are all fixed by their inputs."""
    if op not in ("panel_qr", "stacked_qr"):
        return outs
    Y, T, R = outs
    return Y[..., :rank], T[..., :rank, :rank], R[..., :rank, :]


def stepped_kernel_check(X: torch.Tensor, b: int, rs_last, worst: dict,
                         where: str, rank: int = 0) -> None:
    """K1-K4 against their plain versions on a (P, m_loc, n) block-row
    matrix ``X`` at panel width ``b``: K1 at row start 0 and at the last
    panel's row starts ``rs_last`` (one a lane), on P lanes and on one (the
    REBUILD replay); K2 on the first, a middle and the last panel's window
    and on one lane; K3 on a butterfly pair's R factors; K4 at the first
    and the last window. With ``0 < rank < b`` (the first panel's leading
    columns past ``rank`` depend on those before them), K1's and K3's
    outputs are held where the first ``rank`` reflectors fix them
    (``determined``). Raises past the tolerance; folds each kernel's
    largest scaled error into ``worst``."""
    tol = ref.tolerances(torch.float32)[0]
    P, _, n = X.shape
    pairs = [p ^ 1 for p in range(P)]
    panel = X[..., :b].contiguous()
    Y, T, R = ops.panel_qr(panel, 0)
    Y2, T2, _ = ops.stacked_qr(R, R[pairs].contiguous())
    cases = [("panel_qr", (panel, 0)), ("panel_qr", (panel, rs_last)),
             ("panel_qr", (panel[1], 0)),
             ("panel_qr", (panel[0], int(rs_last[0]))),
             ("wy_apply", (Y[1], T[1], X[1])),
             ("stacked_qr", (R, R[pairs].contiguous()))]
    cases += [("wy_apply", (Y, T, X[..., n - w:].contiguous()))
              for w in sorted({n, max(n // 2, 1), b})]
    for w in sorted({n, b}):
        Ct = X[:, :b, n - w:].contiguous()
        cases.append(("stacked_apply", (Y2, T2, Ct, Ct[pairs].contiguous())))
    r = rank if 0 < rank < b else b
    for op, args in cases:
        _, scaled = max_err(determined(op, as_tuple(getattr(ops, op)(*args)), r),
                            determined(op, as_tuple(getattr(ref, op)(*args)), r))
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        check(scaled <= tol, f"{where}: {op} at {shapes}: scaled error "
              f"{scaled} over {tol}")
        worst[op] = max(worst.get(op, 0.0), scaled)


def serve_kernel_check(reqs: list, run: dict) -> dict:
    """K1-K4 at each bucket's shapes against their plain versions
    (``stepped_kernel_check``), on two inputs a bucket: the first tenant of
    ``run`` that it served ([A | rhs] zero-padded into the bucket, as
    admission pads it), and seeded random data. Returns the largest scaled
    error of each kernel at each bucket."""
    g = torch.Generator().manual_seed(2)
    out = {}
    dev = run["device"]
    for m_loc, n_b in SERVE_BUCKETS:
        tenant = next(A if rhs is None else np.concatenate([A, rhs], axis=1)
                      for rid, (A, rhs) in zip(run["rids"], reqs)
                      if run["results"][rid].bucket == (m_loc, n_b))
        n_last = sweep_geometry(P, m_loc, n_b, B).n_panels - 1
        rs_last = panel_geometry(SimComm(P), n_last, B, m_loc)[2]
        worst = {}
        for X in (block_row_layout(tenant, P, m_loc, n_b, device=dev),
                  torch.randn(P, m_loc, n_b, generator=g).to(dev)):
            stepped_kernel_check(X, B, rs_last, worst,
                                 f"serve bucket {(m_loc, n_b)}")
            del X
        out[str([m_loc, n_b])] = dict(
            team=backend.team_blocks(m_loc, B),
            last_row_start=int(rs_last[0]), scaled_err_max=worst)
    return out


def serve_same(got: dict, want: dict) -> bool:
    """Every tenant's R and x in ``got`` bit-equal to ``want``'s."""
    return all(np.array_equal(got[rid].R, r.R) and
               (r.x is None) == (got[rid].x is None) and
               (r.x is None or np.array_equal(got[rid].x, r.x))
               for rid, r in want.items())


def serve_stats(run: dict) -> dict:
    lat = sorted(r.latency_s for r in run["results"].values())
    ticks = sorted(run["ticks"])
    n = len(run["results"])
    return dict(requests=n, seconds=run["wall"], req_per_s=n / run["wall"],
                p50_latency_s=lat[n // 2],
                p99_latency_s=lat[min(n - 1, int(n * 0.99))],
                ticks=len(ticks), tick_seconds_median=ticks[len(ticks) // 2],
                tick_seconds_max=ticks[-1], launches=run["launches"])


def serve_phase(seed: int, card: str) -> None:
    """The QR service at full width: failure-free, with a lane killed
    mid-batch, and drain_batched, on the same traffic (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    reqs = serve_traffic(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    clean = serve_run(reqs)
    PATH_LAUNCHES["serve"] = clean["launches"]
    checks = serve_checks(reqs, clean)
    want = clean["results"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = serve_run(reqs)
    by_kernel, other = device_time_by_kernel(prof)
    # the copies and fills inside "other" (admission's host-to-device copy)
    copies = {e.key: _device_us(e) / 1e3 for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key.startswith(("Memcpy", "Memset"))}
    compute = sum(by_kernel.values()) + other - sum(copies.values())
    # both shares over the profiled drain's own wall time (the tracer
    # slows the host, so it is longer than the first drain's)
    prof_ms = profiled["wall"] * 1e3
    profiled_same = serve_same(profiled["results"], want)
    del prof, profiled
    killed = serve_run(reqs, kill=True)
    PATH_LAUNCHES["serve_kill"] = killed["launches"]
    kill_same = serve_same(killed["results"], want)
    healed = {rid: killed["results"][rid].events for rid in killed["at_kill"]}
    heal_s = sorted(sum(e.elapsed_s for e in ev) for ev in healed.values())
    svc = serve_service()
    drained = {}
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, len(reqs), SERVE_GROUP):
        for A, rhs in reqs[i:i + SERVE_GROUP]:
            svc.submit(A, rhs)
        drained.update(svc.drain_batched())
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    PATH_LAUNCHES["serve_batched"] = dict(backend.LAUNCHES)
    drain_same = serve_same(drained, want)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    kernels = serve_kernel_check(reqs, clean)
    emit({"serve": dict(
        P=P, b=B, buckets=[list(bk) for bk in SERVE_BUCKETS],
        slots=SERVE_SLOTS, requests=len(reqs),
        lstsq_requests=sum(rhs is not None for _, rhs in reqs),
        buckets_used={str(list(bk)): sum(r.bucket == bk for r in want.values())
                      for bk in SERVE_BUCKETS},
        largest=max(list(A.shape) for A, _ in reqs),
        failure_free=serve_stats(clean), **checks,
        profiled_wall_ms=prof_ms, compute_busy_share=compute / prof_ms,
        copy_share=sum(copies.values()) / prof_ms,
        profiled_kernel_ms=by_kernel,
        profiled_other_compute_ms=other - sum(copies.values()),
        profiled_copy_ms=copies,
        kill=dict(lane=SERVE_KILL_LANE, tick=SERVE_KILL_TICK,
                  **serve_stats(killed), resident_at_kill=len(healed),
                  heal_seconds_per_tenant=heal_s,
                  events=sum(len(ev) for ev in healed.values()),
                  bitwise_equal_failure_free=kill_same),
        batched=dict(seconds=drain_s, group=SERVE_GROUP,
                     req_per_s=len(drained) / drain_s,
                     launches=PATH_LAUNCHES["serve_batched"],
                     bitwise_equal_continuous=drain_same),
        bucket_kernels=kernels, peak_mem_gb_above_live=peak,
        phase_seconds=time.perf_counter() - t_phase, card=card)})
    check(profiled_same, "the profiled serve run differs from the first")
    check(kill_same, "serve: a tenant's R or x differs after the kill")
    # single source: each artifact is read from one surviving lane
    check(bool(healed) and all(
        len(ev) >= 1 and all(e.lane == SERVE_KILL_LANE and e.reads and
                             SERVE_KILL_LANE not in e.reads.values()
                             for e in ev)
        for ev in healed.values()),
          "serve: a tenant resident at the kill has no single-source event")
    check(drain_same, "serve: drain_batched differs from continuous batching")
    for path in ("serve", "serve_kill", "serve_batched"):
        check(all(PATH_LAUNCHES[path][op] > 0 for op in STEPPED),
              f"{path}: K1-K4 not all launched: {PATH_LAUNCHES[path]}")


def train_configs(seed: int):
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    return cfg, dcfg


def train_tcfg(ckpt_dir: str, **kw) -> TrainConfig:
    base = dict(steps=TRAIN_STEPS, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                n_lanes=TRAIN_LANES, diskless_every=2, log_every=10 ** 9,
                optimizer="caqr_muon", ckpt_dir=ckpt_dir)
    base.update(kw)
    return TrainConfig(**base)


def train_fcfg(**kw) -> FTRunConfig:
    return FTRunConfig(qr_lanes=TRAIN_LANES, panel_width=TRAIN_B, **kw)


def same_tree(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def train_run(tr, path: str = "", schedule=None, gram: bool = False,
              watch: str = "") -> dict:
    """Run trainer ``tr`` to its end: its history, step and phase seconds,
    the engine's stats, peak memory (above what was live before it, and in
    all), and with ``path`` the launches counted from 0 just before the
    run; with ``gram`` every sweep's R held to the Gram identity of its
    momentum slice (float64, on the card), and the column norms of the Q
    that the sweeps of task ``watch`` give (``A R^-1``, as the engine forms
    it)."""
    grams, watched = [], []
    if gram:
        factorize = tr.engine.factorize

        def checked(M, resume_state=None):
            R = factorize(M, resume_state=resume_state)
            grams.append((tr._cur_step, tr._cur_task,
                          gram_error(M.double(), R)))
            if tr._cur_task == watch:
                Q = torch.linalg.solve_triangular(R, M, upper=True, left=False)
                watched.append(Q.norm(dim=0).tolist())
            return R

        tr.engine.factorize = checked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    hist = tr.run(schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if path:
        PATH_LAUNCHES[path] = dict(backend.LAUNCHES)
    dts = [h["dt"] for h in hist]
    out = dict(wall_seconds=wall, losses=[h["loss"] for h in hist],
               steps=[h["step"] for h in hist], step_seconds=dts,
               step_seconds_median=sorted(dts)[len(dts) // 2],
               peak_mem_gb_above_live=(torch.cuda.max_memory_allocated() - base) / 1e9,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(backend.LAUNCHES))
    if isinstance(tr, FTTrainer):
        e = tr.engine
        out.update(phase_seconds=dict(tr.phase_s), sweeps=e.sweeps,
                   boundaries=e.boundaries, segments=e.segments,
                   engine_sweep_seconds=e.sweep_s, poll_seconds=e.poll_s,
                   heal_seconds=e.recover_s, events=len(e.events))
    if gram:
        out["gram"] = grams
    if watch:
        out["watch"] = watched
    return out


def train_kernel_check(mom, tasks: list, g: torch.Generator,
                       shapes=TRAIN_SHAPES, random: bool = True) -> dict:
    """K1-K4 at a train path's shapes ((m_loc, n, b), TRAIN_SHAPES by
    default) against their plain versions, on 4 lanes and on one
    (``stepped_kernel_check``): the Muon shapes on a momentum slice of the
    failure-free run laid out as the engine lays it out, and (with
    ``random``) on random data; the projection shapes on random data."""
    dev = tree.leaves(mom)[0].device
    by_shape = {}
    for task in tasks:
        M = task_slice(mom, task)
        A = (M.T if task.transpose else M).float()
        by_shape.setdefault((A.shape[0] // TRAIN_LANES, A.shape[1]), A)
    out = {}
    for m_loc, n, b in shapes:
        geom = sweep_geometry(TRAIN_LANES, m_loc, n, b)
        rs_last = panel_geometry(SimComm(TRAIN_LANES), geom.n_panels - 1, b,
                                 m_loc)[2]
        inputs = [torch.randn(TRAIN_LANES, m_loc, n, generator=g).to(dev)
                  ] if random else []
        if (m_loc, n) in by_shape:
            inputs.append(by_shape[(m_loc, n)].reshape(TRAIN_LANES, m_loc, n)
                          .contiguous())
        check(inputs, f"no input for the kernel check at {(m_loc, n, b)}")
        worst, ranks = {}, []
        for X in inputs:
            ranks.append(leading_rank(X, b))
            stepped_kernel_check(X, b, rs_last, worst,
                                 f"train shape {(TRAIN_LANES, m_loc, n)} b={b}",
                                 rank=ranks[-1])
        out[str([TRAIN_LANES, m_loc, n, b])] = dict(
            team=backend.team_blocks(m_loc, b), inputs=len(inputs),
            leading_rank=ranks, last_row_start=int(rs_last[0]),
            scaled_err_max=worst)
    return out


def train_profile(cfg, dcfg, d: str, clean: dict) -> dict:
    """Device time by kernel over one more failure-free step under
    torch.profiler, against the failure-free run's unprofiled step and
    task-loop seconds (past the first step's warm-up): how much of the
    step the card is busy, and how much of the task loop K1-K4 fill. The
    diskless push's device-to-host copy is counted apart."""
    from torch.profiler import ProfilerActivity, profile

    tr = FTTrainer(cfg, train_tcfg(d, steps=1), dcfg, train_fcfg())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, other = device_time_by_kernel(prof)
    copies = sum(_device_us(e) / 1e3 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key.startswith(("Memcpy", "Memset")))
    steps = sorted(clean["step_seconds"][1:])
    step_ms = 1e3 * steps[len(steps) // 2]
    tasks_ms = 1e3 * clean["phase_seconds"]["tasks"] / TRAIN_STEPS
    kernels = sum(by_kernel.values())
    return dict(profiled_wall_ms=wall_ms, kernel_ms=by_kernel,
                other_compute_ms=other - copies, copy_ms=copies,
                step_ms_median=step_ms, task_loop_ms_per_step=tasks_ms,
                compute_busy_share=(kernels + other - copies) / step_ms,
                k1_k4_share_of_task_loop=kernels / tasks_ms)


@contextlib.contextmanager
def deterministic_mode():
    """torch's deterministic mode for a training phase, restored after it:
    deterministic scatter-adds for the embedding's and the CE pick's
    backward (and the MoE dispatch's and combine's); every kernel writes all
    of its outputs, so the fill of fresh memory the mode also turns on (a
    debugging aid) stays off."""
    det_before = torch.are_deterministic_algorithms_enabled()
    fill_before = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det_before)
        torch.utils.deterministic.fill_uninitialized_memory = fill_before


def train_phase(seed: int, card: str) -> None:
    """The FT training runtime at TinyLlama's full width (see the module
    docstring), under torch's deterministic mode."""
    t_phase = time.perf_counter()
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        report = train_runs(seed, d, card)
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit({"train": report})


def train_runs(seed: int, d: str, card: str) -> dict:
    cfg, dcfg = train_configs(seed)
    muon = lambda **kw: FTTrainer(cfg, train_tcfg(d), dcfg, train_fcfg(**kw))  # noqa: E731
    # 1. failure-free (every later run is held to it bit for bit: the
    # determinism check)
    ref = muon()
    clean = train_run(ref, "train", gram=True)
    grams = clean.pop("gram")
    tasks = ref._tasks
    want_params, want_opt = ref.state.params, ref.state.opt_state
    kernels = train_kernel_check(want_opt.mom, tasks,
                                 torch.Generator().manual_seed(seed + 3))
    del ref
    profiled = train_profile(cfg, dcfg, d, clean)
    del want_opt
    bps = clean["boundaries"] // TRAIN_STEPS
    # 2. a lane killed mid-sweep inside step 2
    killer = StepSweepKiller(**TRAIN_KILL)
    tr = FTTrainer(cfg, train_tcfg(d), dcfg, train_fcfg(), qr_fault_hooks=[killer])
    kill = train_run(tr, "train_kill")
    ev = tr.engine.events
    kill_same = same_tree(tr.state.params, want_params) and \
        kill["losses"] == clean["losses"]
    kill.update(struck=killer.struck,
                event_reads=[{str(k): int(v) for k, v in e.reads.items()} for e in ev])
    del tr
    # 3. async double-buffered segments, the same kill
    killer_a = StepSweepKiller(**TRAIN_KILL)
    tr = FTTrainer(cfg, train_tcfg(d), dcfg, train_fcfg(async_segments=True),
                   qr_fault_hooks=[killer_a])
    asyn = train_run(tr)
    async_same = same_tree(tr.state.params, want_params) and killer_a.fired
    del tr
    # 4. suspended inside step 2, resumed from disk in this process
    n_suspend = 2 * bps + bps // 2
    tr = muon(suspend_after_boundaries=n_suspend)
    t0 = time.perf_counter()
    try:
        tr.run()
        suspended = None
    except TrainingSuspended as exc:
        suspended = exc
    suspend_s = time.perf_counter() - t0
    del tr
    check(suspended is not None and suspended.step == 2,
          f"train: no suspension inside step 2 ({suspended})")
    t0 = time.perf_counter()
    resumed = FTTrainer.resume(cfg, train_tcfg(d), dcfg, train_fcfg())
    restore_s = time.perf_counter() - t0
    res = train_run(resumed)
    resume_same = same_tree(resumed.state.params, want_params)
    res.update(suspended_at=dict(boundary=n_suspend, step=suspended.step,
                                 task=suspended.task),
               suspend_run_seconds=suspend_s, restore_seconds=restore_s)
    del resumed
    # 5. a training-level lane death at step 3: diskless restore and replay
    tr = muon()
    rebuild = train_run(tr, schedule=FailureSchedule(events=TRAIN_FAIL))
    rebuild_same = same_tree(tr.state.params, want_params)
    del tr
    # 6. the PowerSGD bridge, failure-free and with a kill in its sweep
    psgd = lambda hooks=(): FTTrainer(  # noqa: E731
        cfg, train_tcfg(d, optimizer="adamw", steps=TRAIN_PSGD_STEPS), dcfg,
        train_fcfg(compression_rank=TRAIN_PSGD_RANK), qr_fault_hooks=hooks)
    p_ref = psgd()
    p_clean = train_run(p_ref, "train_psgd")
    p_tasks = len(p_ref._tasks)
    p_killer = StepSweepKiller(at_step=1, lane=2)
    p_tr = psgd([p_killer])
    p_kill = train_run(p_tr)
    psgd_same = (same_tree(p_tr.state.params, p_ref.state.params)
                 and p_kill["losses"] == p_clean["losses"] and p_killer.fired)
    p_kill["struck"] = p_killer.struck
    del p_ref, p_tr
    # 7. the plain trainer (adamw), no QR
    plain = train_run(Trainer(cfg, train_tcfg(d, optimizer="adamw"), dcfg))
    del want_params
    launches_ok = {path: all(PATH_LAUNCHES[path][op] > 0 for op in STEPPED)
                   and PATH_LAUNCHES[path]["panel_qr_apply"] == 0
                   and PATH_LAUNCHES[path]["fused_panel"] == 0
                   for path in ("train", "train_kill", "train_psgd")}
    gram_max = max(g for *_, g in grams)
    report = dict(
        arch=TRAIN_ARCH, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hdim, d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype=cfg.dtype, n_layers=cfg.n_layers,
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, data_lanes=TRAIN_LANES,
        steps=TRAIN_STEPS, qr_lanes=TRAIN_LANES, panel_width=TRAIN_B,
        reduced=TRAIN_REDUCED, tasks_per_step=len(tasks),
        deterministic="torch.use_deterministic_algorithms(True), "
                      "CUBLAS_WORKSPACE_CONFIG=" + os.environ["CUBLAS_WORKSPACE_CONFIG"],
        failure_free=clean, profiled_step=profiled,
        gram_checked=len(grams), gram_rel_err_max=gram_max,
        kill=dict(**kill, bitwise_equal_failure_free=kill_same),
        async_segments=dict(**asyn, bitwise_equal_failure_free=async_same),
        suspend_resume=dict(**res, bitwise_equal_failure_free=resume_same),
        rebuild=dict(**rebuild, fail=TRAIN_FAIL,
                     bitwise_equal_failure_free=rebuild_same),
        psgd=dict(rank=TRAIN_PSGD_RANK, tasks_per_step=p_tasks,
                  failure_free=p_clean, kill=p_kill,
                  bitwise_equal_failure_free=psgd_same),
        plain_adamw=plain, kernels=kernels, launches_ok=launches_ok,
        card=card)
    losses = clean["losses"]
    check(all(np.isfinite(x) for x in losses), f"train: a loss is not finite {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall {losses}")
    check(gram_max <= GRAM_TOL, f"train Gram identity: {gram_max} > {GRAM_TOL}")
    check(len({s for s, *_ in grams}) == TRAIN_STEPS,
          "train: a step without a Gram-checked sweep")
    check(kill_same, "train: the mid-sweep kill changed params or losses")
    check(killer.struck is not None and killer.struck[:2] == (
        TRAIN_KILL["at_step"], TRAIN_KILL["task"]), f"train: kill struck {killer.struck}")
    check(len(ev) == 1 and ev[0].lane == TRAIN_KILL["lane"] and ev[0].reads
          and TRAIN_KILL["lane"] not in ev[0].reads.values(),
          f"train: not one single-source REBUILD event: {ev}")
    check(kill["steps"] == list(range(TRAIN_STEPS)),
          f"train: the kill rewound training: steps {kill['steps']}")
    check(async_same, "train: async segments differ from sync")
    check(resume_same, "train: suspend/resume differs from the uninterrupted run")
    check(rebuild_same and rebuild["steps"] == [0, 1, 2, 2, 3],
          f"train: the REBUILD replay differs (steps {rebuild['steps']})")
    check(psgd_same, "train: the PowerSGD-bridge kill differs from failure-free")
    check(all(launches_ok.values()), f"train: launches {launches_ok}")
    return report


def moe_configs(seed: int):
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                      global_batch=MOE_BATCH, seed=seed)
    return cfg, dcfg


class RoutingCount:
    """Counts the token assignments that the MoE layers route, and those
    dropped at capacity, while it is entered (it wraps
    ``models.moe.route``; the forward that the backward's checkpoint
    recomputes counts again, which leaves the share as it is)."""

    def __enter__(self):
        self.dropped, self.total = [], 0
        self._route = t_moe.route

        def counted(probs, top_k, capacity_factor):
            r, ids = self._route(probs, top_k, capacity_factor)
            self.dropped.append((~r.keep).sum())
            self.total += r.keep.numel()
            return r, ids

        t_moe.route = counted
        return self

    def __exit__(self, *exc):
        t_moe.route = self._route

    def share(self) -> float:
        return float(torch.stack(self.dropped).sum()) / self.total


def tree_digest(t) -> list:
    """One int64 a tensor leaf: its bits read as integers, weighted by
    their position and summed (wrapping) in chunks on the leaf's device. Two
    trees with the same bits give the same digests; no second copy of the
    tree is made."""
    out, chunk = [], 1 << 26
    for leaf in tree.leaves(t):
        flat = leaf.reshape(-1)
        bits = flat.view({2: torch.int16, 4: torch.int32}[flat.element_size()])
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, bits.numel(), chunk):
            c = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 1000003 + 1
            acc += torch.sum(c * w)
        out.append(int(acc))
    return out


def same_as_host(t, host) -> bool:
    """Every leaf of tree ``t`` bit-equal to ``host``'s (a host copy)."""
    return all(torch.equal(x.cpu(), y)
               for x, y in zip(tree.leaves(t), tree.leaves(host)))


def moe_phase(seed: int, card: str) -> None:
    """The FT training runtime on mixtral-8x22b at its published width (see
    the module docstring), under torch's deterministic mode."""
    t_phase = time.perf_counter()
    # what earlier phases left in reference cycles goes before the trainers
    gc.collect()
    torch.cuda.empty_cache()
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        report = moe_runs(seed, d, card)
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit({"train_moe": report})


def moe_runs(seed: int, d: str, card: str) -> dict:
    cfg, dcfg = moe_configs(seed)
    # the loop pushes its diskless checkpoint at step 0 whatever the period;
    # a period past the last step pushes no other
    tcfg = train_tcfg(d, steps=MOE_STEPS, diskless_every=MOE_STEPS + 1)
    make = lambda hooks=(): FTTrainer(  # noqa: E731
        cfg, tcfg, dcfg, train_fcfg(), qr_fault_hooks=hooks)
    # two trainers do not fit on the card together: each run's trainer is
    # dropped (and its reference cycles collected: hooks and the Gram
    # check hold the trainer) before the next, keeping a host copy of the
    # first run's params and a digest of its optimizer state
    # 1. failure-free, every sweep's R held to the Gram identity
    tr = make()
    tasks = tr._tasks
    shapes = sorted({(t.rows, t.cols) for t in tasks}, reverse=True)
    with RoutingCount() as routed:
        clean = train_run(tr, "train_moe", gram=True, watch=MOE_ROUTER)
    grams, router_q = clean.pop("gram"), clean.pop("watch")
    want_params = tree.map(lambda x: x.cpu(), tr.state.params)
    want_opt = tree_digest(tr.state.opt_state)
    kernels = train_kernel_check(tr.state.opt_state.mom, tasks,
                                 torch.Generator().manual_seed(seed + 5),
                                 MOE_SHAPES)
    del tr
    gc.collect()
    # 2. lane 1 killed mid-sweep inside an expert bank's sweep of step 2:
    # also the determinism check (a second failure-free run repeated it)
    killer = StepSweepKiller(**MOE_KILL)
    tr = make([killer])
    kill = train_run(tr, "train_moe_kill")
    ev = tr.engine.events
    kill_same = (same_as_host(tr.state.params, want_params)
                 and kill["losses"] == clean["losses"])
    kill_opt_same = tree_digest(tr.state.opt_state) == want_opt
    kill.update(struck=killer.struck,
                event_reads=[{str(k): int(v) for k, v in e.reads.items()} for e in ev])
    del tr, want_params
    gc.collect()
    launches_ok = {path: all(PATH_LAUNCHES[path][op] > 0 for op in STEPPED)
                   and PATH_LAUNCHES[path]["panel_qr_apply"] == 0
                   and PATH_LAUNCHES[path]["fused_panel"] == 0
                   for path in ("train_moe", "train_moe_kill")}
    gram_max = max(g for *_, g in grams)
    m = cfg.moe
    N = MOE_BATCH * MOE_SEQ
    report = dict(
        arch=MOE_ARCH, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hdim, n_experts=m.n_experts,
        top_k=m.top_k, d_ff_expert=m.d_ff_expert, vocab=cfg.vocab,
        sliding_window=cfg.sliding_window, rope_theta=cfg.rope_theta,
        dtype=cfg.dtype, n_layers=cfg.n_layers, seq_len=MOE_SEQ,
        global_batch=MOE_BATCH, data_lanes=TRAIN_LANES, steps=MOE_STEPS,
        qr_lanes=TRAIN_LANES, panel_width=TRAIN_B, reduced=MOE_REDUCED,
        tasks_per_step=len(tasks), sweep_shapes=shapes,
        capacity=t_moe.capacity(N, m.top_k, m.n_experts, m.capacity_factor),
        dropped_share=routed.share(),
        deterministic="torch.use_deterministic_algorithms(True), "
                      "CUBLAS_WORKSPACE_CONFIG=" + os.environ["CUBLAS_WORKSPACE_CONFIG"],
        failure_free=clean, gram_checked=len(grams), gram_rel_err_max=gram_max,
        router_q_column_norms=router_q,
        kill=dict(**kill, bitwise_equal_failure_free=kill_same,
                  opt_state_equal_failure_free=kill_opt_same),
        kernels=kernels, launches_ok=launches_ok, card=card)
    losses = clean["losses"]
    check(all(np.isfinite(x) for x in losses), f"train_moe: a loss is not finite {losses}")
    check(len(tasks) == MOE_SWEEPS,
          f"train_moe: {len(tasks)} sweeps a step, not {MOE_SWEEPS}")
    check(gram_max <= GRAM_TOL, f"train_moe Gram identity: {gram_max} > {GRAM_TOL}")
    check(len(grams) == MOE_STEPS * len(tasks),
          f"train_moe: {len(grams)} Gram-checked sweeps")
    check(kill_same and kill_opt_same,
          "train_moe: the mid-sweep kill changed params, optimizer state or losses")
    check(killer.struck is not None and killer.struck[:2] == (
        MOE_KILL["at_step"], MOE_KILL["task"]), f"train_moe: kill struck {killer.struck}")
    check(len(ev) == 1 and ev[0].lane == MOE_KILL["lane"] and ev[0].reads
          and MOE_KILL["lane"] not in ev[0].reads.values(),
          f"train_moe: not one single-source REBUILD event: {ev}")
    check(kill["steps"] == list(range(MOE_STEPS)),
          f"train_moe: the kill rewound training: steps {kill['steps']}")
    check(all(launches_ok.values()), f"train_moe: launches {launches_ok}")
    return report


class StepRecorder:
    """Wraps an engine's ``_prefill`` or ``_step``: keeps each call's
    logits (all of them, or the last only), whether every logit so far is
    finite (a device flag, read after the run), the caches the first call
    was given, and, when ``sync``, each call's seconds between two
    synchronises."""

    def __init__(self, fn, sync: bool, keep_all: bool):
        self.fn, self.sync, self.keep_all = fn, sync, keep_all
        self.seconds, self.logits, self.finite, self.caches = [], [], None, None

    def __call__(self, *args):
        if self.caches is None and len(args) >= 4:
            self.caches = args[3]
        if self.sync:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, caches = self.fn(*args)
        if self.sync:
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
        ok = torch.isfinite(logits).all()
        self.finite = ok if self.finite is None else self.finite & ok
        self.logits = (self.logits + [logits]) if self.keep_all else [logits]
        return logits, caches


def lm_generate(engine: Engine, prompts: np.ndarray, sync: bool, keep_all: bool = False,
                extras=None):
    """One ``Engine.generate`` (with the stub frontends' ``extras``) with its
    prefill and step recorded; the wall seconds end in a synchronise
    (``generate`` returns numpy)."""
    prefill, step = engine._prefill, engine._step
    engine._prefill = rp = StepRecorder(prefill, sync, keep_all)
    engine._step = rs = StepRecorder(step, sync, keep_all)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(prompts, extras)
        seconds = time.perf_counter() - t0
    finally:
        engine._prefill, engine._step = prefill, step
    return out, seconds, rp, rs


def lm_profile(engine: Engine, prompts: np.ndarray, caches, token: np.ndarray,
               steps: int = 3) -> dict:
    """One prefill and ``steps`` decode steps (at the last position the
    run's caches hold, fed the last token) under torch.profiler: wall and
    device ms of each, the card's busy share, device kernels a call and
    the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(prompts).cuda()
    tok = torch.from_numpy(token[:, None]).cuda()
    pos = LM_PROMPT + LM_NEW - 1
    calls = {"prefill": (lambda: engine._prefill(engine.params, {"tokens": tokens}), 1),
             "decode_step": (lambda: engine._step(engine.params, tok, pos, caches), steps)}
    out = {}
    with torch.no_grad():
        for name, (fn, reps) in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / reps
            dev = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            device = sum(_device_us(e) for e in dev) / 1e3 / reps
            top = sorted(dev, key=_device_us, reverse=True)[:5]
            out[name] = dict(
                wall_ms=wall, device_ms=device, busy_share=device / wall,
                kernels=sum(e.count for e in dev) / reps,
                top=[[e.key[:80], _device_us(e) / 1e3 / reps] for e in top])
    return out


def nbytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def lm_serve_phase(seed: int, card: str) -> None:
    """The token engine on gemma2-2b at its published width and depth (see
    the module docstring), under torch's deterministic mode."""
    t_phase = time.perf_counter()
    # what the trainers left in reference cycles goes before the engine
    gc.collect()
    torch.cuda.empty_cache()
    with deterministic_mode():
        report = lm_published(seed)
        gc.collect()
        torch.cuda.empty_cache()
        report["f32_parity"] = lm_parity(seed)
    gc.collect()
    torch.cuda.empty_cache()
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit({"lm_serve": dict(**report, card=card)})


def lm_published(seed: int) -> dict:
    """(a) bf16, B = 4 prompts of 4160 tokens, 32 greedy tokens, twice
    (``served_twice``): besides, the caches' slots; a decode step's bound
    (weights and caches read once) and a profiled prefill and decode."""
    cfg = get_config(LM_ARCH)
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed + 7))
    prompts = np.random.default_rng(seed + 7).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=LM_NEW), device="cuda")
    rec = served_twice(engine, prompts, "lm_serve")
    out, caches = rec.pop("out"), rec.pop("caches")
    slots = cache_slots(cfg, caches, LM_PROMPT + LM_NEW, "lm_serve")
    bms, by = decode_bound(params, caches, LM_BATCH)
    prof = lm_profile(engine, prompts, caches, out[:, -1])
    report = dict(
        arch=LM_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hdim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, sliding_window=cfg.sliding_window,
        dtype=cfg.dtype, params=sum(x.numel() for x in tree.leaves(params)),
        param_bytes=nbytes(params), cache_bytes=nbytes(caches),
        batch=LM_BATCH, prompt_len=LM_PROMPT, max_new_tokens=LM_NEW,
        cache_slots=slots, **rec,
        decode_tokens_per_s=LM_BATCH * 1e3 / rec["decode_ms_median"],
        decode_bound_ms=bms, decode_bound_by=by,
        decode_bytes_per_step=nbytes(params) + nbytes(caches), profile=prof)
    del engine, params, caches
    return report


def lm_parity(seed: int) -> dict:
    """(b) f32 at the same widths and depth, B = 2 prompts of 4160 tokens, 8
    decode steps held to the no-cache forward (``held_against_forward``),
    then the gate's controls (``lm_planted``), each of which must fail it."""
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed + 8))
    prompts = np.random.default_rng(seed + 8).integers(
        0, cfg.vocab, (LM_F32_BATCH, LM_PROMPT)).astype(np.int32)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=LM_F32_STEPS + 1),
                    device="cuda")
    out, seconds, rp, rs = lm_generate(engine, prompts, sync=False, keep_all=True)
    got = [rp.logits[0][:, -1]] + [lg[:, -1] for lg in rs.logits]
    del rp, rs
    t0 = time.perf_counter()
    rec, wants = held_against_forward(cfg, params, prompts, None, out, got,
                                      range(1, LM_F32_STEPS + 1), "lm_serve f32")
    forward_s = time.perf_counter() - t0
    del got
    t0 = time.perf_counter()
    controls = {fault: lm_planted(engine, cfg, prompts, out, wants, fault)
                for fault in LM_FAULTS}
    controls_s = time.perf_counter() - t0
    del engine, params, wants
    check(rec["tokens_held"] > 0,
          "lm_serve f32: no token held (every margin under the limit)")
    for fault, c in controls.items():
        check(max(c["excess_over_rtol"]) > LM_DECODE_TOL[1],
              f"lm_serve f32: the gate passes the planted {fault} fault: {c}")
    return dict(dtype=cfg.dtype, batch=LM_F32_BATCH, prompt_len=LM_PROMPT,
                decode_steps=LM_F32_STEPS, generate_s=seconds,
                no_cache_forwards_s=forward_s, prefill_tol=LM_PREFILL_TOL,
                decode_tol=LM_DECODE_TOL, margin=LM_MARGIN, **rec,
                tokens_compared=LM_F32_BATCH * (LM_F32_STEPS + 1),
                controls=controls, controls_s=controls_s)


def tol_excess(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """The largest ``|got - want| - rtol |want|``: allclose's test,
    ``|got - want| <= atol + rtol |want|``, holds where it is at most atol."""
    return float(((got - want).abs() - rtol * want.abs()).max())


def lm_planted(engine: Engine, cfg, prompts: np.ndarray, out: np.ndarray,
               wants: list, fault: str) -> dict:
    """The decode gate's control: a fresh prefill, the engine's relayout and
    ``LM_F32_STEPS`` steps fed the sound run's tokens, with ``fault``
    planted, each step's logits held to the sound run's no-cache ``wants``.
    ``stale_slot`` writes each step's k/v one slot early, at (pos - 1) %
    S_cache (the slot it should fill stays stale, the one before loses its
    token); ``no_roll`` leaves the local layers' prefill crop unrolled, so
    each step overwrites a token still in the window and keeps one that
    has left it."""
    S0 = prompts.shape[1]
    total = S0 + engine.scfg.max_new_tokens
    update = t_attn.cache_update
    excess, abs_err = [], []
    with torch.no_grad():
        _, caches = engine._prefill(engine.params,
                                    {"tokens": torch.from_numpy(prompts).cuda()})
        caches = engine._relayout(caches, S0, total)
        if fault == "no_roll":
            shift = -(S0 % cfg.sliding_window)
            for i in range(cfg.pattern_period):
                if cfg.mixer_at(i) == "L":
                    caches["groups"][f"l{i}"] = t_attn.KVCache(*(
                        torch.roll(x, shift, dims=-3)
                        for x in caches["groups"][f"l{i}"]))
        elif fault == "stale_slot":
            t_attn.cache_update = lambda c, k, v, pos: update(c, k, v, pos - 1)
        try:
            for t in range(LM_F32_STEPS):
                tok = torch.from_numpy(out[:, t:t + 1]).cuda()
                lg, caches = engine._step(engine.params, tok, S0 + t, caches)
                excess.append(tol_excess(lg[:, -1], wants[t + 1], LM_DECODE_TOL[0]))
                abs_err.append(float((lg[:, -1] - wants[t + 1]).abs().max()))
        finally:
            t_attn.cache_update = update
    return dict(excess_over_rtol=excess, max_abs_err=abs_err)


def decode_bound(params, caches, batch: int):
    """A decode step's bound: the weights and caches read once, 2 FLOPs a
    weight a row."""
    return bound_ms(2.0 * batch * sum(x.numel() for x in tree.leaves(params)),
                    nbytes(params) + nbytes(caches))


def served_twice(engine: Engine, prompts: np.ndarray, path: str, extras=None) -> dict:
    """``generate`` twice, counters at 0 before the first (path ``path``):
    the first synchronised a step, the second not; every logit finite,
    tokens in the vocabulary, the second run bit-equal, K1-K6 not launched.
    Returns prefill seconds, decode ms a token (each step between two
    synchronises), tokens/s (the unsynchronised run), the peak memory, and
    the first run's tokens (``out``) and the caches it decoded on."""
    cfg = engine.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    out, timed_s, rp, rs = lm_generate(engine, prompts, sync=True, extras=extras)
    PATH_LAUNCHES[path] = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    out2, wall_s, rp2, rs2 = lm_generate(engine, prompts, sync=False, extras=extras)
    same = (np.array_equal(out, out2) and torch.equal(rs.logits[-1], rs2.logits[-1])
            and torch.equal(rp.logits[-1], rp2.logits[-1]))
    finite = bool(rp.finite & rs.finite & rp2.finite & rs2.finite)
    B, new = out.shape
    step_ms = np.array(rs.seconds) * 1e3
    check(finite, f"{path}: a logit is not finite")
    check(out.shape == (prompts.shape[0], engine.scfg.max_new_tokens)
          and ((out >= 0) & (out < cfg.vocab)).all(),
          f"{path}: tokens {out.shape} outside the vocabulary")
    check(same, f"{path}: a second generate differs from the first")
    check(not any(PATH_LAUNCHES[path].values()),
          f"{path}: a QR kernel ran {PATH_LAUNCHES[path]}")
    return dict(prefill_s=rp.seconds[0],
                decode_ms_median=float(np.median(step_ms)),
                decode_ms_p90=float(np.percentile(step_ms, 90)),
                decode_steps=len(step_ms), generate_s_timed=timed_s,
                generate_s=wall_s, tokens_per_s=B * new / wall_s,
                peak_memory_bytes=peak, second_run_bitwise_equal=same,
                launches=PATH_LAUNCHES[path], tokens_row0=out[0].tolist(),
                out=out, caches=rs.caches)


def cache_slots(cfg, caches, total: int, what: str) -> dict:
    """Each KV cache's slots, checked: a local layer's are its window, a
    global layer's the prompt and the new tokens."""
    slots = {path: int(x.shape[-3]) for path, x in tree.flatten_with_path(caches)}
    want = {f"groups/l{i}/.{f}": (min(cfg.sliding_window, total)
                                  if cfg.mixer_at(i) == "L" else total)
            for i in range(cfg.pattern_period) for f in "kv"}
    check(slots == want, f"{what}: cache slots {slots}, not {want}")
    return slots


def lm_long_phase(seed: int, card: str) -> None:
    """Prompts of 8192 tokens on gemma2-2b (see the module docstring),
    under torch's deterministic mode."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with deterministic_mode():
        report = lm_long_published(seed)
        gc.collect()
        torch.cuda.empty_cache()
        report["f32_parity"] = lm_long_parity(seed)
        gc.collect()
        torch.cuda.empty_cache()
        report["attention"] = long_attention_check(seed)
    gc.collect()
    torch.cuda.empty_cache()
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit({"lm_long": dict(**report, card=card)})


def lm_long_published(seed: int) -> dict:
    """bf16, B = 2 prompts of 8192 tokens (every layer's prefill streams:
    the local layers visit every chunk up to the causal front and mask the
    window), 16 greedy tokens, twice: finite logits, the second run
    bit-equal, the caches' slots."""
    cfg = get_config(LM_ARCH)
    check(LONG_PROMPT >= cfg.attn_chunk_threshold
          and LONG_PROMPT % cfg.attn_chunk == 0 and cfg.attn_schedule == "scan",
          f"lm_long: a prompt of {LONG_PROMPT} does not stream")
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed + 12))
    prompts = np.random.default_rng(seed + 12).integers(
        0, cfg.vocab, (LONG_BATCH, LONG_PROMPT)).astype(np.int32)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=LONG_NEW), device="cuda")
    rec = served_twice(engine, prompts, "lm_long")
    rec.pop("out")
    caches = rec.pop("caches")
    slots = cache_slots(cfg, caches, LONG_PROMPT + LONG_NEW, "lm_long")
    bms, by = decode_bound(params, caches, LONG_BATCH)
    report = dict(arch=LM_ARCH, n_layers=cfg.n_layers, dtype=cfg.dtype,
                  batch=LONG_BATCH, prompt_len=LONG_PROMPT, max_new_tokens=LONG_NEW,
                  attn_chunk=cfg.attn_chunk, attn_schedule=cfg.attn_schedule,
                  attn_chunk_threshold=cfg.attn_chunk_threshold, cache_slots=slots,
                  cache_bytes=nbytes(caches), decode_bound_ms=bms, decode_bound_by=by,
                  **rec)
    del engine, params, caches
    return report


def held_against_forward(cfg, params, prompts, extras, out, got: list, steps,
                         what: str, forward_cfg=None):
    """The prefill's last logits (got[0]) within ``LM_PREFILL_TOL`` and
    each decode step t in ``steps`` (got[t]) within ``LM_DECODE_TOL`` of
    the no-cache forward (of ``forward_cfg``, default ``cfg``) on the same
    prefix, and each token the no-cache greedy choice where its top-two
    margin exceeds ``LM_MARGIN`` (a row held up to its first step under the
    margin). Returns the records and the no-cache logits."""
    fcfg = forward_cfg or cfg
    ex = {k: torch.from_numpy(v).cuda() for k, v in (extras or {}).items()}
    errs, abs_errs, margins, wants, held = {}, {}, {}, {}, 0
    live = np.ones(prompts.shape[0], bool)
    with torch.no_grad():
        for t in (0,) + tuple(steps):
            toks = np.concatenate([prompts, out[:, :t]], axis=1)
            hidden, _, _ = t_tf.forward(fcfg, params, torch.from_numpy(toks).cuda(), **ex)
            want = t_tf.logits_fn(fcfg, params, hidden[:, -1:])[:, -1]
            del hidden
            wants[t] = want
            rtol, atol = LM_PREFILL_TOL if t == 0 else LM_DECODE_TOL
            excess = tol_excess(got[t], want, rtol)
            errs[t], abs_errs[t] = excess, float((got[t] - want).abs().max())
            check(excess <= atol, f"{what}: step {t} logits off by {excess} over "
                                  f"atol {atol} (rtol {rtol})")
            top2 = torch.topk(want, 2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            best = top2.indices[:, 0].cpu().numpy()
            margins[t] = margin.tolist()
            live &= margin > LM_MARGIN
            if t < out.shape[1]:
                check(bool((out[live, t] == best[live]).all()),
                      f"{what}: step {t} tokens {out[:, t]} not the no-cache "
                      f"greedy {best} (margins {margin})")
                held += int(live.sum())
    return dict(excess_over_rtol=errs, max_abs_err=abs_errs, margins=margins,
                tokens_held=held), wants


def lm_long_parity(seed: int) -> dict:
    """f32, gemma2-2b's published width cut to 4 layers (two L/G periods),
    B = 1 prompt of 8192 tokens: the streaming prefill's last logits within
    ``LM_PREFILL_TOL`` of the same model with the chunk threshold raised
    past the prompt (full attention), and 4 decode steps within
    ``LM_DECODE_TOL`` of that model's no-cache forward on the same prefix
    (a prefix of 8193 or more tokens is not a multiple of the chunk)."""
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32",
                              n_layers=LONG_F32_LAYERS)
    full = dataclasses.replace(cfg, attn_chunk_threshold=LONG_PROMPT + LONG_F32_STEPS + 1)
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed + 13))
    prompts = np.random.default_rng(seed + 13).integers(
        0, cfg.vocab, (1, LONG_PROMPT)).astype(np.int32)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=LONG_F32_STEPS + 1),
                    device="cuda")
    out, seconds, rp, rs = lm_generate(engine, prompts, sync=False, keep_all=True)
    got = [rp.logits[0][:, -1]] + [lg[:, -1] for lg in rs.logits]
    t0 = time.perf_counter()
    rec, _ = held_against_forward(cfg, params, prompts, None, out, got,
                                  range(1, LONG_F32_STEPS + 1), "lm_long f32",
                                  forward_cfg=full)
    rec.update(n_layers=cfg.n_layers, prompt_len=LONG_PROMPT,
               decode_steps=LONG_F32_STEPS, generate_s=seconds,
               no_cache_forwards_s=time.perf_counter() - t0,
               reference="the same model at attn_chunk_threshold "
                         f"{full.attn_chunk_threshold} (full attention)")
    del engine, params, got, rp, rs
    return rec


def long_attention_check(seed: int) -> dict:
    """``chunked_attention`` in both schedules against ``full_attention``
    at gemma2's head geometry (B = 1, S = 8192, 8 heads, 4 kv heads, head
    dim 256, softcap 50), with its window of 4096 and without: the output
    and the gradients of a weighted sum with respect to q, k and v, within
    ``LONG_ATTN_TOL`` scaled by max |want|; seconds of each forward and
    backward."""
    a = LONG_ATTN
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    shapes = ((a["B"], a["S"], a["H"], a["Dh"]), (a["B"], a["S"], a["Kv"], a["Dh"]),
              (a["B"], a["S"], a["Kv"], a["Dh"]), (a["B"], a["S"], a["H"], a["Dh"]))
    q, k, v, w = (torch.randn(s, generator=g, device="cuda") for s in shapes)
    out = {}
    for window in (a["window"], None):
        runs = {}
        for name in ("full", "tri", "scan"):
            x = [t.clone().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "full":
                o = t_attn.full_attention(*x, n_kv=a["Kv"], window=window, cap=a["cap"])
            else:
                o = t_attn.chunked_attention(
                    *x, n_kv=a["Kv"], window=window, cap=a["cap"],
                    q_chunk=get_config(LM_ARCH).attn_chunk,
                    kv_chunk=get_config(LM_ARCH).attn_chunk, schedule=name)
            torch.sum(o * w).backward()
            torch.cuda.synchronize()
            runs[name] = (time.perf_counter() - t0,
                          [o.detach()] + [t.grad for t in x])
            del o, x
        want = runs["full"][1]
        for name in ("tri", "scan"):
            err, scaled = max_err(runs[name][1], want)
            key = f"window_{window}_{name}"
            out[key] = dict(max_abs_err=err, scaled_err=scaled,
                            seconds=runs[name][0], full_seconds=runs["full"][0])
            check(scaled <= LONG_ATTN_TOL[0],
                  f"lm_long attention {key}: scaled error {scaled}")
        del runs, want
    return dict(shape=a, tol=LONG_ATTN_TOL, runs=out)


def family_extras(cfg, rng, batch: int) -> dict:
    """The stub frontends' inputs as ``launch.serve`` draws them (float32):
    a VLM's patch embeddings, an encoder-decoder model's frame embeddings."""
    out = {}
    if cfg.vlm is not None:
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["enc_frames"] = rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return out


def lm_families_phase(seed: int, card: str) -> None:
    """The four families of the SSM, RG-LRU, encoder and VLM mixers (see the
    module docstring), one at a time, under torch's deterministic mode."""
    t_phase = time.perf_counter()
    report = {}
    with deterministic_mode():
        for i, (arch, spec) in enumerate(FAMILIES.items()):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rec = family_published(arch, spec, seed + 20 + i)
            gc.collect()
            torch.cuda.empty_cache()
            rec["f32_parity"] = family_parity(arch, spec, seed + 30 + i)
            rec["seconds"] = time.perf_counter() - t0
            report[arch] = rec
    gc.collect()
    torch.cuda.empty_cache()
    emit({"lm_families": dict(families=report, reduced=FAMILY_REDUCED,
                              phase_seconds=time.perf_counter() - t_phase, card=card)})


def family_published(arch: str, spec: dict, seed: int) -> dict:
    """bf16 at the published width and depth, B = 2 prompts, 16 greedy
    tokens, twice (``served_twice``): besides, the caches' shapes and
    dtypes those of ``init_caches``; the decode step's bound."""
    cfg = get_config(arch)
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (FAMILY_BATCH, spec["prompt"])).astype(np.int32)
    extras = family_extras(cfg, rng, FAMILY_BATCH)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=FAMILY_NEW), device="cuda")
    rec = served_twice(engine, prompts, spec["path"], extras or None)
    rec.pop("out")
    caches = rec.pop("caches")
    layout = lambda t: {p: (list(x.shape), str(x.dtype))  # noqa: E731
                        for p, x in tree.flatten_with_path(t)}
    got = layout(caches)
    want = layout(t_tf.init_caches(cfg, FAMILY_BATCH, spec["prompt"] + FAMILY_NEW,
                                   device="meta"))
    bms, by = decode_bound(params, caches, FAMILY_BATCH)
    report = dict(path=spec["path"], family=cfg.family, n_layers=cfg.n_layers,
                  d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
                  params=sum(x.numel() for x in tree.leaves(params)),
                  param_bytes=nbytes(params), cache_bytes=nbytes(caches),
                  batch=FAMILY_BATCH, prompt_len=spec["prompt"],
                  extras={k: list(v.shape) for k, v in extras.items()},
                  max_new_tokens=FAMILY_NEW, cache_layout=got,
                  decode_bound_ms=bms, decode_bound_by=by, **rec)
    del engine, params, caches
    check(got == want, f"{arch}: caches {got}, not init_caches' {want}")
    return report


def family_parity(arch: str, spec: dict, seed: int) -> dict:
    """f32 at the published width cut in depth: the prefill's and the held
    decode steps' logits against the no-cache forward
    (``held_against_forward``); then, for a recurrent mixer, the gate's
    control: the same steps replayed with every conv tail zeroed before
    step ``plant_at`` must fail it."""
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              n_layers=spec["f32_layers"])
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (FAMILY_BATCH, spec["f32_prompt"])).astype(np.int32)
    extras = family_extras(cfg, rng, FAMILY_BATCH)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=spec["f32_steps"] + 1),
                    device="cuda")
    out, seconds, rp, rs = lm_generate(engine, prompts, sync=False, keep_all=True,
                                       extras=extras or None)
    got = [rp.logits[0][:, -1]] + [lg[:, -1] for lg in rs.logits]
    del rp, rs
    t0 = time.perf_counter()
    rec, wants = held_against_forward(cfg, params, prompts, extras, out, got,
                                      spec["held"], f"{arch} f32")
    rec.update(n_layers=cfg.n_layers, prompt_len=spec["f32_prompt"],
               decode_steps=spec["f32_steps"], held_steps=list(spec["held"]),
               generate_s=seconds, no_cache_forwards_s=time.perf_counter() - t0)
    del got
    if spec["plant_at"] is not None:
        control = family_planted(engine, prompts, extras, out, wants, spec)
        rec["control_zeroed_conv_tail"] = control
        check(max(control["excess_over_rtol"].values()) > LM_DECODE_TOL[1],
              f"{arch} f32: the gate passes a zeroed conv tail: {control}")
    del engine, params, wants
    return rec


def family_planted(engine: Engine, prompts, extras, out, wants: dict, spec: dict) -> dict:
    """A fresh prefill and relayout, then the sound run's tokens fed step by
    step with every SSM and LRU conv tail zeroed before step ``plant_at``;
    each held step's logits against the sound run's no-cache ``wants``."""
    S0 = prompts.shape[1]
    batch = {"tokens": torch.from_numpy(prompts).cuda(),
             **{k: torch.from_numpy(v).cuda() for k, v in extras.items()}}
    excess, abs_err = {}, {}
    with torch.no_grad():
        enc = (() if "enc_frames" not in batch
               else (t_tf.encode(engine.cfg, engine.params, batch["enc_frames"]),))
        _, caches = engine._prefill(engine.params, batch)
        caches = engine._relayout(caches, S0, S0 + engine.scfg.max_new_tokens)
        for t in range(max(spec["held"])):
            if t == spec["plant_at"]:
                for path, x in tree.flatten_with_path(caches):
                    if path.endswith("/.conv"):
                        x.zero_()
            tok = torch.from_numpy(out[:, t:t + 1]).cuda()
            lg, caches = engine._step(engine.params, tok, S0 + t, caches, *enc)
            if t + 1 in spec["held"]:
                excess[t + 1] = tol_excess(lg[:, -1], wants[t + 1], LM_DECODE_TOL[0])
                abs_err[t + 1] = float((lg[:, -1] - wants[t + 1]).abs().max())
    return dict(plant_at=spec["plant_at"], excess_over_rtol=excess, max_abs_err=abs_err)


def train_families_phase(seed: int, card: str) -> None:
    """The two new mixers through the FT training runtime (see the module
    docstring), under torch's deterministic mode."""
    t_phase = time.perf_counter()
    report = {}
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        for i, (arch, spec) in enumerate(TRAIN_FAMILIES.items()):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            report[arch] = train_family(arch, spec, seed + 40 + i, d)
            report[arch]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    emit({"train_families": dict(families=report, reduced=TRAIN_FAMILY_REDUCED,
                                 phase_seconds=time.perf_counter() - t_phase,
                                 card=card)})


def train_family(arch: str, spec: dict, seed: int, d: str) -> dict:
    """``caqr_muon`` through ``FTTrainer`` at ``arch``'s published width cut
    to ``spec["layers"]``: failure-free (path ``spec["path"]``, every sweep's
    R held to the Gram identity), then with a lane killed inside a sweep of
    step 1 (path ``+ "_kill"``): params, optimizer state and losses
    bit-equal to the failure-free run, one single-source REBUILD event;
    K1-K4 at the path's shapes against their plain versions."""
    cfg = dataclasses.replace(get_config(arch), n_layers=spec["layers"])
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      seed=seed)
    tcfg = train_tcfg(d, steps=TRAIN_FAMILY_STEPS,
                      diskless_every=TRAIN_FAMILY_STEPS + 1)
    make = lambda hooks=(): FTTrainer(  # noqa: E731
        cfg, tcfg, dcfg, train_fcfg(), qr_fault_hooks=hooks)
    path = spec["path"]
    tr = make()
    tasks = tr._tasks
    clean = train_run(tr, path, gram=True)
    grams = clean.pop("gram")
    want_params = tree.map(lambda x: x.cpu(), tr.state.params)
    want_opt = tree_digest(tr.state.opt_state)
    kernels = train_kernel_check(tr.state.opt_state.mom, tasks,
                                 torch.Generator().manual_seed(seed), spec["shapes"])
    # the two trainers do not fit together: the first one's memory goes
    # back to the card before the second is made
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    killer = StepSweepKiller(**spec["kill"])
    tr = make([killer])
    kill = train_run(tr, path + "_kill")
    ev = tr.engine.events
    kill_same = (same_as_host(tr.state.params, want_params)
                 and tree_digest(tr.state.opt_state) == want_opt
                 and kill["losses"] == clean["losses"])
    kill.update(struck=killer.struck,
                event_reads=[{str(k): int(v) for k, v in e.reads.items()} for e in ev])
    del tr, want_params
    gc.collect()
    launches_ok = {p: all(PATH_LAUNCHES[p][op] > 0 for op in STEPPED)
                   and PATH_LAUNCHES[p]["panel_qr_apply"] == 0
                   and PATH_LAUNCHES[p]["fused_panel"] == 0
                   for p in (path, path + "_kill")}
    gram_max = max(g for *_, g in grams)
    report = dict(
        path=path, family=cfg.family, d_model=cfg.d_model, vocab=cfg.vocab,
        dtype=cfg.dtype, n_layers=cfg.n_layers, mixer_pattern=cfg.mixer_pattern,
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, data_lanes=TRAIN_LANES,
        steps=TRAIN_FAMILY_STEPS, qr_lanes=TRAIN_LANES, panel_width=TRAIN_B,
        tasks_per_step=len(tasks),
        sweep_shapes=sorted({(t.rows, t.cols) for t in tasks}, reverse=True),
        failure_free=clean, gram_checked=len(grams), gram_rel_err_max=gram_max,
        kill=dict(**kill, bitwise_equal_failure_free=kill_same),
        kernels=kernels, launches_ok=launches_ok)
    losses = clean["losses"]
    check(all(np.isfinite(x) for x in losses), f"{path}: a loss is not finite {losses}")
    check(gram_max <= GRAM_TOL, f"{path} Gram identity: {gram_max} > {GRAM_TOL}")
    check(len(grams) == TRAIN_FAMILY_STEPS * len(tasks),
          f"{path}: {len(grams)} Gram-checked sweeps")
    check(kill_same, f"{path}: the mid-sweep kill changed params, optimizer "
                     "state or losses")
    check(killer.struck is not None
          and killer.struck[:2] == (spec["kill"]["at_step"], spec["kill"]["task"]),
          f"{path}: kill struck {killer.struck}")
    check(len(ev) == 1 and ev[0].lane == spec["kill"]["lane"] and ev[0].reads
          and spec["kill"]["lane"] not in ev[0].reads.values(),
          f"{path}: not one single-source REBUILD event: {ev}")
    check(all(launches_ok.values()), f"{path}: launches {launches_ok}")
    return report


def multi_process_phases(seed: int, card: str) -> None:
    """train_mesh and train_pod on one group of ranks, closed after them
    (see the module docstring)."""
    t0 = time.perf_counter()
    group = spmd_qr.make_lane_group(MESH_RANKS, timeout_s=SPMD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    try:
        with deterministic_mode(), tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            report = train_mesh_runs(seed + 60, d, group)
            report.update(phase_seconds=time.perf_counter() - t0,
                          spawn_seconds=spawn_s, card=card)
            emit({"train_mesh": report})
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            report = train_pod_runs(seed + 70, group)
            report.update(phase_seconds=time.perf_counter() - t0, card=card)
            emit({"train_pod": report})
    finally:
        group.close()
    check(not any(p.is_alive() for p in group._procs),
          "a rank outlived its group")
    gc.collect()
    torch.cuda.empty_cache()


def rank_launches(reports, parent: dict) -> dict:
    """A path's launches: the ranks' counters summed by kernel, and this
    process's (counted from 0 before the path)."""
    return {op: sum(r.launches[op] for r in reports) + parent.get(op, 0)
            for op in backend.OPS}


def rank_account(reports) -> list:
    return [dict(rank=r.rank, seconds=r.seconds, launches=r.launches,
                 collectives=r.staged["collectives"],
                 collective_seconds=r.staged["seconds"],
                 bytes_sent=r.staged["bytes_sent"],
                 bytes_d2h=r.staged["bytes_d2h"]) for r in reports]


def train_mesh_runs(seed: int, d: str, group) -> dict:
    """``caqr_muon`` through ``FTTrainer(FTRunConfig(use_mesh=True))`` on a
    lane mesh over ``group``: one step failure-free and one with a kill
    inside a sweep, against the same step on the SimComm engine."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    tcfg = train_tcfg(d, steps=MESH_STEPS)
    mesh = spmd_qr.make_lane_mesh(TRAIN_LANES, group=group)
    fcfg = lambda **kw: FTRunConfig(qr_lanes=TRAIN_LANES, panel_width=MESH_B,  # noqa: E731
                                    **kw)
    runs, finals = {}, {}
    killer = StepSweepKiller(**MESH_KILL)
    for path, hooks in (("train_mesh", ()), ("train_mesh_kill", [killer])):
        tr = FTTrainer(cfg, tcfg, dcfg, fcfg(use_mesh=True),
                       qr_fault_hooks=hooks, mesh=mesh)
        tasks = tr._tasks
        # every sweep's R of the failure-free run held to the Gram identity
        # of its momentum slice
        rec = train_run(tr, path, gram=not hooks)
        e = tr.engine
        PATH_LAUNCHES[path] = rank_launches(e.rank_reports, PATH_LAUNCHES[path])
        # the wide routes' inner kernels (b = 256), the ranks' and this
        # process's (REBUILD's one-lane replay)
        PATH_SUB[path] = {k: backend.SUB_LAUNCHES[k] + sum(
            r.launches[k] for r in e.rank_reports) for k in backend.SUB_KERNELS}
        pts = e.step_stats["points"]
        rec.update(points=pts, runner=e.step_stats,
                   point_ms=1e3 * e.step_stats["seconds"] / pts,
                   point_rank_wait_ms=1e3 * e.step_stats["rank_seconds"] / pts,
                   ranks=rank_account(e.rank_reports),
                   event_reads=[{str(k): int(v) for k, v in ev.reads.items()}
                                for ev in e.events])
        for r in e.rank_reports:
            check(all(r.launches[op] > 0 for op in STEPPED),
                  f"{path}: rank {r.rank} did not launch K1-K4: {r.launches}")
        runs[path], finals[path] = rec, (tr.state.params, tr.state.opt_state,
                                         list(e.events))
        del tr
    sim = FTTrainer(cfg, tcfg, dcfg, fcfg())
    sim_rec = train_run(sim)
    (p_ff, o_ff, _), (p_k, o_k, ev) = finals["train_mesh"], finals["train_mesh_kill"]
    ff, kill = runs["train_mesh"], runs["train_mesh_kill"]
    grams = ff.pop("gram")
    gram_max = max(g for *_, g in grams)
    # the ranks' K1-K4 (the wide routes at b = 256) at the sweeps' shapes
    # on the failure-free step's momentum, in this process
    kernels = train_kernel_check(o_ff.mom, tasks, torch.Generator().manual_seed(seed),
                                 MESH_SHAPES, random=False)
    sim_same = (same_tree(p_ff, sim.state.params) and same_tree(o_ff, sim.state.opt_state)
                and ff["losses"] == sim_rec["losses"])
    kill_same = (same_tree(p_k, p_ff) and same_tree(o_k, o_ff)
                 and kill["losses"] == ff["losses"])
    del sim, finals
    launches_ok = {p: all(PATH_LAUNCHES[p][op] > 0 for op in STEPPED)
                   and PATH_LAUNCHES[p]["panel_qr_apply"] == 0
                   and PATH_LAUNCHES[p]["fused_panel"] == 0
                   and PATH_SUB[p]["wide_gemm_kernel"] > 0
                   for p in ("train_mesh", "train_mesh_kill")}
    report = dict(
        arch=TRAIN_ARCH, d_model=cfg.d_model, n_layers=cfg.n_layers,
        dtype=cfg.dtype, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        data_lanes=TRAIN_LANES, qr_lanes=TRAIN_LANES, ranks=group.size,
        panel_width=MESH_B, steps=MESH_STEPS, reduced=MESH_REDUCED,
        failure_free=ff, kill=dict(**kill, struck=killer.struck),
        simcomm=sim_rec, bitwise_equal_simcomm=sim_same,
        kill_bitwise_equal_failure_free=kill_same, gram_checked=len(grams),
        gram_rel_err_max=gram_max, kernels=kernels, launches_ok=launches_ok)
    check(all(np.isfinite(x) for x in ff["losses"]), f"train_mesh: losses {ff['losses']}")
    check(gram_max <= GRAM_TOL, f"train_mesh Gram identity: {gram_max} > {GRAM_TOL}")
    check(len(grams) == MESH_STEPS * len(tasks),
          f"train_mesh: {len(grams)} Gram-checked sweeps")
    check(sim_same, "train_mesh: the mesh trainer differs from the SimComm trainer")
    check(kill_same, "train_mesh: the kill changed params, optimizer state or losses")
    check(killer.struck is not None and killer.struck[:2] == (
        MESH_KILL["at_step"], MESH_KILL["task"]), f"train_mesh: kill struck {killer.struck}")
    check(len(ev) == 1 and ev[0].lane == MESH_KILL["lane"] and ev[0].reads
          and MESH_KILL["lane"] not in ev[0].reads.values(),
          f"train_mesh: not one single-source REBUILD event: {ev}")
    check(all(launches_ok.values()), f"train_mesh: launches {launches_ok}")
    return report


def train_pod_runs(seed: int, group) -> dict:
    """``make_pod_train_step`` over the first ``POD_PODS`` ranks of
    ``group``, at compression rank ``POD_RANK`` and 0, each step held to
    the same step on two threads of this process."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=POD_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=POD_PODS * POD_BATCH, seed=seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in make_batch(dcfg, s).items()}
               for s in range(POD_STEPS)]
    params = t_tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    opt = adamw()
    psgd = powersgd.init_state(torch.Generator(device="cuda").manual_seed(seed + 1),
                               params, rank=POD_RANK)
    state0 = PodTrainState(params, opt.init(params), psgd,
                           torch.zeros((), dtype=torch.int32))
    del params, psgd
    meshes = (compat.make_mesh((POD_PODS,), ("pod",), group=group),
              compat.make_mesh((POD_PODS,), ("pod",), threads=True))
    runs = {}
    # the path's launches are the ranks' (each call's counted from 0 in the
    # rank); the emulation's in this process only compare
    launches = {op: 0 for op in backend.OPS}
    for rank in (POD_RANK, 0):
        ranks_step, emu_step = (make_pod_train_step(cfg, opt, constant(POD_LR), m,
                                                    compression_rank=rank)
                                for m in meshes)
        s_r = state0
        steps = []
        try:
            for s, batch in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s_r, m_r = ranks_step(s_r, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                reps = ranks_step.reports
                launches = rank_launches(reps, launches)
                pods = ranks_step.rank_states()
                across = same_tree(pods[0].params, pods[1].params)
                steps.append(dict(
                    seconds=dt, loss=float(m_r["loss"]), ranks=rank_account(reps),
                    rank_peak_gb=[b / 1e9 for b in ranks_step.peak_bytes],
                    params_equal_across_pods=across))
                check(across, f"train_pod rank {rank} step {s}: pods' params differ")
                if s == 0:
                    # the emulation repeats the first step only: a later
                    # step runs the same code from the state it checked
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    s_e, m_e = emu_step(state0, batch)
                    torch.cuda.synchronize()
                    emu_same = (same_tree(s_r, s_e)
                                and float(m_r["loss"]) == float(m_e["loss"])
                                and all(same_tree(a, b) for a, b in
                                        zip(pods, emu_step.rank_states())))
                    steps[-1].update(
                        emulation_seconds=time.perf_counter() - t0,
                        emulation_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        bitwise_equal_emulation=emu_same)
                    check(emu_same, f"train_pod rank {rank} step {s}: the ranks "
                                    "differ from the one-process emulation")
                del pods
                check(np.isfinite(float(m_r["loss"])),
                      f"train_pod rank {rank} step {s}: loss {float(m_r['loss'])}")
        finally:
            ranks_step.close()
        del s_r, s_e, emu_step
        gc.collect()
        torch.cuda.empty_cache()
        runs[f"rank_{rank}"] = steps
    PATH_LAUNCHES["train_pod"] = launches
    check(PATH_LAUNCHES["train_pod"]["panel_qr"] > 0,
          f"train_pod: K1 not launched: {PATH_LAUNCHES['train_pod']}")
    g = torch.Generator().manual_seed(seed + 2)
    k1 = [k1_record(torch.randn(m, b, generator=g).cuda(), 0, 20) for m, b in POD_K1]
    sent = {k: [r["bytes_sent"] for r in v[0]["ranks"]] for k, v in runs.items()}
    return dict(arch=TRAIN_ARCH, d_model=cfg.d_model, n_layers=cfg.n_layers,
                dtype=cfg.dtype, pods=POD_PODS, per_pod_batch=POD_BATCH,
                seq_len=TRAIN_SEQ, compression_rank=POD_RANK, steps=POD_STEPS,
                reduced=POD_REDUCED, runs=runs, bytes_sent_per_rank_step=sent,
                compression_ratio=(sum(sent["rank_0"]) / sum(sent[f"rank_{POD_RANK}"])),
                k1_chain=k1)


def wide_record(op: str, args: tuple, cost: tuple, lib, reps: int) -> dict:
    """One kernel above 128 columns against its plain version (within the
    tolerance, scaled as ``max_err`` scales it): events' time, device time
    (every kernel of the blocked route, glue included), bound, plain time
    (one call) and the library call's time."""
    run = lambda: getattr(ops, op)(*args)  # noqa: E731
    composed = COMPOSED.get(op)
    with OrderOracle() as oracle:
        got = as_tuple(run())
        one = composed is not None and same_bits(got, composed(*args))
    check(composed is None or one,
          f"wide {op}: the one launch differs from the composed route")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = as_tuple(getattr(ref, op)(*args))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, scaled = max_err(got, want)
    del got, want
    tol = ref.tolerances(torch.float32)[0]
    shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
    check(scaled <= tol, f"wide {op} at {shapes}: scaled error {scaled} over {tol}")
    bms, by = bound_ms(*cost)
    rs = args[1] if op == "panel_qr" else None
    source, replaces = KERNELS[op]
    rec = dict(name=op, route="cuda", source=source,
               blocked_route="src/repro_torch/kernels/wide.py",
               replaces=replaces, shapes=shapes,
               row_start=rs.tolist() if torch.is_tensor(rs) else rs,
               products_held_to_oracle=oracle.summary(),
               max_abs_err=err, scaled_err=scaled, tolerance=tol,
               ms=time_ms(run, reps), device_ms=device_ms(run, reps),
               bound_ms=bms, bound_by=by, plain_ms=plain_ms,
               library_ms=time_ms(lib, reps),
               library_device_ms=device_ms(lib, reps))
    if composed is not None:
        # K1's one wide launch (K3: on the stacks) beside the composed route
        m, b = args[0].shape[-2:]
        P = args[0].shape[0] if args[0].dim() == 3 else 1
        cluster, grid = tpq.wide_launch_shape(
            P, 2 * b if op == "stacked_qr" else m, b)
        rec.update(source=WIDE_K1_SOURCE, cluster=cluster, grid=grid,
                   ptxas={**ptxas(WIDE_K1_SOURCE, "panel_qr_wide_kernel"),
                          **ptxas(WIDE_K1_SOURCE, "panel_qr_wide_global_kernel")},
                   equals_composed=one,
                   composed_ms=time_ms(lambda: composed(*args), reps),
                   composed_device_ms=device_ms(lambda: composed(*args), reps))
    return rec


def wide_kernels(A: torch.Tensor, g: torch.Generator) -> tuple:
    """K1-K4 at b = 256 on the tall cell's first panel and at the Muon
    path's K1 shapes, against their plain versions and timed; the bitwise
    contracts at b = 256. Returns (records, contracts)."""
    b, dev, f = WIDE_B, A.device, 4.0
    panel = A[..., :b].contiguous()
    k_last = N // b - 1
    rs_last = panel_geometry(SimComm(P), k_last, b, M_LOC)[2]
    recs = [wide_record("panel_qr", (panel, 0), leaf_cost(P, M_LOC, b, 0),
                        lambda: torch.geqrf(panel), 5)]
    rs0 = int(rs_last[0])
    # the last panel: lane 0 from row rs0, the others from row 0
    late = [leaf_cost(1, M_LOC, b, int(r)) for r in rs_last]
    recs.append(wide_record(
        "panel_qr", (panel, rs_last), tuple(map(sum, zip(*late))),
        lambda: (torch.geqrf(panel[1:]), torch.geqrf(panel[0, rs0:])), 10))
    for name, (m, bb) in MUON_K1.items():
        X = torch.randn(m, bb, generator=g).to(dev)
        rec = wide_record("panel_qr", (X, 0), leaf_cost(1, m, bb, 0),
                          lambda: torch.geqrf(X), 3 if bb > 1024 else 10)
        recs.append(dict(rec, muon_matrix=name))
        del X
    X = torch.randn(1000, 200, generator=g).to(dev)
    recs.append(wide_record("panel_qr", (X, 37), leaf_cost(1, 1000, 200, 37),
                            lambda: torch.geqrf(X[37:]), 10))
    Y, T, R = ops.panel_qr(panel, 0)
    Tr = (torch.randn(P, b, b, generator=g) / 16).triu().to(dev)
    for T_, which in ((T, "T of Y"), (Tr, "random upper-triangular T")):
        rec = wide_record("wy_apply", (Y, T_, A), wy_cost(P, M_LOC, b, N),
                          lambda: wy_library(Y, T_, A), 5)
        recs.append(dict(rec, t_factor=which))
    pairs = [p ^ 1 for p in range(P)]
    R_bot = R[pairs].contiguous()
    stack = torch.cat([R, R_bot], dim=1)
    recs.append(wide_record("stacked_qr", (R, R_bot),
                            (P * float(b ** 3), f * P * 5 * b * b),
                            lambda: torch.geqrf(stack), 10))
    Y2, T2, _ = ops.stacked_qr(R, R_bot)
    Ct = ops.wy_apply(Y, T, A)[:, :b].contiguous()
    Cb = Ct[pairs].contiguous()
    rec = wide_record("stacked_apply", (Y2, Tr, Ct, Cb), sa_cost(P, b, N),
                      lambda: sa_library(Y2, Tr, Ct, Cb), 10)
    recs.append(dict(rec, t_factor="random upper-triangular T"))
    # the bitwise contracts at b = 256
    k = P - 3
    one_k1 = same_bits(tuple(x[k] for x in ops.panel_qr(panel, rs_last)),
                       ops.panel_qr(panel[k], int(rs_last[k])))
    one_k2 = torch.equal(ops.wy_apply(Y, Tr, A)[k], ops.wy_apply(Y[k], Tr[k], A[k]))
    one_k4 = all(torch.equal(a[k], o) for a, o in zip(
        ops.stacked_apply(Y2, Tr, Ct, Cb), ops.stacked_apply(Y2[k], Tr[k], Ct[k], Cb[k])))
    pair = ops.stacked_qr(R[[p & ~1 for p in range(P)]].contiguous(),
                          R[[p | 1 for p in range(P)]].contiguous())
    pair_k3 = all(torch.equal(x[p], x[p ^ 1]) for x in pair for p in range(P))
    bn_k2 = same_bits(twy.wy_apply(Y, Tr, A, bn=32), twy.wy_apply(Y, Tr, A, bn=128))
    bn_k4 = same_bits(tsa.stacked_apply(Y2, Tr, Ct, Cb, bn=32),
                      tsa.stacked_apply(Y2, Tr, Ct, Cb, bn=128))
    contracts = dict(one_lane_k1=one_k1, one_lane_k2=one_k2, one_lane_k4=one_k4,
                     pair_k3=pair_k3, bn_k2=bn_k2, bn_k4=bn_k4)
    check(all(contracts.values()), f"wide: bitwise contracts {contracts}")
    # K5 and K6 at b = 256: one launch each, bit-equal to the stepped wide
    # route, timed beside their plain versions and the stepped route
    C = ops.wy_apply(Y, T, A)
    contracts["k5_equals_k1_k2"] = same_bits(ops.panel_qr_apply(A, 0, b),
                                             (Y, T, R, C, C[:, :b]))
    check(contracts["k5_equals_k1_k2"], "wide: K5 differs from K1 then K2")
    del C
    recs += fused_wide_records(A)
    return recs, contracts


# the composed routes of K1 and K3 above 128 columns (separate launches of
# K1's team kernel and wide_gemm): the bit oracle and time yardstick of
# K1's one wide launch
COMPOSED = {"panel_qr": tpq.panel_qr_composed,
            "stacked_qr": tsa.stacked_qr_composed}
WIDE_K1_SOURCE = "src/repro_torch/csrc/panel_qr_wide.cu"


class OrderOracle:
    """Holds every ``wide.gemm`` call inside it to the oracle of the
    summation order (``wide.gemm_order``) and to K5/K6's in-block
    instantiation (``fused_sweep.gemm_in_block``) on the same operands, bit
    for bit; the calls run unchanged."""

    def __init__(self):
        self.shapes = {}

    def __enter__(self):
        self.gemm = wide.gemm

        def checked(A, B, D=None, *, sub=False, out=None, bn=None,
                    minuend=None, kbs=None, out_dtype=None):
            res = self.gemm(A, B, D, sub=sub, out=out, bn=bn, minuend=minuend,
                            kbs=kbs, out_dtype=out_dtype)
            kw = dict(sub=sub, minuend=minuend)
            want = as_tuple(wide.gemm_order(A, B, D, **kw))
            fused = as_tuple(tfs.gemm_in_block(A, B, D, **kw))
            key = str([list(A.shape), list(B.shape), D is not None, sub,
                       minuend is not None])
            check(same_bits(res, want) and same_bits(fused, want),
                  f"wide_gemm or the in-block routine differs from the order "
                  f"oracle at {key}")
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return res

        wide.gemm = checked
        return self

    def __exit__(self, *exc):
        wide.gemm = self.gemm

    def summary(self) -> dict:
        return dict(products=sum(self.shapes.values()), shapes=len(self.shapes))


def fused_wide_records(A: torch.Tensor) -> list:
    """K5 and K6 at b = 256 on the tall cell's first window: within the
    tolerance of their plain versions, timed (events, device time) beside
    their bound, the plain version and the stepped wide route doing the
    same work, with the wide kernel's shared memory, blocks per SM and
    registers. The bound counts K6's FLOPs as the kernel's b = 128 record
    counts them."""
    b, comm, f = WIDE_B, SimComm(P), 4.0
    tol = ref.tolerances(torch.float32)[0]
    leaf_f = leaf_cost(1, M_LOC, b, 0)[0]
    apply_f = 4.0 * M_LOC * b * N + b * b * N

    def k1_k2():
        Yl, Tl, _ = ops.panel_qr(A[..., :b], 0)
        return ops.wy_apply(Yl, Tl, A)

    s0 = sm.initial_sweep_state(comm, A, b)
    pts = sm.panel_points(s0.geom)
    cases = {
        "panel_qr_apply": dict(
            run=lambda: ops.panel_qr_apply(A, 0, b),
            plain=lambda: ref.panel_qr_apply(A, 0, b), stepped=k1_k2,
            stepped_route="K1+K2 wide (panel_qr, wy_apply)", levels=0,
            flops=P * (leaf_f + apply_f),
            nbytes=f * P * (2 * M_LOC * N + M_LOC * b + 2 * b * b + b * N)),
        "fused_panel": dict(
            run=lambda: ops.fused_panel(A, 0, b=b, m_loc_pad=M_LOC, levels=L),
            plain=lambda: ref.fused_panel(A, 0, b=b, m_loc_pad=M_LOC, levels=L),
            stepped=lambda: sm.run_steps(comm, s0, pts),
            stepped_route="the stepped wide panel (K1, 3 x K3, K2, 3 x K4)",
            levels=L,
            flops=P * (leaf_f + apply_f + L * (b ** 3 + 3.0 * b * b * N)),
            nbytes=f * P * (2 * M_LOC * N + M_LOC * b + (3 + 2 * L) * b * b
                            + (1 + 3 * L) * b * N)),
    }
    recs = []
    for name, c in cases.items():
        got = as_tuple(c["run"]())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = as_tuple(c["plain"]())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, scaled = max_err(got, want)
        del got, want
        check(scaled <= tol, f"wide {name}: scaled error {scaled} over {tol}")
        bms, by = bound_ms(c["flops"], c["nbytes"])
        source = "src/repro_torch/csrc/fused_sweep.cu"  # fused_wide_kernel
        recs.append(dict(
            name=name, route="cuda", source=source, replaces=KERNELS[name][1],
            shapes=[list(A.shape)], b=b, max_abs_err=err, scaled_err=scaled,
            tolerance=tol, ms=time_ms(c["run"], 5),
            device_ms=device_ms(c["run"], 5, "fused_wide_kernel"),
            bound_ms=bms, bound_by=by, plain_ms=plain_ms, library_ms=None,
            stepped_ms=time_ms(c["stepped"], 5), stepped_route=c["stepped_route"],
            smem_bytes=tfs.smem_bytes(M_LOC, b, 0, c["levels"]),
            blocks_per_sm=tfs.blocks_per_sm(M_LOC, b, 0, c["levels"]),
            grid=backend.sm_count(0),  # a block an SM (blocks_per_sm is 1)
            ptxas=ptxas(source, "fused_wide_kernel")))
    return recs


def wide_sweeps(A: torch.Tensor, rng) -> dict:
    """The windowed sweep at b = 256 (launch counters at 0 before it): R
    replicated bitwise, the Gram identity, Q^T A = [R; 0], a least-squares
    solve, K1-K4 launched and K5/K6 not; the FT sweep with WIDE_KILLS,
    bit-equal to failure-free; SPREAD_RUNS runs of each (median, min-max)."""
    b, comm = WIDE_B, SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = caqr_factorize(A, comm, b, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    sub = dict(backend.SUB_LAUNCHES)
    PATH_LAUNCHES["wide"] = launches
    PATH_SUB["wide"] = sub
    check(all(launches[op] > 0 for op in STEPPED)
          and launches["panel_qr_apply"] == launches["fused_panel"] == 0
          and sub["wide_gemm_kernel"] > 0, f"wide sweep launches {launches} {sub}")
    probe = backend.probe_report()
    check(all(probe[op]["engine"] == backend.ENGINE_CUDA for op in STEPPED),
          f"wide: an op did not run its kernels: {probe}")
    check(bool((res.R == res.R[:1]).all()), "wide: R is not replicated bitwise")
    A64 = A.reshape(-1, N).double()
    R0 = res.R[0]
    gram = gram_error(A64, R0)
    check(gram <= GRAM_TOL, f"wide Gram identity: {gram} > {GRAM_TOL}")
    QtA = caqr_apply_qt(A, res.factors, comm).reshape(-1, N)
    rmax = float(R0.abs().max())
    top = float((QtA[:N] - R0).abs().max()) / rmax
    rest = float(QtA[N:].abs().max()) / rmax
    del QtA
    check(max(top, rest) <= QTA_TOL, f"wide: Q^T A != [R; 0]: {top}, {rest}")
    rhs = block_row_layout(rng.standard_normal((P * M_LOC, 1)).astype(np.float32), P)
    x = caqr_lstsq(A, rhs, comm, b, result=res._replace(bundles=None)).double()
    b64 = rhs.reshape(-1, 1).double()
    x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
    lst = float((x - x_ne).norm() / x_ne.norm())
    check(lst <= LSTSQ_TOL, f"wide lstsq vs normal equations: {lst}")
    del A64, x, x_ne
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = flat_result(res)
    del res
    kill = kill_check(A, comm, WIDE_KILLS, want, b=b)
    PATH_LAUNCHES["wide_kill"] = kill["launches"]
    PATH_SUB["wide_kill"] = kill["sub_launches"] = dict(backend.SUB_LAUNCHES)
    WIDE_LEDGER["kills"] = kill.pop("ledger")
    fused = wide_fused_sweeps(A, want)
    del want
    sched = FailureSchedule(events={pt: [lane] for pt, lane in WIDE_KILLS.items()})

    def state_machine_fused():
        s = sm.initial_sweep_state(comm, A, b)
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
        return sm.finalize(comm, s)

    spread = {}
    for name, fn in (("caqr_factorize", lambda: caqr_factorize(
                          A, comm, b, use_scan=False, collect_bundles=True)),
                     ("ft_sweep_two_kills", lambda: ft_caqr_sweep(
                          A, comm, b, schedule=sched)),
                     ("state_machine_fused", state_machine_fused)):
        times = []
        for _ in range(SPREAD_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del out
        times.sort()
        spread[name] = dict(median_s=times[len(times) // 2], min_s=times[0],
                            max_s=times[-1], runs=times)
    m = P * M_LOC
    return dict(shape=[m, N], P=P, b=b, panels=N // b, levels=L,
                seconds=seconds,
                gflops=(2.0 * m * N * N - 2.0 * N ** 3 / 3.0) / seconds / 1e9,
                launches=launches, sub_launches=sub, gram_rel_err=gram,
                qta_top_rel_err=top, qta_rest_rel=rest, lstsq_rel_err=lst,
                peak_mem_gb=peak, kill=kill, fused=fused, spread=spread)


def wide_fused_sweeps(A: torch.Tensor, want: tuple) -> dict:
    """K6 above 128 columns on the b = 256 sweep (counters at 0 before
    each path): ``run_panel_fused`` over the 16 panels (path
    ``wide_fused``), bit-equal to the failure-free sweep and to the stepped
    state machine at every panel boundary; the online sweep with fused
    segments and the WIDE_END_KILLS (path ``wide_online_fused``), bit-equal
    to the failure-free sweep and to the stepped online sweep with the same
    kills, with the scheduled run's ledger."""
    b = WIDE_B
    res, seconds, launches, mem = timed_sweep(A, fused=True, b=b)
    same = same_bits(flat_result(res), want)
    del res
    PATH_LAUNCHES["wide_fused"] = launches
    sub = dict(backend.SUB_LAUNCHES)
    check(same, "wide: the fused sweep differs from caqr_factorize")
    check(launches["fused_panel"] == N // b
          and all(launches[op] == 0 for op in STEPPED) and not any(sub.values()),
          f"wide fused sweep launches {launches} {sub}")
    boundaries = lockstep(A, b)
    ends = {pt: [lane] for pt, lane in WIDE_END_KILLS.items()}
    got_f, stats_f, launch_f = online_run(A, ends, b=b, fused=True)
    got_s, stats_s, launch_s = online_run(A, ends, b=b)
    PATH_LAUNCHES["wide_online_fused"] = launch_f
    sched = ft_caqr_sweep(A, SimComm(P), b, schedule=FailureSchedule(events=ends))
    online_ok = dict(
        fused_equals_free=same_bits(flat_result(got_f), want),
        fused_equals_stepped=same_bits(flat_result(got_f), flat_result(got_s)),
        ledger_equals_scheduled=ledger(got_f.events) == ledger(sched.events)
        == ledger(got_s.events))
    del got_f, got_s, sched
    check(all(online_ok.values()), f"wide online fused: {online_ok}")
    check(launch_f["fused_panel"] > 0, f"wide online fused launches {launch_f}")
    return dict(seconds=seconds, launches=launches, sub_launches=sub,
                peak_mem_gb_above_live=mem,
                equals_sweep=same, boundaries_bitwise=boundaries,
                online=dict(**online_ok, fused=stats_f, stepped=stats_s,
                            fused_launches=launch_f, stepped_launches=launch_s))


def muon_run(cfg, dcfg, d: str, orths: list, keep: dict) -> tuple:
    """The plain ``Trainer(caqr_muon)`` for MUON_STEPS steps; every
    ``_orth2d`` call timed (synchronised around it) into ``orths`` as
    (step, shape, seconds), and step 0's momentum slices and their Q kept in
    ``keep``. Returns (trainer, run record)."""
    from repro_torch.optim import caqr_muon as t_muon

    orth2d = t_muon._orth2d
    tr = Trainer(cfg, train_tcfg(d, steps=MUON_STEPS), dcfg)

    def timed(M, tile_rows=512):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Q = orth2d(M, tile_rows)
        torch.cuda.synchronize()
        step = len(tr.history)
        orths.append((step, tuple(M.shape), time.perf_counter() - t0))
        if step == 0:
            keep.setdefault(tuple(M.shape), []).append((M.clone(), Q.clone()))
        return Q

    t_muon._orth2d = timed
    try:
        return tr, train_run(tr)
    finally:
        t_muon._orth2d = orth2d


def muon_runs(seed: int, d: str) -> dict:
    """The plain CAQR-Muon trainer at TinyLlama's full width (2 layers),
    twice: bit-equal params and losses, finite losses, every full-rank
    momentum slice's Q orthonormal, K1 at the path's shapes against its
    plain version on momentum slices, K1 launched."""
    cfg, dcfg = train_configs(seed)
    backend.reset_launches()
    orths, keep = [], {}
    tr, first = muon_run(cfg, dcfg, d, orths, keep)
    PATH_LAUNCHES["muon"] = dict(first["launches"])
    PATH_SUB["muon"] = sub = dict(backend.SUB_LAUNCHES)
    params = tr.state.params
    del tr
    tr2, second = muon_run(cfg, dcfg, d, [], {})
    same = same_tree(tr2.state.params, params) and second["losses"] == first["losses"]
    del tr2, params
    check(same, "muon: two runs differ")
    check(all(np.isfinite(x) for x in first["losses"]),
          f"muon: a loss is not finite {first['losses']}")
    check(first["launches"]["panel_qr"] > 0 and sub["wide_gemm_kernel"] == 0
          and sub["panel_qr_kernel"] == 0,
          f"muon: K1's wide launch not alone {first['launches']} {sub}")
    # Q orthonormal for every full-rank momentum slice of step 0; K1 at the
    # path's shapes against its plain version on those slices
    orth_err, full_rank, k1 = 0.0, 0, {}
    for shape, pairs in keep.items():
        for M, Q in pairs:
            A = M if M.shape[0] >= M.shape[1] else M.T
            Qt = Q if Q.shape[0] >= Q.shape[1] else Q.T
            n = A.shape[1]
            if leading_rank(A[None], n) < n:
                continue
            full_rank += 1
            G = Qt.double().T @ Qt.double()
            orth_err = max(orth_err, float((G - torch.eye(n, device=G.device,
                                                          dtype=G.dtype)).abs().max()))
        M = pairs[0][0]
        A = (M if M.shape[0] >= M.shape[1] else M.T).contiguous()
        m, n = A.shape
        for name, (mm, bb) in MUON_K1.items():
            if bb != n or name in k1:
                continue
            tile = MUON_K1["wk_leaf"][0]  # the chain's tile rows
            if name == "wk_step":
                X = torch.cat([ops.panel_qr(A[:tile], 0)[2], A[tile:2 * tile]])
            elif name == "wk_leaf":
                X = A[:tile].contiguous()
            elif mm == m:
                X = A
            else:
                continue
            k1[name] = muon_k1_check(X)
    check(full_rank > 0 and orth_err <= 1e-3,
          f"muon: Q^T Q off I by {orth_err} over {full_rank} full-rank slices")
    check(set(k1) == set(MUON_K1), f"muon: K1 held at {sorted(k1)} only")
    steps = first["step_seconds"]
    by_step = {}
    for step, shape, sec in orths:
        key = str(list(shape))
        by_step.setdefault(step, {}).setdefault(key, 0.0)
        by_step[step][key] += sec
    share = {step: {k: v / steps[step] for k, v in per.items()}
             for step, per in by_step.items()}
    return dict(arch=TRAIN_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
                d_ff=cfg.d_ff, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                steps=MUON_STEPS, reduced=TRAIN_REDUCED, first=first,
                second=second, bitwise_equal=same, sub_launches=sub,
                orth2d_calls_per_step=len(orths) // MUON_STEPS,
                orth2d_seconds_by_step_and_shape=by_step,
                orth2d_share_of_step=share,
                full_rank_slices=full_rank, qtq_max_err=orth_err, k1=k1)


def conditioned_rank(X: torch.Tensor, limit: float) -> int:
    """How many leading columns of X (m, n) have a float64 condition number
    of at most ``limit`` (it grows with the columns, so a bisection on the
    leading blocks of X's R factor finds it)."""
    R = torch.linalg.qr(X.double(), mode="r").R
    lo, hi = 0, X.shape[1]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        s = torch.linalg.svdvals(R[:mid, :mid])
        lo, hi = (mid, hi) if s[0] <= limit * s[-1] else (lo, mid - 1)
    return lo


def muon_k1_check(X: torch.Tensor) -> dict:
    """K1 on a Muon path's panel X (a momentum slice or a chain step)
    against its plain version. A momentum's trailing columns can be near
    dependent: f32 round-off then moves its reflectors in any QR, by up to
    eps cond. So K1 is held within the tolerance on the leading columns
    whose condition number is at most 1 / DEPENDENT_PIVOT (eps times it
    stays under the tolerance), and on the columns ``leading_rank`` keeps
    it is held against the float64 plain version no worse than four times
    the f32 plain version's own error there."""
    tol = ref.tolerances(torch.float32)[0]
    n = X.shape[1]
    got = as_tuple(ops.panel_qr(X, 0))
    want = as_tuple(ref.panel_qr(X, 0))
    cond_rank = conditioned_rank(X, 1 / DEPENDENT_PIVOT)
    pivot_rank = leading_rank(X[None], n)
    _, held = max_err(determined("panel_qr", got, cond_rank),
                      determined("panel_qr", want, cond_rank))
    want64 = as_tuple(ref.panel_qr(X.double(), 0))
    _, err_k = max_err(determined("panel_qr", got, pivot_rank),
                       determined("panel_qr", want64, pivot_rank))
    _, err_p = max_err(determined("panel_qr", want, pivot_rank),
                       determined("panel_qr", want64, pivot_rank))
    del got, want, want64
    check(held <= tol, f"muon: K1 at {tuple(X.shape)}: scaled error {held} "
          f"over the first {cond_rank} columns")
    check(err_k <= max(4 * err_p, tol), f"muon: K1 at {tuple(X.shape)}: "
          f"{err_k} from float64 against the plain version's {err_p}")
    return dict(shape=list(X.shape), conditioned_rank=cond_rank,
                scaled_err=held, leading_rank=pivot_rank,
                float64_err_kernel=err_k, float64_err_plain=err_p)


def wide_phase(A: torch.Tensor, rng, seed: int, card: str) -> list:
    """K1-K4 above 128 columns: their records at b = 256 and at the Muon
    path's shapes, the bitwise contracts, the b = 256 sweep and FT sweep,
    and the plain CAQR-Muon trainer at TinyLlama's width (see the module
    docstring). Returns the kernel records."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(seed + 5)
    recs, contracts = wide_kernels(A, g)
    gemm_rec = gemm_record(A, g)
    sweeps = wide_sweeps(A, rng)
    emit({"wide": dict(**sweeps, contracts=contracts, card=card)})
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        muon = muon_runs(seed, d)
    muon["phase_seconds"] = time.perf_counter() - t_phase
    emit({"muon": dict(**muon, card=card)})
    return recs, gemm_rec


def gemm_record(A: torch.Tensor, g: torch.Generator) -> dict:
    """The products' kernel of the wide routes (csrc/wide.cu) alone, at the
    b = 256 sweep's first leaf apply: Z = Y^T C, Y (8, 4096, 256), C the
    (8, 4096, 4096) window, against its plain version and torch.matmul,
    and bit-equal at two column tiles. Its launches are counted inside the
    wide calls (backend.SUB_LAUNCHES)."""
    Y = torch.randn(P, M_LOC, WIDE_B, generator=g).to(A.device)
    run = lambda: wide.gemm(Y.mT, A)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = wide.gemm_plain(Y.mT, A)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, scaled = max_err((got,), (want,))
    tol = ref.tolerances(torch.float32)[0]
    check(scaled <= tol, f"wide_gemm: scaled error {scaled} over {tol}")
    check(torch.equal(got, wide.gemm(Y.mT, A, bn=32)), "wide_gemm: bn changes bits")
    del got, want
    bms, by = bound_ms(2.0 * P * WIDE_B * M_LOC * N,
                       4.0 * P * (M_LOC * WIDE_B + M_LOC * N + WIDE_B * N))
    return dict(name="wide_gemm", route="cuda", source="src/repro_torch/csrc/wide.cu",
                replaces=KERNELS["wy_apply"][1],
                also_inside=[KERNELS["panel_qr"][1], KERNELS["stacked_apply"][1]],
                shapes=[[P, WIDE_B, M_LOC], [P, M_LOC, N]], launches=0,
                max_abs_err=err, scaled_err=scaled, tolerance=tol,
                ms=time_ms(run, 10), device_ms=device_ms(run, 10, "wide_gemm"),
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=time_ms(lambda: Y.mT @ A, 10),
                ptxas=ptxas("src/repro_torch/csrc/wide.cu", "wide_gemm_kernel"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    # the kernels build (one nvcc a source) while this process does the
    # CPU's work: the dry run on meta tensors and the adafactor phase's CPU
    # step
    built = {}
    compiling = threading.Thread(target=build_kernels, args=(built,))
    compiling.start()
    with timed("dryrun"):
        dryrun_phase(card)
    with timed("adafactor_cpu"):
        ada_inputs = adafactor_inputs(args.seed)
    compiling.join()
    if "error" in built:
        raise built["error"]
    PHASE_SECONDS["build"] = built["seconds"]
    emit({"build_seconds": built["seconds"], "per_source": build.SECONDS,
          "card": card})

    rng = np.random.default_rng(args.seed)
    A = block_row_layout(rng.standard_normal((P * M_LOC, N)).astype(np.float32), P)
    emit({"team": team_record()})
    with timed("kernels"):
        records = kernel_phase(A)
    with timed("sweep"):
        launches, sweep_seconds, res = sweep_phase(A, rng)
        want = flat_result(res)
        del res
        profile_phase(A, sweep_seconds)
    with timed("fused_leaf"):
        launches.update({"panel_qr_apply": fused_leaf_phase(A)["panel_qr_apply"]})
    with timed("state_machine"):
        launches.update({"fused_panel": state_machine_phase(A, want)["fused_panel"]})
    with timed("autotune"):
        autotune_phase(A, want)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    with timed("ft_driver"):
        ledgers = ft_driver_phase(A, want)
    with timed("online"):
        online_phase(A, want, ledgers)
    with timed("bf16"):
        bf16_records = bf16_phase(A, ledgers)
    with timed("spmd"):
        spmd_phase(A, want, ledgers, args.seed)
    del want
    with timed("shrink"):
        shrink_phase(A)
    with timed("recovery"):
        recovery_phase(A)
    with timed("square"):
        square_phase(rng)
    with timed("ragged"):
        ragged_phase(rng)
    with timed("serve"):
        serve_phase(args.seed, card)
    with timed("train"):
        train_phase(args.seed, card)
    with timed("train_moe"):
        moe_phase(args.seed, card)
    with timed("lm_serve"):
        lm_serve_phase(args.seed, card)
    with timed("lm_long"):
        lm_long_phase(args.seed, card)
    with timed("lm_families"):
        lm_families_phase(args.seed, card)
    with timed("train_families"):
        train_families_phase(args.seed, card)
    with timed("train_mesh_pod"):
        multi_process_phases(args.seed, card)
    with timed("wide"):
        wide_records, gemm_rec = wide_phase(A, rng, args.seed, card)
    with timed("bf16_wide"):
        bf16_records += bf16_wide_phase(A)
    with timed("adafactor"):
        adafactor_phase(ada_inputs, card)
    del ada_inputs
    with timed("spread"):
        spread_phase(A)
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]]
                                   for path, counts in PATH_LAUNCHES.items()}
    gemm_rec["launches"] = PATH_SUB["wide"]["wide_gemm_kernel"]
    gemm_rec["launches_by_path"] = {path: counts["wide_gemm_kernel"]
                                    for path, counts in PATH_SUB.items()}
    check(all(gemm_rec["launches_by_path"][p] for p in ("wide", "wide_kill")),
          f"wide_gemm not launched on a wide path: {gemm_rec['launches_by_path']}")
    records.append(gemm_rec)
    # the bf16 kernels' launches: K1-K4 on the bf16 sweep, K5 on the bf16
    # fused leaf, K6 on the bf16 fused sweep (above 128 columns the bf16_wide
    # phase's paths)
    main_path = {"panel_qr_apply": "bf16_fused_leaf", "fused_panel": "bf16_fused"}
    for rec in bf16_records:
        op = rec.pop("op")
        pre = "bf16_wide_" if rec["name"].endswith("_wide") else "bf16_"
        path = main_path.get(op, "bf16_sweep").replace("bf16_", pre, 1)
        rec["launches"] = PATH_LAUNCHES_BF16[path][op]
        rec["launches_by_path"] = {path: counts[op]
                                   for path, counts in PATH_LAUNCHES_BF16.items()}
        check(rec["launches"] > 0, f"{rec['name']} not launched on its bf16 path")
    records.extend(bf16_records)
    emit({"wide_kernels": wide_records})
    emit({"phase_seconds": PHASE_SECONDS,
          "script_seconds": time.perf_counter() - T_START})
    print(card, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
