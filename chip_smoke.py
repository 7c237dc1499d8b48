#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (tsne_flink_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — name, count, and nvidia-smi's name + power limit;
2. build   — nvcc of csrc/*.cu, one process per source, all at once
   (seconds, and each kernel instance's registers and spills), B1's
   configuration (rows a block, ring stages, distance-tile buffers,
   shared memory) per k class, and, where the toolkit has cuobjdump,
   whether B1's SASS holds tensor-core (HMMA/HGMMA) and asynchronous-copy
   (LDGSTS/UTMALDG) instructions (informative);
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main paths: B1 at 8,192 x 784
   (k = 90) and 8,192 x 50 (k = 150), held to the float64 graph (index
   agreement >= 0.999 and >= the plain FP32 version's own) and to its
   plain version (distances rtol 1e-4, neighbour sets >= 0.999), two
   launches bit-identical; B2 at 60,000 rows (m = 2 and 3, a masked row
   shard, two launches bit-identical); the blobs' CSR layout built on the
   card (``build_csr``) equal to the host build bit for bit, with its
   seconds and the memory it adds; B3, one launch over the CSR head and
   tail at 60,000 rows, against its plain version (gains exactly equal,
   y and update rtol 1e-4), against the unfused step (B5 over head +
   tail, att − rep/Z, the vdM update) bit for bit, and with its rows in
   each visit order bit for bit as in index order; B4 there; B5 and B4,
   each one launch over a row block and a ragged edge part, at the
   widths below, on the CSR run's head + tail, on its tail alone, on
   the blobs' blocks layout (forward block + reverse edges), on the flat
   edge list (no row block) and on an edge problem (a hub row of 3,000
   edges, a row with none, the last row owning padding), rtol 2e-5, two
   launches bit-identical, and one launch over head + tail equal bit for
   bit to the head's plus the tail's; B6, the fused refine-chunk stage,
   on the stages of a real refine chunk at both hybrid-kNN shapes (the
   blobs' cascade at F = 128 and exact stage at F = 784, the cells'
   exact stage at F = 50) and on two synthetic edge chunks (every gateway
   one id; a row whose gateways are all itself), held to the plain
   stage: each distance the formula's for its (row, id), or its smaller
   old one, to rtol 2e-5, neighbour sets >= 0.999, the k-th distance to
   rtol 2e-5, ids distinct, self absent, rows ordered by (d, id), two
   launches bit-identical; each stage timed over the first 32 chunks of
   a refine round in sequence, as the round runs them;
4. widths  — the kernels at the limits they were widened to: B2-B5 at
   m = 1, 4 and 8 on 4,000 rows, B1 at k = 300 and k = 1,024 on a cut of
   the blobs (its first 256 slots bit for bit the k = 256 class's list,
   each neighbour within the float64 k-th distance, and against plain as
   above), B6 at k = 600 on refine chunks captured from cuts of the
   blobs (cascade + exact) and the cells, and at k = 1,024 on the cells,
   each against its plain version with the bars above; ``tsne_embed`` at n_components 1, 4 and 8, and
   at k = 1,024 on the bruteforce and project paths; and 12,289
   features on a refining ``project`` plan (4,000 cells of 8f's counts,
   one refine cycle), once refused, run: the cascade in B6, the exact
   stage in B6u (k past 1,024 runs: 8d; m past 8: 8e; 32,738 features
   at size: 8f);
4b. bf16   — mixed precision (``--dtype bfloat16``): B1's bf16 form
   (``KERNELS["B1_bf16"]``) against its plain version run on float64
   copies (distances within rtol 1e-5 of the norm trick's terms, ids
   equal outside ties, two launches bit-identical) at 60,000 x 784 (k =
   90, every row) and on 4,096 rows of 1,306,127 x 50 (k = 150); at 60k
   its recall@90 and slot-wise agreement against the float64 graph
   beside 3xTF32's and the plain FP32 sweep's, its time beside 3xTF32's
   and its library yardstick (chunked bf16 matmul with float32 output +
   topk) in turns, with its bound (bf16 at 989 TFLOP/s); at 1.3M one
   launch of each form; after phase 5, ``TSNE(dtype="bfloat16")`` at
   [full]'s configuration: B1's bf16 form once and the 3xTF32 form
   never, the rest [full]'s launches, final KL within 0.05 of [full]'s
   float32 run (its label agreement printed);
4c. f64    — float64 on the card (``--dtype float64``): B1_f64 (FP64
   tensor cores, ``KERNELS["B1_f64"]``) against its plain version on the
   same float64 points (each distance within 1e-12 of |d| + ‖a‖² + ‖b‖²,
   ids equal outside ties) at 60,000 x 784 (k = 90, every row, two
   launches bit for bit, timed beside its library yardstick, chunked
   float64 matmul + topk, in turns, with its FP64 tensor-core bound) and
   on 4,096 rows of 1,306,127 x 50 (k = 150, one timed full launch);
   B2_f64-B5_f64 at m = 1..8 on 4,000 rows (an edge problem: a hub row,
   an empty row, padding) against their plain versions at rtol 1e-12
   (gains exactly equal; B3_f64 the unfused float64 step bit for bit);
   after phase 5, ``TSNE(dtype="float64")`` at [full]'s configuration
   (B1_f64 1, B2_f64 / B3_f64 300, B4_f64 30, no float32 or bf16 form;
   final KL within 0.05 of [full]'s, label agreement >= 0.9; the same fit
   on the test mesh of 2 shards bit for bit), B2_f64 and B3_f64 at its
   final y and [full]'s CSR (W = 256 + the tail) against plain (rtol
   1e-12), timed with their FP64 bounds; the rows (latent blobs), blocks
   and FFT routes at float64 with their launches; after phase 9, B5_f64
   and B4_f64 on [large]'s pass in float64 (rtol 1e-12, timed after an L2
   flush), then the card against the CPU at 2,500 x 50 (BASELINE config
   1's size; the CPU's half a process of its own since phase 2): kNN ids
   equal, P within ±1e-12, y after one iteration within ±1e-9, the final
   KL after 1,000 iterations within 0.05, and the project kNN (3 seed
   rounds + 2 refine cycles, B6_f64 on the card) from the same draws: ids
   equal outside ties, each distance within 1e-12 of |d| + ‖a‖² + ‖b‖²,
   P from that graph within ±1e-12.  B6_f64 (``KERNELS["B6_f64"]``)
   against its plain version on the stages of real refine chunks
   captured at float64 (the blobs' cascade at F = 128 and exact stage at
   F = 784, the cells' exact stage at F = 50, the edge chunks, the blobs'
   first stage with n_valid = N − 64, and k = 600 on the [widths] cuts):
   two launches bit for bit, each distance within 1e-12 of |d²| + ‖a‖² +
   ‖b‖², ids equal outside ties, rows by (d, id), a keep stage's kept set
   equal outside ties at the cut; each full-size stage timed over 32
   chunks beside its plain version and its bound.  After phase 8,
   ``TSNE(dtype="float64", knn_method="project")`` at [project]'s
   configuration (B6_f64 360, no float32 form; recall@90 against
   B1_f64's graph >= 0.93; final KL within 0.05 of [project]'s); after
   [large], config 5's shape at float64 end to end (B6_f64 1,595, B5_f64
   and B4_f64 as [large]'s B5 and B4; recall@150 on B1_f64's 4,096 rows
   within 0.005 of the float32 run's; final KL within 0.05; the memory
   model within [1, 2]x of the measured peak);
5. full    — ``tsne_embed`` on 60,000 x 784 MNIST-like blobs (perplexity
   30, k = 90, exact repulsion, CSR attraction, 300 iterations): stage
   seconds (the plan stage on its own line), the launches of each kernel
   in that run (counted from 0 just before it: B3 every iteration, no
   B5), B3 at the run's final y with its rows in index order and in
   each visit order (hubs first, as optimize runs it; a Z-order of y;
   both), in turns, beside each order's cost, the per-iteration split
   (B2, B3, the order, B4/10, the rest), each kernel's
   CUDA-event time at the run's shapes beside its
   plain version's and its bound (B1 and its library yardstick each the
   median of 3 warm launches taken in turns, B1's bound that of 3xTF32 on
   the tensor cores beside one FP32 pass), peak memory, the loss trace,
   and the quality checks (finite, falling KL, 10-NN label agreement >=
   0.9);
6. rows    — the default configuration (``attraction="auto"``) on
   60,000 x 784 "latent blobs" (10 clusters in a 3-D latent, lifted
   linearly to 784 dims), where auto must pick the rows layout: launches,
   the per-iteration split (B2, B5, B4/10, the rest), and the quality
   checks (finite, falling KL, label agreement within 0.05 of the latent
   itself);
7. blocks  — the blocks assembly on the blobs of phase 5: launches, the
   attraction pass timed after an L2 flush as one launch of B5 (and of
   B4) over the forward block and the reverse edges, beside the old pair
   (B5 over the forward block + the reverse edges' segment sum; B4 + the
   reverse edges' KL), with its bytes bound and its gathers' L2 sectors,
   the split of an iteration, the checks of phase 5, and a final KL
   within 0.05 of phase 5's (both optimize the same P);
8. project — ``tsne_embed`` on the blobs of phase 5 with the hybrid kNN
   (``knn_method="project"``: 3 seed rounds + 6 refine cycles, B6 running
   every funnel stage of every refine chunk) and exact repulsion:
   launches, the kNN substage seconds and the refine split, recall@90
   against B1's exact graph (>= 0.93), B6's time beside B1's, and the
   checks of phase 5;
8b. bh — Barnes-Hut against B2 at phase 5's final y (θ = 0.5 and 0.25
   with the vdm gate, held to force error < 2.5e-2 of max |rep| and Z
   error < 1e-2; θ = 0.5 with the flink gate, reported) and at m = 3 on
   the latent blobs' latent (θ = 0.25), two calls bit for bit, each
   call's time and peak memory; then config 2 as BASELINE.json names it
   (phase 8 with θ = 0.5 Barnes-Hut): no B2 launch, final KL within 0.05
   of phase 8's, the checks of phase 5, the iteration split;
8c. cli — the batch job (``utils/cli.main``) on the blobs as a COO CSV:
   config 2's command line, a warm artifact cache, a fat-checkpoint
   resume and ``TSNE().fit`` give their runs' bits; config 2 with
   ``--repulsion bh`` gives phase 8b's y; ``--healthCheck --telemetry``
   keeps phase 5's bits with finite telemetry rows; an ``--autopilot``
   run resumed from its checkpoint gives the same y and pilot pair;
   config 2 with ``--dtype bfloat16`` and the warm cache's directory
   reads none of the float32 entries and ends within 0.05 KL of its
   float32 run; config 2 with ``--dtype float64 --knnMethod bruteforce``
   runs on the float64 forms alone within 0.05 KL of config 2's float32
   run, and config 2 itself at ``--dtype float64`` (its project kNN,
   B6_f64 360 launches) too;
8d. bigk  — k past 1,024 (perplexity above 341): B1, its bf16 form and
   B1_f64 at k = 1,025, 1,500, 2,048 and 4,096 on the blobs of phase 5,
   each against its plain version run in float64 on the form's operands
   on 1,024 sampled rows (distances within 1e-5, or 1e-12 at float64, of
   |d| + ‖a‖² + ‖b‖², ids equal outside ties), two launches bit for bit,
   both launches in the pending class (and the k = 1,024 launch in the
   deep class), the held rows' first 1,024 slots bit for bit the deep
   class's list; B6 and B6_f64 at k = 1,500 on stages captured from
   20,000-row cuts (B6_f64 on their inputs at float64, the old lists'
   distances recomputed: the cells' first exact stage, 16·1,501
   candidates a row, on the workspace route;
   the blobs' cascade and exact stages; the cells' first stage with
   n_valid = N − 64) at the B6 bars, the route each took, each stage
   timed a chunk with its bound; then
   ``TSNE(perplexity=500)`` (k = 1,500) at 60,000 x 784, 300 iterations,
   with ``knn_method="bruteforce"`` (B1 once, in its pending class) and
   ``"project"`` (B6 each stage of each refine chunk; recall@1,500
   against B1's graph >= 0.90): launches, finite and falling KL, label
   agreement >= 0.9, the memory model's allocated peak within [1, 2]x of
   the measured; B1's cross sweep at k = 1,500 (a row block against
   every column = the single sweep's rows bit for bit; against a column
   block vs its plain version) and the ring on the test mesh of 2 = the
   single sweep's graph bit for bit; config 2's command line at
   ``--perplexity 500`` = the project estimator's bits; one 256-row
   serving bucket from that model (query kNN at k = 1,500, B5 at [256,
   1,500], B2), finite, 1 x 256 = 4 x 64 bit for bit; B1's time at k =
   1,500 (median of 3 warm launches in turns with its library yardstick,
   chunked matmul + topk(1,500)) beside its plain version's and its
   3xTF32 bound.  The kernels line's B1, B1_bf16, B1_f64, B6 and B6_f64
   records carry these as ``bigk``;
8e. wide  — embeddings wider than 8: B2w-B5w, the wide forms of B2-B5,
   and their float64 forms at m = 9, 12, 16, 31, 32, 50, 64, 100 and 256
   on 4,000 rows of a spread y against their plain versions (rtol 2e-5,
   B3w's y and update 1e-4 with its gains equal; 1e-12 at float64), B2w
   on a masked row shard and a shard at the canonical split count equal
   to the full launch's rows bit for bit, B5w/B4w on an edge problem,
   B3w the unfused step's bits, two launches bit for bit; then at
   60,000 x 784 and n_components = 16 (300 iterations, k = 90, exact):
   ``tsne_embed`` (B1, B2w 300, B3w or B5w 300, B4w 30), ``TSNE(dtype=
   "float64")`` and its 256-row bucket (B5w_f64 and B2w_f64 75 each),
   the project estimator and config 2's command line at ``--nComponents
   16 --auditPlan`` (its bits and launches; the memory model's re-check
   at the graph's width bound within [1, 2]x of the run's measured
   allocated peak), a 256-row bucket of that model (1 x 256 = 4 x 64 bit
   for bit), the test mesh of 2 equal to the mesh of 1 bit for bit; each
   fit finite with falling KL and label agreement >= 0.9; then each
   form at the m = 16 runs' final y (float32 and float64) on [full]'s
   CSR, the shapes the runs gave it: B2w and every float64 form against
   its plain version at the bars above (B3w_f64's gains equal and the
   unfused step's bits, B4w_f64's total KL); B5w, B4w and B3w (gains
   equal, the unfused step's bits) at float32 each within twice the
   plain float32 version's own error against the plain version in
   float64, since their forward part's norm trick cancels there as the
   plain version's does (the elements beyond rtol 2e-5 / 1e-4 against
   the float32 plain version printed); two launches bit for bit; and
   timed beside its plain version and its bound (the m = 64 times are
   ``scripts/wide_phase_cuda.py``'s).  The kernels line carries B2w-B5w
   and their float64 forms after the float64 ones (their launches from
   these runs, the error at the runs' y as ``max_abs_err_at_run``, B4w's
   and B5w's against float64 as ``against_f64_at_run``);
8f. features — more than 12,288 features on a refining project plan,
   where B6 launches its unstaged form (``KERNELS["B6u"]``,
   ``["B6u_f64"]``: the row not staged in shared memory; the chunk's
   pairs scored over F in slabs that stay in L2).  Forced at the blobs'
   staged widths (F = 128, 784) the unstaged form holds to its plain
   version and gives the staged form's ids outside ties.  The data: a
   synthetic stand-in for 10x Genomics' "Fresh 68k PBMCs (Donor A)"
   raw counts (``make_counts``: 20 cell types, ~2% of a row detected,
   log1p per 10,000), 20,000 cells x 32,738 genes densified on the card.
   On a 64-row refine chunk captured there (k = 90) B6u against its
   plain version at B6's bars and, at float32, its d² error against
   float64 within twice the plain float32 version's own with no id off
   outside that bar; B6u_f64 at B6_f64's.  Then each on the run's own
   4,096-row chunks (the first and the last of a round: at 68,579 rows
   the last holds the rows past 2^31 / F), launched whole and held on
   64-row slices against the plain version, and timed over the round's
   chunks beside its bound and the plain version's slices.
   Then ``tsne_embed(perplexity=30, knn_method="project")`` on the cut
   (``scripts/wide_features_phase_cuda.py``: at the full 68,579 x 32,738,
   8.98 GB on the card): launches exact (B6 the cascade, B6u the exact
   stage, a chunk a refine cycle each), finite falling KL, recall@90 >=
   0.90 against B1's exact graph (timed beside the hybrid plan), the
   memory model within [1, 2]x of the run's peak; and the cut through
   two gloo processes on the card (run beside the rest: the in-process
   job's bits on the test mesh of 2), ``TSNE(dtype="float64")``
   (B6u_f64), ``TSNE(dtype="bfloat16")``, ``TSNE().fit``, the command
   line on a COO CSV of the counts with ``--auditPlan`` and perplexity
   500 (k = 1,500, one refine cycle).  The kernels line carries B6u
   (launches from the run on the cut) and B6u_f64 (from the float64 fit)
   after the wide forms;
9. large — ``tsne_embed`` at the shape of the 10x Genomics 1.3M mouse
   brain cells (1,306,127 x 50 principal components; a synthetic
   stand-in, see ``make_cells``): perplexity 50, k = 150, the hybrid kNN
   (3 + 5 cycles), FFT repulsion (grid 1024, p = 3), 300 iterations at
   FIt-SNE's large-N learning rate (``fitsne_learning_rate``):
   stage and kNN substage seconds, the refine substage split into B6
   and the rest of its rounds, B1's exact graph at this shape (its
   time, one warm launch and both bounds, and the hybrid's recall
   against it, >= 0.90), the efficiencies of pick_knn_method's cost
   model and its exact/hybrid crossover, the FFT repulsion's
   per-iteration split (spread / FFTs / gather) beside B2's at 60,000
   and at this N (the exact/FFT crossover), the blocks layout's
   attraction pass as in phase 7 (B5 and B4 held against their plain
   versions there too), the rest of an iteration, peak memory, and the
   quality checks (finite, falling KL, label agreement within 0.05 of
   the latent's own);
9b. bh-large — one Barnes-Hut call at phase 9's final y, timed, its
   force error on 256 rows against B2 (< 2.5e-2);
9c. pilot — the autopilot: 10,000 blobs off against the autopilot with
   the landmark schedule (|ΔKL| <= 0.05); the latent blobs under the
   autopilot with the landmark schedule (engaged by auto; reported) and
   with the stride alone (phase 6's label check); phase 9's P and init
   through ``optimize`` with the autopilot (FFT stride and grid ladder);
   each with its repulsion refreshes, transitions and host reads (at
   most one a report boundary);
9d. serve — out-of-sample serving (``serve/``) on two frozen models:
   phase 8's run written as a fat checkpoint and opened with
   ``load_frozen`` (60,000 x 784, exact: B5 and B2 with the query rows
   numbered past the base) and phase 9's embedding (1,306,127 x 50, fft:
   B5 and the base field's gather).  For each: 256 base rows
   self-transformed (bucket 256, 75 iterations, eta 0.5) and held to
   the reference's serve-record bars (10-NN recall >= 0.35, drift over
   the span: median <= 0.01, p95 <= 0.05); exact launches (B5 75 a
   bucket, B2 75 or 0, nothing else); one bucket's knn / init /
   optimize split (CUDA events) and its device busy share
   (torch.profiler); B5 (and B2) at the bucket's shapes against their
   plain versions (rtol 2e-5; B5's absolute part scaled by its
   summands), two launches bit for bit, each timed beside its plain
   version and bound; 1,024 new rows as 1 x 1,024, 4 x 256 and 16 x 64
   bit for bit, with the peak memory (the resident model included)
   held between ``transform_peak`` / 2 and ``transform_peak``; then a
   scheduled ``ServeDaemon`` on the 60k model over 8 spooled requests of
   64 / 256 / 1,024 rows: rows/s, p50/p99, batch fill, every answer
   equal bit for bit to a direct transform; and the 60k checkpoint
   opened as a float64 model (float64 on the card), held as the first
   (B5_f64 and B2_f64 75 a bucket);
9f. quorum — replicated serving (queue A13b): ``runtime/fleet
   .run_serve_fleet`` runs ``python -m tsne_flink_tpu_torch.runtime.fleet
   --serve`` replica processes over one spool on the card, on phase 8's
   60k exact model (its fat checkpoint, the base features as .npy), each
   answer held bit for bit to this process's own transform, every
   request to exactly one terminal and the drained spool to terminals
   only: (1) clean, two replicas, the 8 requests of phase 9d landing once
   both are warm: rows/s and p50/p99 beside phase 9d's daemon, each
   replica's start-up (spawn to warm) and its launches, B5 and B2 75 a
   bucket and nothing else; (6) memory, each replica's peak reserved
   plus the measured CUDA context against the gate's charge
   (``transform_peak`` with the allocator's reserve, and the context
   once), within [1, 2]; then at once, each over its own spool, (2)
   ``kill@serve:seg0`` on both replicas (re-dispatched requests carry
   epoch >= 2), (3) ``hang@serve:2`` on one replica under a 3 s
   heartbeat bound (a ``sigkill-hung`` event, re-dispatch), (4)
   ``delay@serve:2`` past a replica's stage timeout (its watchdog ends
   it with exit 124; relaunched clean) and (5) shedding at depth 1 (bulk
   refused with ``retry_after_ms`` > 0, express served);
9g. mesh — the single-controller point mesh (queue A14a,
   ``parallel/mesh.ShardedOptimizer``) on the test mesh, the one card
   listed once a shard (run after 9d, before 9f): [full]'s configuration
   at mesh 1, 2 and 4 (y, update, gains and the loss trace equal bit for
   bit across widths; launches exactly D x (B2 300, B3 300, B4 30); mesh
   1 against [full]'s plain run within 0.05 KL with its label gate, max
   |dy| printed; mesh 1's run peak within [1, 2]x the memory model, each
   width's optimize peak / D beside the per-device charge, not gated),
   the latent blobs on the rows layout at mesh 1 and 2 (bits; D x (B2,
   B5 300, B4 30)) and a fat checkpoint written there at iteration 150,
   mesh 1, resumed at mesh 2 with the uninterrupted run's bits, 60,001
   blobs (a padded, masked tail) at mesh 1 and 4 (bits), phase 9's P on
   blocks + FFT at mesh 1 and 2 (bits; D x (B5 300, B4 30); s/iter of
   each: one card time-slicing the shards, not a multi-GPU speed), and
   B2 at a shard's shape of mesh 2, 4 and 8 with the canonical column
   splits (the rows of the mesh-1 launch bit for bit) beside its own;
   in 8c, the CLI's mesh flags on config 2's file: ``--mesh 1`` equal to
   ``TSNE(mesh=1)`` bit for bit, ``--mesh 2`` refused on one card before
   the input is read, naming the visible count, and ``--meshReduce
   psum`` on a test mesh of 2 within 0.05 KL of the canonical run;
9h. spmd — the multi-controller job (queue A14b, ``parallel/pipeline
   .SpmdPipeline``; run after 9g): the ring (``parallel/knn.ring_knn``)
   on the test mesh at D = 2 and 4 equal to ``fused_knn``'s graph bit for
   bit with exactly D B1 launches a shard, B1's cross sweep per hop
   (30,000 and 15,000 rows a block) beside the single sweep over as many
   rows and its 3xTF32 bound, and held to its plain version at the
   two-process hop; the bf16 ring at D = 2 and 4 equal to the bf16
   single sweep's graph bit for bit, B1's bf16 form D times a shard;
   B6 with ``n_valid`` on the blobs' first funnel stage
   against its plain version; the in-process job at mesh 1 and 2 (bit
   for bit); the NCCL route at world size 1 (a group this phase opens)
   with mesh 1's bits; two ``python -m tsne_flink_tpu_torch.utils.cli
   --spmd --coordinator --numProcesses 2 --processId r`` processes on the
   one card (gloo) equal to the in-process job bit for bit, only rank 0
   writing, final KL within 0.01 of [full]'s; the project kNN over two
   processes (recall@90 >= 0.93 against B1's graph, B6 launches of the
   reference's refine cycles a rank) and the alltoall job (P ids equal
   to replicated's, values rtol 1e-6; final KL within 0.01); and
   ``--symStrict`` over a dropping symmetrization ending both ranks
   non-zero; the float64 project kNN at mesh 2 on the test mesh equal to
   mesh 1's graph bit for bit (one set of draws), and over the two
   processes (B6_f64 a rank, recall@90 >= 0.93 against B1_f64's graph);
9e. diverging — N = 2,000 at learning rate 1e30 with the sentinel: three
   rollbacks, eta halved each time, then ``DivergenceError``;
10. determinism — two runs at N = 2,000 give the same bits, on the CSR
   path, the rows path, the hybrid kNN + FFT path, the autopilot with
   the landmark schedule, and Barnes-Hut;
11. runtime — the runtime and observability layers (queue A15): the
   CUDA context a fresh process holds (B1, a matmul, an FFT); the memory
   model (``analysis/audit/hbm.py``) against the card at ``[full]``,
   ``[rows]``, ``[blocks]``, ``[project]`` and ``[large]``'s
   configurations and ``[full]``'s at float64 run stage by stage (allocated peak vs the model's
   allocated terms, and footprint — reserved + context — vs its whole
   peak, each within [1, 2]) and ``[serve]``'s two models; a real CUDA
   OOM (a subprocess capped at 4 GiB by
   ``set_per_process_memory_fraction`` runs the supervised ``[full]``
   configuration: the affinity stage's [N, S] planes run out of memory,
   the ladder takes the blocks assembly and the run equals blocks from
   the start bit for bit); the fault rehearsals on 20,000 of the blobs
   (``oom@knn``, ``kill@optimize:seg1`` then ``--resume``,
   ``nan@optimize``, ``corrupt@checkpoint``, ``--stageTimeout`` -> 124);
   three 60,000 x 784 fleet jobs under a budget that admits two, one
   killed and retried, each equal to its solo run and within its
   predicted footprint (``scripts/runtime_phase_cuda.py`` also times the
   three one at a time); config 2's
   command line with and without ``--trace --metricsOut --profile`` on
   20,000 of the blobs (cut for time; the same bits, launches and host
   reads; the JAX span names), and ``--profile``'s cost in a fresh CLI
   process (the same output bytes).

Inside phase 8c, after its gate 1, ``[analysis]`` (queue A16): config
2's command line with ``--auditPlan`` at the kNN graph's width bound
(the gate's report and seconds, the predicted peak within [1, 2]x of
the measured one, the same bits and launches) and as users give it (the
pre-read gate's predicted / measured peak printed, not gated; the
re-check after the kNN stage at the graph's width bound within [1, 2]),
a plan the memory model
puts above the card (1M x 2 points, k = 1,024, sorted) refused with the
JAX message before any launch, ``--executionPlan`` at 60k (the JSON, no
CSV, B2 and B3 on the iteration, B4 on the KL pass), and the analysis
entry point's ``--audit`` on the card, clean.

The widths at which B5 and B4 are held: the latent blobs' [N, S] rows
(S ~ 146), the blobs' [N, S] rows (S ~ 3,466: what attraction="rows"
runs there) and the blocks layout's forward block (W = k = 90).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON record of every kernel (B2's and B5's with their serving
shapes under ``serve``, B5's at 1.3M under ``serve_large``, every
record's ``serve_launches``: the two self-transforms' launches, and
``mesh_launches_per_shard``: a shard's launches in 9g's csr, rows and
blocks runs; B2's ``mesh_shard_ms`` at a shard's shape), then the records
of 9h's B1 cross sweep (``B1 knn cross``, at the two-process job's hop,
its launches that job's) and B6 with ``n_valid`` (``B6 refine_chunk
n_valid``, its launches the two-process project kNN's).  The float64
forms' records (B1_f64-B6_f64) sit after B6's: their launches from the
float64 ``[full]`` fit (B5_f64's from the float64 rows run, B6_f64's
from config 5's shape at float64), their times at 60k (B1_f64), [full]'s
shapes (B2_f64, B3_f64), [large]'s pass (B4_f64, B5_f64) and the cells'
exact refine stage (B6_f64).  The wide forms' records (B2w-B5w, then
B2w_f64-B5w_f64) follow: their launches from 8e's m = 16 runs (B5w's and
B5w_f64's from a 256-row bucket of the m = 16 models), their times at
60k, m = 16 and, under ``m64``, m = 64.  The script imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks at 700 W (NVIDIA data sheet): FP32 outside
#: the tensor cores, dense TF32 on them, HBM
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

N_FULL, F_FULL, CLASSES = 60_000, 784, 10
#: the 10x Genomics 1.3M mouse brain cells (BASELINE.json config 5) after
#: FIt-SNE's preprocessing: 1,306,127 cells x 50 principal components
N_CELLS, F_CELLS, CELL_TYPES = 1_306_127, 50, 30
PERPLEXITY_CELLS, K_CELLS = 50.0, 150
N_B1_CHECK = 8_192
N_DETERMINISM = 2_000
PERPLEXITY, K, ITERATIONS = 30.0, 90, 300
#: the widths phase: rows for B2-B5 at m = 1, 4, 8; B6's k and cut; the
#: points and iterations of its short embeds; the deep class's largest k
N_WIDTHS, K_B6_DEEP, N_REFINE_DEEP = 4_000, 600, 20_000
N_EMBED_DEEP, ITER_WIDTHS, K_DEEP = 12_000, 100, 1024
#: the final-KL gap allowed between two runs over the same P
#: (tsne_flink_tpu/models/autopilot.py KL_GUARDRAIL_TOL, copied)
KL_GUARDRAIL_TOL = 0.05


#: the float64 forms' launch counts in a run that launches none of them
NO_F64 = {kid: 0 for kid in ("B1_f64", "B2_f64", "B3_f64", "B4_f64",
                             "B5_f64", "B6_f64")}
#: the wide forms' (m > 8) launch counts in a run at m <= 8
NO_WIDE = {kid: 0 for kid in ("B2w", "B3w", "B4w", "B5w", "B2w_f64",
                              "B3w_f64", "B4w_f64", "B5w_f64")}
#: B6's unstaged forms' launch counts in a run at 12,288 features or fewer
NO_UNSTAGED = {"B6u": 0, "B6u_f64": 0}


#: kernel id -> (name, source, the TPU kernel it replaces)
KERNEL_META = {
    "B1": ("knn", "tsne_flink_tpu_torch/csrc/knn.cu",
           "tsne_flink_tpu/ops/knn_pallas.py:73"),
    "B1_bf16": ("knn_bf16", "tsne_flink_tpu_torch/csrc/knn.cu",
                "tsne_flink_tpu/ops/knn_pallas.py:73"),
    "B2": ("exact_repulsion", "tsne_flink_tpu_torch/csrc/repulsion.cu",
           "tsne_flink_tpu/ops/repulsion_pallas.py:33"),
    "B3": ("fused_step", "tsne_flink_tpu_torch/csrc/attraction.cu",
           "tsne_flink_tpu/ops/attraction_pallas.py:313"),
    "B4": ("attraction_loss", "tsne_flink_tpu_torch/csrc/attraction.cu",
           "tsne_flink_tpu/ops/attraction_pallas.py:156"),
    "B5": ("attraction_forces", "tsne_flink_tpu_torch/csrc/attraction.cu",
           "tsne_flink_tpu/ops/attraction_pallas.py:140"),
    "B6": ("refine_chunk", "tsne_flink_tpu_torch/csrc/knn_cand.cu",
           "tsne_flink_tpu/ops/knn_pallas.py:264"),
    "B1_f64": ("knn_f64", "tsne_flink_tpu_torch/csrc/knn.cu",
               "tsne_flink_tpu/ops/knn_pallas.py:73"),
    "B2_f64": ("exact_repulsion_f64",
               "tsne_flink_tpu_torch/csrc/repulsion.cu",
               "tsne_flink_tpu/ops/repulsion_pallas.py:33"),
    "B3_f64": ("fused_step_f64", "tsne_flink_tpu_torch/csrc/attraction.cu",
               "tsne_flink_tpu/ops/attraction_pallas.py:313"),
    "B4_f64": ("attraction_loss_f64",
               "tsne_flink_tpu_torch/csrc/attraction.cu",
               "tsne_flink_tpu/ops/attraction_pallas.py:156"),
    "B5_f64": ("attraction_forces_f64",
               "tsne_flink_tpu_torch/csrc/attraction.cu",
               "tsne_flink_tpu/ops/attraction_pallas.py:140"),
    "B6_f64": ("refine_chunk_f64", "tsne_flink_tpu_torch/csrc/knn_cand.cu",
               "tsne_flink_tpu/ops/knn_pallas.py:264"),
    "B6u": ("refine_chunk_unstaged", "tsne_flink_tpu_torch/csrc/knn_cand.cu",
            "tsne_flink_tpu/ops/knn_pallas.py:264"),
    "B6u_f64": ("refine_chunk_unstaged_f64",
                "tsne_flink_tpu_torch/csrc/knn_cand.cu",
                "tsne_flink_tpu/ops/knn_pallas.py:264"),
}
# the wide forms (m > 8) of B2-B5, each a kernel of its own
for _kid in ("B2", "B3", "B4", "B5"):
    for _sfx in ("", "_f64"):
        _name, _src, _repl = KERNEL_META[_kid]
        KERNEL_META[f"{_kid}w{_sfx}"] = (f"{_name}_wide{_sfx}", _src, _repl)


def fitsne_learning_rate(n: int) -> float:
    """The learning rate a user sets at large N: FIt-SNE's default,
    max(200, N/12) for the usual gradient 4·Σ(p − q)q̃(y_i − y_j), times
    4 for this package's gradient, which has no factor 4
    (TsneHelpers.scala:311-317).  The default 1000 leaves a 1.3M-point
    map unconverged after 300 iterations."""
    return 4.0 * max(200.0, n / 12.0)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def make_data(n=N_FULL, d=F_FULL, classes=CLASSES, seed=0):
    """bench.py's make_data (10-class MNIST-like blobs in [0, 1]), with the
    labels it draws."""
    rng = np.random.default_rng(seed)
    centers = rng.random((classes, d)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    x = centers[labels] + 0.15 * rng.standard_normal((n, d)).astype(
        np.float32)
    return np.clip(x, 0.0, 1.0), labels


def make_cells(n=N_CELLS, d=F_CELLS, types=CELL_TYPES, latent=10, seed=0):
    """A stand-in for the 1.3M-cell PCA matrix (the real one is not in
    the repository): ``types`` cell types with Zipf-skewed sizes,
    Gaussian clusters in a ``latent``-D space, lifted to ``d`` dims by a
    random map with a decaying per-dim scale (as principal components
    decay), plus small noise.  Returns (x f32 [n, d], labels, latent z)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, types + 1)
    labels = rng.choice(types, n, p=p / p.sum())
    centers = 4.0 * rng.standard_normal((types, latent))
    z = (centers[labels] + rng.standard_normal((n, latent))).astype(
        np.float32)
    scale = np.exp(-np.arange(d) / 12.0).astype(np.float32)
    lift = rng.standard_normal((latent, d)).astype(np.float32) * scale
    x = z @ lift + 0.05 * scale * rng.standard_normal((n, d)).astype(
        np.float32)
    return x.astype(np.float32), labels, z


def make_latent_blobs(n=N_FULL, d=F_FULL, classes=CLASSES, seed=0):
    """10 Gaussian clusters in a 3-D latent, lifted linearly to ``d``
    dims with a little noise: data of low intrinsic dimension, whose kNN
    graph has few hubs.  Returns (x f32 [n, d], labels, the latent z)."""
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.random((classes, 3))
    labels = rng.integers(0, classes, n)
    z = centers[labels] + 0.3 * rng.standard_normal((n, 3))
    a = rng.standard_normal((3, d)) / np.sqrt(3.0)
    x = z @ a + 0.01 * rng.standard_normal((n, d))
    return x.astype(np.float32), labels, z


def b1_bounds(n, f, k):
    """B1's bounds: (3xTF32 on the tensor cores — three passes of 2·N²·F
    at the TF32 peak —, and one FP32 pass outside them), each with x
    read once and [N, k] distances and ids written once."""
    nbytes = n * f * 4 + n * k * 8
    return (bound(3 * 2.0 * n * n * f, nbytes, PEAK_TF32_FLOPS),
            bound(2.0 * n * n * f, nbytes))


def alternated_ms(fns, order, reps=1):
    """CUDA-event ms of launches taken in turns: one warm-up of each
    function, then per name in ``order`` (e.g. kernel, library, library,
    kernel, ...) the mean of ``reps`` launches in a row.  Returns
    {name: [ms, ...]}."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(cuda_ms(fns[name], reps, 0))
    return out


def spread(ms):
    """'median ms (min–max)' of a list of times."""
    import statistics
    return (f"{statistics.median(ms):.4f} ms (min-max {min(ms):.4f}-"
            f"{max(ms):.4f}, {len(ms)} warm reps)")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(ops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of ops at the peak of their pipe
    (FP32 outside the tensor cores unless ``peak`` says otherwise) and
    bytes at the HBM rate."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def head_need(jval):
    """(valid entries, bytes) a head kernel needs from a row layout: every
    value (4 bytes a slot, to find the valid ones), and an index only for
    each valid entry (padding slots are skipped, their index never read)."""
    nnz = int((jval > 0).sum())
    return nnz, jval.numel() * 4 + nnz * 4


def embedding_like(n, seed):
    """A spread 2-D layout (10 clusters on a radius-30 ring) for the
    kernel checks: the magnitudes of an embedding mid-run."""
    import torch
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * rng.integers(0, 10, n) / 10
    y = np.stack([30 * np.cos(ang), 30 * np.sin(ang)], 1)
    y = y + 3.0 * rng.standard_normal((n, 2))
    return torch.from_numpy(y.astype(np.float32)).cuda()


def rel_excess(a, b, rtol):
    """(the elements with |a - b| > rtol·|b| + rtol·max|b|, max |a - b|)."""
    import torch
    err = torch.abs(a - b)
    tol = rtol * torch.abs(b) + rtol * torch.max(torch.abs(b))
    return int(torch.sum(err > tol)), float(err.max())


def rel_close(a, b, rtol, what):
    """|a - b| <= rtol·|b| + rtol·max|b|, elementwise; returns max |a - b|."""
    bad, err = rel_excess(a, b, rtol)
    check(bad == 0, f"{what}: {bad} elements beyond rtol {rtol} "
          f"(max abs err {err:.3e})")
    return err


def flushed_ms(fn, reps=10):
    """(median, list) of CUDA-event ms of single calls of ``fn``, each
    after a 256 MiB write that flushes the L2 cache (one warm-up call)."""
    import torch
    fn()
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    out = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out), out


def hold_pass(tag, y, fidx, fval, rag, z, exag=4.0, rtol=2e-5):
    """B5 and B4, one launch each over a row block ``(fidx, fval)`` (None:
    none) and a ragged part ``rag``, against their plain versions (forward
    + ragged) on the card: ``rtol`` (2e-5; 1e-12 for the float64 forms)
    with an absolute part of rtol·max|value|, the total KL to ``rtol``,
    two launches bit-identical.  Returns (max force error, max KL
    error)."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    fk = att.attraction_forces(y, y, fidx, fval, exag, ragged=rag)
    again = att.attraction_forces(y, y, fidx, fval, exag, ragged=rag)
    fp = att.attraction_forces_plain(y, y, fidx, fval, exag, ragged=rag)
    e5 = rel_close(fk, fp, rtol, f"B5 {tag}")
    check(torch.equal(fk, again), f"B5 {tag}: two launches differ")
    lk = att.attraction_loss(y, y, fidx, fval, 1.0, z, ragged=rag)
    lagain = att.attraction_loss(y, y, fidx, fval, 1.0, z, ragged=rag)
    lp = att.attraction_loss_plain(y, y, fidx, fval, 1.0, z, ragged=rag)
    e4 = rel_close(lk, lp, rtol, f"B4 {tag}")
    check(torch.equal(lk, lagain), f"B4 {tag}: two launches differ")
    check(abs(float(lk.sum()) - float(lp.sum()))
          <= rtol * float(lp.abs().sum()), f"B4 {tag} total loss")
    w = 0 if fidx is None else fidx.shape[1]
    print(f"[kernels] B5/B4 {tag}: {y.shape[0]} rows, W={w}, "
          f"{0 if rag is None else rag.dst.shape[0]} ragged edges: max "
          f"|att err| {e5:.3e}, max |loss err| {e4:.3e}; two launches "
          f"bit-identical")
    return e5, e4


def against_f64(tag, y, fidx, fval, rag, z):
    """B5 and B4 at a run's final embedding, where y_i·Σw and Σw·y_j
    cancel far more than on ``embedding_like``'s: the kernel's and the
    plain version's f32 results each against the plain version in
    float64, the kernel's max error at most twice the plain's."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    rag64 = rag._replace(val=rag.val.double())
    y64, v64 = y.double(), fval.double()
    out = {}
    for kid, kern, plain, p64 in (
            ("B5", lambda: att.attraction_forces(y, y, fidx, fval, 4.0,
                                                 ragged=rag),
             lambda: att.attraction_forces_plain(y, y, fidx, fval, 4.0,
                                                 ragged=rag),
             lambda: att.attraction_forces_plain(y64, y64, fidx, v64, 4.0,
                                                 ragged=rag64)),
            ("B4", lambda: att.attraction_loss(y, y, fidx, fval, 1.0, z,
                                               ragged=rag),
             lambda: att.attraction_loss_plain(y, y, fidx, fval, 1.0, z,
                                               ragged=rag),
             lambda: att.attraction_loss_plain(y64, y64, fidx, v64, 1.0,
                                               z.double(), ragged=rag64))):
        ref = p64()
        ek = float(torch.max(torch.abs(kern().double() - ref)))
        ep = float(torch.max(torch.abs(plain().double() - ref)))
        out[kid] = (ek, ep)
        print(f"[{tag}] {kid} at the run's final y against float64: kernel "
              f"max |err| {ek:.3e}, plain f32 {ep:.3e} (max |value| "
              f"{float(torch.max(torch.abs(ref))):.3e})")
        check(ek <= 2.0 * ep, f"[{tag}] {kid} less accurate than plain: "
              f"{ek:.3e} vs {ep:.3e}")
    return out


def edge_problem(y, w, seed):
    """An edge case of B5/B4's inputs over y's rows: a row block [N, w]
    (30% padding) and a ragged part whose row 0 is a hub of 3,000 edges,
    row 1 has none, the others 0-11, then 700 padding edges (value 0)
    owned by the last row."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    n = y.shape[0]
    rng = np.random.default_rng(seed)
    jidx = torch.from_numpy(rng.integers(0, n, (n, w)).astype(
        np.int32)).cuda()
    v = (rng.random((n, w)) * 1e-3).astype(np.float32)
    v[rng.random((n, w)) < 0.3] = 0.0
    deg = rng.integers(0, 12, n)
    deg[0], deg[1] = 3000, 0
    e = int(deg.sum())
    src = np.concatenate([np.repeat(np.arange(n), deg), np.full(700, n - 1)])
    dst = np.concatenate([rng.integers(0, n, e), np.zeros(700, np.int64)])
    val = np.concatenate([rng.random(e) * 1e-3, np.zeros(700)])
    t = [torch.from_numpy(a).cuda() for a in (src.astype(np.int32),
                                              dst.astype(np.int32),
                                              val.astype(np.float32))]
    return jidx, torch.from_numpy(v).cuda(), att.ragged_edges(*t, n)


#: the visit order optimize gives B3 (ops/attraction_cuda.visit_order)
PATH_ORDER = "hubs first"


def visit_orders(y, rag, only=None):
    """B3's visit orders, {name: int32 permutation}: the rows with the
    longest tails first (``att.visit_order``, what optimize runs), a
    Z-order of y, and the hubs first with the rest in that Z-order;
    ``only`` builds just the one named."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.zorder import zorder_permutation
    build = {
        PATH_ORDER: lambda: att.visit_order(rag),
        "in a Z-order of y": lambda: zorder_permutation(y[:, :3]),
        "hubs first, then a Z-order of y": lambda: (lambda z: z[
            torch.argsort(torch.diff(rag.rowptr)[z], descending=True,
                          stable=True)].to(torch.int32))(
            zorder_permutation(y[:, :3]).long())}
    if only is not None:
        return build[only]()
    return {name: fn() for name, fn in build.items()}


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(f"[device] {name} x{count}")
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count


def sass_start(lib_path):
    """cuobjdump's SASS listing of the library, started (None where the
    toolkit has no cuobjdump); :func:`sass_check` reads it."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    import tempfile
    out = tempfile.TemporaryFile(mode="w+")  # a pipe would stall it
    return subprocess.Popen([tool, "-sass", str(lib_path)], stdout=out,
                            stderr=subprocess.PIPE, text=True), out


def sass_check(started):
    """{kernel: (tensor-core ops, async-copy ops)} found in each SASS
    function of the library whose name holds ``knn_kernel`` (``started``:
    :func:`sass_start`'s), or None where the toolkit has no cuobjdump."""
    if started is None:
        return None
    proc, out = started
    got = child_result(proc, timeout=300)
    check(got.returncode == 0, f"[build] cuobjdump failed: "
          f"{got.stderr[-2000:]}")
    out.seek(0)
    sass = out.read()
    out.close()
    found = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if "knn_kernel" not in name:
            continue
        found[name] = (sorted({op for op in ("HMMA", "HGMMA")
                               if op in chunk}),
                       sorted({op for op in ("LDGSTS", "UTMALDG")
                               if op in chunk}))
    return found


def kernel_name(mangled):
    """'forces_kernel<8, 1, 0>' from a mangled kernel instance's name: its
    name and the integer (and bool) template arguments in order."""
    import re
    names = re.findall(r"\d+([a-z_]+?_kernel)", mangled)
    if not names:
        return mangled
    rest = mangled.split(names[-1], 1)[1].split("Ev")[0]
    ints = re.findall(r"L[ib](\d+)E", rest)
    return f"{names[-1]}<{', '.join(ints)}>"


def phase_build(sass_later=False):
    """Build the kernel library and print each instance's registers and B1's
    shapes; then B1's SASS ops, or with ``sass_later`` a function that
    prints them (cuobjdump runs meanwhile)."""
    from tsne_flink_tpu_torch.kernels.build import build, library
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_config
    res = build()
    sass_proc = sass_start(res.path)
    print(f"[build] nvcc {res.seconds:.2f} s -> {os.path.relpath(res.path)}")
    # one line a kernel instance: registers, spills, name<template ints>
    fn, spill = "?", ""
    for line in res.log.splitlines():
        if "Compiling entry function" in line:
            fn = kernel_name(line.split("'")[1] if "'" in line else line)
        elif "bytes spill stores" in line:
            spill = line.strip()
        elif "ptxas info    : Used" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            print(f"  {regs:>3} registers | {spill} | {fn}")
    library()
    for k in (K, K_CELLS, 256, 300, 1024, 1500):
        rows, stages, bufs, smem, pend = knn_config(k)
        print(f"[build] B1 at k={k}: {rows} rows a block, {stages}-stage "
              f"cp.async ring, {bufs} distance-tile buffer(s), {smem} B "
              f"shared memory" + (f", {pend} pending keys a row (the "
                                  "pending class)" if pend else ""))

    def sass_lines():
        sass = sass_check(sass_proc)
        if sass is None:
            print("[build] cuobjdump not found: B1's SASS not inspected")
        for name, (mma, copy) in (sass or {}).items():
            print(f"[build] B1 SASS {name[name.index('knn_kernel'):][:21]}: "
                  f"tensor-core ops "
                  f"{mma or 'none'}, async copies {copy or 'none'}")
    if sass_later:
        return sass_lines
    sass_lines()
    return None


def set_agreement(a, b):
    """Mean over rows of |a_i ∩ b_i| / k for two [N, k] id lists."""
    import torch
    return float(torch.mean((a[:, :, None] == b[:, None, :]).any(
        dim=2).float()))


def b1_gates(tag, x_np, k):
    """B1 against the exact answer and its plain version on the card: its
    slot-wise index agreement with the float64 graph >= 0.999 and >= the
    plain (FP32) version's own; against plain, distances within rtol
    1e-4 and neighbour sets >= 0.999; two launches bit-identical.
    Returns the max |distance error| against plain."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    xs = torch.from_numpy(x_np).cuda()
    raw = knn_sweep_cuda(xs, k, False)
    again = knn_sweep_cuda(xs, k, False)
    ik, dk = _fused_final(*raw, "sqeuclidean")
    ip, dp = _fused_final(*knn_sweep_plain(xs, k, False), "sqeuclidean")
    i64, _ = _fused_final(*knn_sweep_plain(xs.double(), k, False),
                          "sqeuclidean")
    torch.cuda.synchronize()
    agree_k = float(torch.mean((ik == i64).float()))
    agree_p = float(torch.mean((ip == i64).float()))
    sets = set_agreement(ik, ip)
    n, f = x_np.shape
    print(f"[kernels] B1 {tag} {n}x{f} k={k}: index agreement with the "
          f"float64 graph {agree_k:.6f} (plain FP32 {agree_p:.6f}); with "
          f"plain {float(torch.mean((ik == ip).float())):.6f}, sets "
          f"{sets:.6f}")
    check(agree_k >= 0.999, f"B1 {tag} agreement with float64 "
          f"{agree_k:.5f} < 0.999")
    check(agree_k >= agree_p, f"B1 {tag} agreement with float64 "
          f"{agree_k:.5f} < plain's {agree_p:.5f}")
    check(sets >= 0.999, f"B1 {tag} set agreement with plain {sets:.5f}")
    check(torch.equal(raw[0], again[0]) and torch.equal(raw[1], again[1]),
          f"B1 {tag}: two launches differ")
    err = rel_close(dk, dp, 1e-4, f"B1 {tag} distances")
    print(f"[kernels] B1 {tag}: max |d err| vs plain {err:.3e}; two "
          f"launches bit-identical")
    return err


def b1_deep_gates(tag, x_np, k):
    """B1's deep class (k > 256: 16 rows a block) on the card: its first
    256 slots are bit for bit the k = 256 class's list (the same
    distances, so the same precision as the classes the float64 bar
    holds); against plain, distances rtol 1e-4 and neighbour sets >=
    0.999; against the float64 graph, each kept neighbour within the
    float64 k-th distance (rtol 1e-6, so near-ties count) for >= 0.999 of
    the slots, and slot-wise agreement >= the plain FP32 version's own;
    two launches bit-identical.  Returns the max |distance error|."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    from tsne_flink_tpu_torch.ops.metrics import pairwise
    xs = torch.from_numpy(x_np).cuda()
    raw = knn_sweep_cuda(xs, k, False)
    again = knn_sweep_cuda(xs, k, False)
    ik, dk = _fused_final(*raw, "sqeuclidean")
    iw, dw = _fused_final(*knn_sweep_cuda(xs, 256, False), "sqeuclidean")
    ip, dp = _fused_final(*knn_sweep_plain(xs, k, False), "sqeuclidean")
    x64 = xs.double()
    i64, d64 = _fused_final(*knn_sweep_plain(x64, k, False), "sqeuclidean")
    dk64 = torch.cat([torch.gather(pairwise("sqeuclidean", x64[s:s + 1024],
                                            x64), 1, ik[s:s + 1024].long())
                      for s in range(0, xs.shape[0], 1024)])
    within = float(torch.mean((dk64 <= d64[:, -1:] * (1 + 1e-6)).float()))
    agree_k = float(torch.mean((ik == i64).float()))
    agree_p = float(torch.mean((ip == i64).float()))
    sets = set_agreement(ik, ip)
    n, f = x_np.shape
    print(f"[widths] B1 {tag} {n}x{f} k={k}: first 256 slots = the k=256 "
          f"class's: {torch.equal(ik[:, :256], iw) and torch.equal(dk[:, :256], dw)}; "
          f"within the float64 k-th {within:.6f}; slot-wise agreement with "
          f"the float64 graph {agree_k:.6f} (plain FP32 {agree_p:.6f}); "
          f"sets vs plain {sets:.6f}")
    check(torch.equal(ik[:, :256], iw) and torch.equal(dk[:, :256], dw),
          f"B1 {tag}: the deep class's first 256 slots differ from k=256's")
    check(within >= 0.999, f"B1 {tag}: {within:.5f} within the float64 k-th")
    check(agree_k >= agree_p, f"B1 {tag} agreement with float64 "
          f"{agree_k:.5f} < plain's {agree_p:.5f}")
    check(sets >= 0.999, f"B1 {tag} set agreement with plain {sets:.5f}")
    check(torch.equal(raw[0], again[0]) and torch.equal(raw[1], again[1]),
          f"B1 {tag}: two launches differ")
    return rel_close(dk, dp, 1e-4, f"B1 {tag} distances")


#: H100 SXM dense bf16 tensor-core peak at 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
#: B1's bf16 form against its plain version: the rows of the 1.3M check
#: (a seeded sample: the plain sweep sorts every column of each row)
N_BF16_ROWS_LARGE = 4_096


def b1_bf16_bound(n, f, k):
    """B1's bf16 bound: one pass of 2·N²·F at the bf16 tensor-core peak,
    x read once (float32) and [N, k] distances and ids written once."""
    return bound(2.0 * n * n * f, n * f * 4 + n * k * 8, PEAK_BF16_FLOPS)


def mm_out_dtype(device) -> bool:
    """Whether this PyTorch's ``torch.mm`` takes ``out_dtype`` (a bf16
    product with float32 output) on ``device``."""
    import torch
    a = torch.ones((2, 2), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
        return True
    except (TypeError, NotImplementedError, RuntimeError):
        return False


def library_knn_bf16(x, k, chunk=1024):
    """The one-call yardstick of B1's bf16 form: chunked bf16 matmul with
    float32 output (``torch.mm(..., out_dtype=)`` where this PyTorch has
    it, else the bf16 product widened) + topk."""
    import torch
    xb = x.to(torch.bfloat16)
    r = torch.sum(x * x, 1)
    n = x.shape[0]
    out = []
    out_dtype = mm_out_dtype(x.device)
    for s in range(0, n, chunk):
        g = (torch.mm(xb[s:s + chunk], xb.T, out_dtype=torch.float32)
             if out_dtype else (xb[s:s + chunk] @ xb.T).float())
        d = r[s:s + chunk, None] + r[None, :] - 2.0 * g
        d[torch.arange(d.shape[0]), torch.arange(s, s + d.shape[0])] = \
            float("inf")
        out.append(torch.topk(d, k, dim=1, largest=False))
    return out


def b1_bf16_gates(tag, x, k, rows=None):
    """B1's bf16 form against its plain version on the card, that plain
    version run on float64 copies of the same inputs (the rounded
    operands' products and sums exact there): distances within rtol 1e-5
    of the norm trick's terms, ``|d| + ‖a‖² + ‖b‖²`` (the scale an FP32
    accumulation of a·b is accurate to: the cells' nearest neighbours
    cancel up to ~900x, where no FP32 sum holds 1e-5 of d itself); ids
    equal outside ties (a slot whose plain distance lies within that
    tolerance of a neighbouring slot's, the (k+1)-th included); two
    launches bit-identical.  The error against rtol 1e-5 of each distance
    plus of the largest (``rel_close``'s form) is printed beside it, not
    gated.  ``rows`` (ids) restricts the plain sweep to those rows.
    Returns (max |distance error|, kernel ids and distances of the checked
    rows, both ordered, the first launch's CUDA-event ms)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    bf = torch.bfloat16
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    raw = knn_sweep_cuda(x, k, False, bf)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    again = knn_sweep_cuda(x, k, False, bf)
    check(torch.equal(raw[0], again[0]) and torch.equal(raw[1], again[1]),
          f"[bf16] B1 {tag}: two launches differ")
    ik, dk = _fused_final(*raw, "sqeuclidean")
    del raw, again
    if rows is not None:
        ik, dk = ik[rows], dk[rows]
    x64 = x.double()
    dp, ip = knn_sweep_plain(x64, k + 1, False,
                             row_chunk=256 if rows is not None else 1024,
                             matmul_dtype=bf, rows=rows)
    torch.cuda.synchronize()
    r = torch.sum(x64 * x64, 1)
    ra = r[rows if rows is not None else slice(None)][:, None]
    tol = 1e-5 * (torch.abs(dp) + ra + r[ip.long()])
    diff = torch.abs(dk.double() - dp[:, :k])
    err = float(diff.max())
    beyond = int(torch.sum(diff > tol[:, :k]))
    strict = 1e-5 * (torch.abs(dp[:, :k]) + torch.max(torch.abs(dp[:, :k])))
    print(f"[bf16] B1 {tag}: |d err| beyond rtol 1e-5 of the norm trick's "
          f"terms: {beyond}; beyond rtol 1e-5 of each distance plus of the "
          f"largest: {int(torch.sum(diff > strict))} of {diff.numel()} "
          f"(not gated); max relative to d "
          f"{float(torch.max(diff / torch.clamp(dp[:, :k], min=1e-30))):.3e}")
    check(beyond == 0, f"[bf16] B1 {tag}: {beyond} distances beyond rtol "
          "1e-5 of the norm trick's terms")
    gap = dp[:, 1:] - dp[:, :-1]                  # [rows, k]
    tied = gap[:, :k] <= tol[:, :k]               # ties with the next slot
    tied[:, 1:] |= gap[:, :k - 1] <= tol[:, 1:k]  # ... or with the previous
    same = ik.long() == ip[:, :k].long()
    off = int(torch.sum(~same & ~tied))
    # the same count with ties at rtol 1e-5 of each distance plus of the
    # largest (printed: the narrower ties of the narrower tolerance)
    near = gap[:, :k] <= strict
    near[:, 1:] |= gap[:, :k - 1] <= strict[:, 1:]
    m = ik.shape[0]
    print(f"[bf16] B1 {tag} {x.shape[0]}x{x.shape[1]} k={k} ({m} rows "
          f"checked): max |d err| vs the plain version (float64) "
          f"{err:.3e}; ids equal {float(torch.mean(same.float())):.6f}, "
          f"tied slots {float(torch.mean(tied.float())):.6f}, ids off "
          f"outside ties {off} (outside the narrower ties "
          f"{int(torch.sum(~same & ~near))}, not gated); two launches "
          "bit-identical")
    check(off == 0, f"[bf16] B1 {tag}: {off} ids differ outside ties")
    return err, ik, dk, ms


def phase_bf16(x_np, xc_np):
    """[bf16] (mixed precision, ``--dtype bfloat16``): B1's bf16 form
    (``KERNELS["B1_bf16"]``) against its plain version at [full]'s shape
    (60,000 x 784, k = 90, every row) and [large]'s (1,306,127 x 50, k =
    150, a seeded sample of rows), with ``b1_bf16_gates``' bars; at 60k
    its recall@90 and slot-wise agreement against the float64 graph of
    the unrounded x beside 3xTF32's and the plain FP32 sweep's; its time
    beside 3xTF32's and its library yardstick, in turns, with its bound;
    at 1.3M the gate's first bf16 launch (3xTF32's time at that shape is
    [large]'s).  Returns (the kernel's ms,
    plain ms, library ms), its bound and its max error at 60k."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    bf = torch.bfloat16
    t_phase = time.perf_counter()
    x = torch.from_numpy(x_np).cuda()
    n, f = x_np.shape
    err, ik, dk, _ = b1_bf16_gates("full", x, K)
    # quality against the float64 graph of the unrounded points
    i64, d64 = _fused_final(*knn_sweep_plain(x.double(), K, False),
                            "sqeuclidean")
    it, _ = _fused_final(*knn_sweep_cuda(x, K, False), "sqeuclidean")
    ip, _ = _fused_final(*knn_sweep_plain(x, K, False), "sqeuclidean")
    x64 = x.double()
    r64 = torch.sum(x64 * x64, 1)

    def true_d(ids):
        return torch.cat([torch.clamp(
            r64[s:s + 4096, None] + r64[ids[s:s + 4096].long()]
            - 2.0 * torch.einsum("rf,rkf->rk", x64[s:s + 4096],
                                 x64[ids[s:s + 4096].long()]), min=0.0)
            for s in range(0, n, 4096)])
    kth = d64[:, -1:] * (1 + 1e-5) + 1e-5
    rec = {name: (float(torch.mean((true_d(ids) <= kth).double())),
                  float(torch.mean((ids == i64).double())))
           for name, ids in (("bf16", ik), ("3xTF32", it),
                             ("plain FP32", ip))}
    print("[bf16] recall@90 against the float64 graph (true distances "
          "within its k-th), slot-wise agreement: " + "; ".join(
              f"{name} {r:.6f}, {a:.6f}" for name, (r, a) in rec.items()))
    del i64, d64, it, ip, x64, r64
    t = alternated_ms({"bf16": lambda: knn_sweep_cuda(x, K, False, bf),
                       "3xTF32": lambda: knn_sweep_cuda(x, K, False),
                       "library": lambda: library_knn_bf16(x, K)},
                      ["bf16", "3xTF32", "library", "library", "3xTF32",
                       "bf16", "bf16", "3xTF32", "library"])
    plain_ms = cuda_ms(lambda: knn_sweep_plain(x, K, False, matmul_dtype=bf),
                       1, 0)
    bnd = b1_bf16_bound(n, f, K)
    form = ("torch.mm(out_dtype=float32)" if mm_out_dtype(x.device)
            else "the bf16 product widened")
    print(f"[bf16] B1 bf16 {n}x{f} k={K}: {spread(t['bf16'])}; 3xTF32 "
          f"{spread(t['3xTF32'])}; library (chunked bf16 matmul, float32 "
          f"out by {form}, + topk) {spread(t['library'])}; plain "
          f"{plain_ms:.4f} ms; "
          f"bound {bnd[0]:.4f} ms by {bnd[1]} (bf16 at 989 TFLOP/s)")
    times = (statistics.median(t["bf16"]), plain_ms,
             statistics.median(t["library"]))
    del x, ik, dk
    torch.cuda.empty_cache()
    # [large]'s shape: a seeded sample of rows against every column
    xc = torch.from_numpy(xc_np).cuda()
    nc, fc = xc_np.shape
    rows = torch.from_numpy(np.sort(np.random.default_rng(11).choice(
        nc, N_BF16_ROWS_LARGE, replace=False))).cuda()
    # the bf16 time is the gate's first launch (B1 built and warm by then)
    ms_l = b1_bf16_gates("large", xc, K_CELLS, rows)[3]
    torch.cuda.empty_cache()
    bnd_l = b1_bf16_bound(nc, fc, K_CELLS)
    print(f"[bf16] B1 bf16 {nc}x{fc} k={K_CELLS}: {ms_l:.4f} ms "
          f"(the gate's first launch; 3xTF32's at this shape is [large]'s "
          f"'B1 knn' line); bound {bnd_l[0]:.4f} ms by {bnd_l[1]}; library "
          f"not timed at this shape")
    del xc
    torch.cuda.empty_cache()
    print(f"[bf16] {time.perf_counter() - t_phase:.1f} s")
    return times, bnd, err


def bf16_embed_gate(x_np, labels, csr_kl):
    """``TSNE(dtype="bfloat16")`` at [full]'s configuration (bruteforce,
    CSR, exact repulsion), its launches counted from 0 just before it:
    B1's bf16 form once, the 3xTF32 B1 never, the rest as [full]'s;
    final KL within KL_GUARDRAIL_TOL of [full]'s float32 run, a float32
    embedding; its 10-NN label agreement printed.  Returns the
    launches."""
    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    est = TSNE(perplexity=PERPLEXITY, n_iter=ITERATIONS, repulsion="exact",
               attraction="csr", random_state=0, dtype="bfloat16").fit(x_np)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    want = want_launches(ITERATIONS, b1=0, b1_bf16=1)
    kl = est.kl_divergence_
    agree = label_agreement(torch.from_numpy(est.embedding_).cuda(), labels)
    print(f"[bf16] TSNE(dtype='bfloat16') at [full]'s configuration: "
          f"{wall:.3f} s, launches {json.dumps(counts)}, final KL {kl:.6f} "
          f"([full] float32 {csr_kl:.6f}, |dKL| {abs(kl - csr_kl):.6f}), "
          f"10-NN label agreement {agree:.4f}, embedding "
          f"{est.embedding_.dtype}")
    check(counts == want, f"[bf16] launches {counts} != {want}")
    check(est.embedding_.dtype == np.float32
          and np.isfinite(est.embedding_).all(),
          "[bf16] the embedding is not finite float32")
    check(abs(kl - csr_kl) <= KL_GUARDRAIL_TOL,
          f"[bf16] final KL {kl} vs [full]'s {csr_kl}")
    return counts


# ---- [f64]: float64 on the card (B1-B6's float64 forms) --------------------

#: H100 SXM dense FP64 peaks at 700 W (NVIDIA data sheet): the tensor
#: cores (B1_f64's DMMA) and the FP64 pipe outside them (B2-B5)
PEAK_FP64_TC_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
#: the FP64 operations counted for one IEEE reciprocal (__drcp_rn: a
#: MUFU.RCP64H seed, two Newton steps of two DFMAs and a rounding fix-up)
RCP64_OPS = 8
#: [f64]: the rows of the 1.3M check; the card-against-CPU run (BASELINE
#: config 1's 2,500 x 50) and its iterations
N_F64_ROWS_LARGE = 4_096
N_F64_CPU, F_F64_CPU, ITER_F64_CPU = 2_500, 50, 1_000
#: [f64]: the golden tolerances (ROADMAP "Parity") the card is held to
#: against the CPU, and the float64 forms' bar against their plain versions
F64_P_ATOL, F64_Y1_ATOL, F64_RTOL = 1e-12, 1e-9, 1e-12
#: [f64]: the project kNN of the card-against-CPU check: its seed rounds
#: and refine cycles (the auto plan refines nothing at 2,500 points; two
#: cycles run B6_f64), the draws' seed; at most one row in this many may
#: differ, and only where a Z-order band differs (a projected coordinate
#: within an ulp of a cell's edge rounds to either cell)
F64_PROJECT_ROUNDS, F64_PROJECT_CYCLES, F64_PROJECT_SEED = 3, 2, 23
F64_PROJECT_ROWS_PER_DIFF = 10_000


def f64_launches(want):
    """``want``'s launches moved onto the float64 forms: B1-B6 under their
    ``_f64`` names, the float32 and bf16 forms at 0."""
    out = {kid: 0 for kid in want}
    for kid, v in want.items():
        if kid in ("B1", "B2", "B3", "B4", "B5", "B6"):
            out[kid + "_f64"] = v
    return out


def b1_f64_bound(n, f, k):
    """B1_f64's bound: 2·N²·F at the FP64 tensor-core peak; x read once
    and [N, k] float64 distances and int32 ids written once."""
    return bound(2.0 * n * n * f, n * f * 8 + n * k * 12, PEAK_FP64_TC_FLOPS)


def b1_f64_gates(tag, x, k, rows=None, twice=True):
    """B1_f64 against its plain version on the same float64 points (every
    row, or ``rows``): each distance within 1e-12 of |d| + ‖a‖² + ‖b‖²,
    ids equal outside ties (neighbours within that tolerance of each
    other); two launches bit for bit when ``twice``.  Returns (max |d|
    error, the first launch's CUDA-event ms, the held rows' distances)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    n = x.shape[0]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    raw = knn_sweep_cuda(x, k, False)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    if twice:
        again = knn_sweep_cuda(x, k, False)
        check(torch.equal(raw[0], again[0]) and torch.equal(raw[1],
                                                            again[1]),
              f"[f64] B1_f64 {tag}: two launches differ")
        del again
    ik, dk = _fused_final(*raw, "sqeuclidean")
    del raw
    if rows is not None:
        ik, dk = ik[rows], dk[rows]
    kk = min(k + 1, n - 1)
    # a sample of rows against 1.3M columns: 256-row float64 tiles (the
    # sweep's own 1,024 hold ~11 GB a temporary there)
    dp, ip = knn_sweep_plain(x, kk, False, rows=rows,
                             **({} if rows is None else {"row_chunk": 256}))
    nrm = torch.sum(x * x, dim=1)
    r = rows if rows is not None else torch.arange(n, device=x.device)
    tol = F64_RTOL * (dp.abs() + nrm[r][:, None] + nrm[ip.long()])
    err = (dk - dp[:, :k]).abs()
    beyond = int((err > tol[:, :k]).sum())
    gap = dp[:, 1:] - dp[:, :-1]
    tied = torch.zeros_like(ik, dtype=torch.bool)
    tied[:, :gap.shape[1]] |= gap[:, :k] <= tol[:, :gap.shape[1]]
    tied[:, 1:] |= gap[:, :k - 1] <= tol[:, 1:k]
    off = int((~((ik.long() == ip[:, :k].long()) | tied)).sum())
    m = dk.shape[0]
    print(f"[f64] B1_f64 {tag} {n}x{x.shape[1]} k={k} ({m} rows held): max "
          f"|d err| {float(err.max()):.3e}, {beyond} beyond 1e-12 of |d| + "
          f"|a|^2 + |b|^2; ids off outside ties {off}; the launch "
          f"{ms:.4f} ms" + ("; two launches bit-identical" if twice else ""))
    check(dk.dtype == torch.float64 and beyond == 0,
          f"[f64] B1_f64 {tag}: {beyond} distances beyond 1e-12")
    check(off == 0, f"[f64] B1_f64 {tag}: {off} ids differ outside ties")
    return float(err.max()), ms, dk


def b3_f64_gate(tag, y, hidx, hval, rag, rep, z, upd, gains, valid=None):
    """B3_f64's one launch over a head block and a ragged tail against its
    plain version (gains exactly equal; y, update and ‖grad‖² within
    rtol 1e-12 of each plus of the largest) and against the unfused
    float64 step (B5_f64 over head + tail, att − rep/Z and the vdM update
    in PyTorch) bit for bit.  Returns the max error."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    args = (y, y, hidx, hval, 4.0, rep, z, valid, upd, gains, 0.8)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
    ok = att.fused_step_update(*args, **kw)
    op = att.fused_step_plain(*args, **kw)
    check(torch.equal(ok[2], op[2]), f"[f64] B3_f64 {tag}: gains differ")
    err = max(rel_close(a, b, F64_RTOL, f"[f64] B3_f64 {tag} {what}")
              for a, b, what in zip(ok, op, ("y", "update", "gains",
                                             "|grad|^2")))
    forces = att.attraction_forces(y, y, hidx, hval, 4.0, ragged=rag)
    grad = forces - rep / z
    if valid is not None:
        grad = grad * valid[:, None].to(grad.dtype)
    same = (grad > 0.0) == (upd > 0.0)
    g = torch.clamp(torch.where(same, gains * 0.8, gains + 0.2), min=0.01)
    u = 0.8 * upd - 200.0 * g * grad
    check(all(torch.equal(a, b) for a, b in zip(ok[:3], (y + u, u, g))),
          f"[f64] B3_f64 {tag}: the fused step differs from the unfused")
    print(f"[f64] B3_f64 {tag}: {y.shape[0]} rows, max err {err:.3e}; "
          f"gains equal; the unfused float64 step's bits")
    return err


def phase_f64(x_np, xc_np):
    """[f64] (``--dtype float64``): B1_f64 against its plain version at
    [full]'s shape (60,000 x 784, k = 90, every row; two launches bit for
    bit) and on a seeded sample of [large]'s rows (1,306,127 x 50, k =
    150; one timed full launch), timed at 60k beside its library
    yardstick (chunked float64 matmul + topk) in turns; B2_f64-B5_f64 at
    m = 1..8 on [widths]' cut shapes (an edge problem: a hub row, an
    empty row, padding) against their plain versions at rtol 1e-12.
    Returns ({kid: max error}, B1_f64's (ms, plain ms, library ms), its
    bound, its 1.3M launch ms, and the 1.3M check's (rows, their exact
    distances))."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.knn_cuda import (knn_sweep_cuda,
                                                   knn_sweep_plain)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    t_phase = time.perf_counter()
    errs = {}
    x = torch.from_numpy(x_np.astype(np.float64)).cuda()
    n, f = x.shape
    errs["B1_f64"], _, _ = b1_f64_gates("full", x, K)
    t = alternated_ms({"f64": lambda: knn_sweep_cuda(x, K, False),
                       "library": lambda: library_knn(x, K)},
                      ["f64", "library", "library", "f64", "f64", "library"])
    plain_ms = cuda_ms(lambda: knn_sweep_plain(x, K, False), 1, 0)
    bnd = b1_f64_bound(n, f, K)
    print(f"[f64] B1_f64 {n}x{f} k={K}: {spread(t['f64'])}; library "
          f"(chunked float64 matmul + topk) {spread(t['library'])}; plain "
          f"{plain_ms:.4f} ms; bound {bnd[0]:.4f} ms by {bnd[1]} (FP64 "
          f"tensor cores at 67 TFLOP/s)")
    times = (statistics.median(t["f64"]), plain_ms,
             statistics.median(t["library"]))
    del x
    torch.cuda.empty_cache()
    xc = torch.from_numpy(xc_np.astype(np.float64)).cuda()
    rows = torch.from_numpy(np.sort(np.random.default_rng(11).choice(
        xc.shape[0], N_F64_ROWS_LARGE, replace=False))).cuda()
    e_l, ms_l, dk_l = b1_f64_gates("large", xc, K_CELLS, rows,
                                   twice=False)
    errs["B1_f64"] = max(errs["B1_f64"], e_l)
    bnd_l = b1_f64_bound(*xc.shape, K_CELLS)
    print(f"[f64] B1_f64 {xc.shape[0]}x{xc.shape[1]} k={K_CELLS}: "
          f"{ms_l:.4f} ms (one launch); bound {bnd_l[0]:.4f} ms by "
          f"{bnd_l[1]}")
    del xc
    torch.cuda.empty_cache()
    rng = np.random.default_rng(17)
    for m in range(1, 9):
        y = torch.from_numpy(10.0 * rng.standard_normal((N_WIDTHS, m))
                             ).cuda()
        rk, zk = cuda_exact_repulsion(y, row_z=True)
        rp, zp = exact_repulsion(y, row_z=True)
        e2 = max(rel_close(rk, rp, F64_RTOL, f"[f64] B2_f64 m={m} rep"),
                 rel_close(zk, zp, F64_RTOL, f"[f64] B2_f64 m={m} row Z"))
        again = cuda_exact_repulsion(y, row_z=True)
        check(torch.equal(again[0], rk) and torch.equal(again[1], zk),
              f"[f64] B2_f64 m={m}: two launches differ")
        fidx, fval, rag = edge_problem(y, 48, 40 + m)
        fval = fval.double()
        rag = rag._replace(val=rag.val.double())
        z = torch.sum(zp)
        e5, e4 = hold_pass(f"f64 m={m}", y, fidx, fval, rag, z,
                           rtol=F64_RTOL)
        rep = 0.1 * torch.from_numpy(rng.standard_normal((N_WIDTHS, m))
                                     ).cuda()
        upd = 1e-2 * torch.from_numpy(rng.standard_normal((N_WIDTHS, m))
                                      ).cuda()
        gains = 1.0 + torch.from_numpy(rng.random((N_WIDTHS, m))).cuda()
        valid = torch.arange(N_WIDTHS, device="cuda") % 9 != 4
        e3 = b3_f64_gate(f"m={m}", y, fidx, fval, rag, rep, z, upd, gains,
                         valid)
        for kid, e in (("B2_f64", e2), ("B3_f64", e3), ("B4_f64", e4),
                       ("B5_f64", e5)):
            errs[kid] = max(errs.get(kid, 0.0), e)
        print(f"[f64] m={m}: B2_f64 {e2:.3e}, B3_f64 {e3:.3e}, B4_f64 "
              f"{e4:.3e}, B5_f64 {e5:.3e} (max abs err; rtol 1e-12)")
    print(f"[f64] kernels {time.perf_counter() - t_phase:.1f} s")
    return errs, times, bnd, ms_l, (rows, dk_l)


def f64_full_kernels(y, csr, z_scale=None):
    """B2_f64 and B3_f64 at [full]'s shapes: the float64 run's final y
    against itself and [full]'s CSR layout (W = 256 head + the tail) in
    float64, each against its plain version (rtol 1e-12), timed beside it
    (CUDA events) with its bound.  Returns ({kid: (ms, plain ms, None)},
    {kid: bound}, {kid: max error})."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    n, m = y.shape
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True)
    errs = {"B2_f64": max(rel_close(rk, rp, F64_RTOL, "[f64] B2_f64 full"),
                          rel_close(zk, zp, F64_RTOL,
                                    "[f64] B2_f64 full row Z"))}
    hidx, hval = csr[0], csr[1].double()
    tsrc, tdst, tval = _without_padding(csr[2:])
    rag = att.ragged_edges(tsrc, tdst, tval.double(), n)
    z = torch.sum(zk)
    rng = np.random.default_rng(21)
    upd = 1e-2 * torch.from_numpy(rng.standard_normal((n, m))).cuda()
    gains = 1.0 + torch.from_numpy(rng.random((n, m))).cuda()
    errs["B3_f64"] = b3_f64_gate("full", y, hidx, hval, rag, rk, z, upd,
                                 gains)
    order = att.visit_order(rag)

    def b3():
        return att.fused_step_update(y, y, hidx, hval, 1.0, rk, z, None,
                                     upd, gains, 0.8, eta=200.0,
                                     min_gain=0.01, ragged=rag, order=order)

    def b3_plain():
        return att.fused_step_plain(y, y, hidx, hval, 1.0, rk, z, None, upd,
                                    gains, 0.8, eta=200.0, min_gain=0.01,
                                    ragged=rag)
    t = {"B2_f64": (cuda_ms(lambda: cuda_exact_repulsion(y), 20),
                    cuda_ms(lambda: exact_repulsion(y), 1, 0), None),
         "B3_f64": (cuda_ms(b3, 50), cuda_ms(b3_plain, 3), None)}
    nnz, head_bytes = head_need(hval)
    head_bytes = hval.numel() * 8 + nnz * 4
    e_tail = int(tval.shape[0])
    tail_bytes = 12.0 * e_tail + 8.0 * (n + 1)
    bounds = {
        "B2_f64": bound((20.0 + RCP64_OPS) * n * n, n * m * 8 * 2
                        + n * (m + 1) * 8, PEAK_FP64_FLOPS),
        "B3_f64": bound(20.0 * (nnz + e_tail), head_bytes + tail_bytes
                        + 7 * n * m * 8 + n * 8 + n * 4, PEAK_FP64_FLOPS),
    }
    for kid, (ms, pms, _) in t.items():
        print(f"[f64] {kid} at [full]'s shapes ({n} x {m}"
              + (f", W={hidx.shape[1]} + {e_tail} tail edges, rows "
                 f"{PATH_ORDER}" if kid == "B3_f64" else "")
              + f"): {ms:.4f} ms (plain {pms:.4f} ms, bound "
              f"{bounds[kid][0]:.4f} ms by {bounds[kid][1]})")
    return t, bounds, errs


def f64_large_pass(large):
    """B5_f64 and B4_f64 at [large]'s pass (the blocks layout's forward
    block + reverse edges, float64 copies at the run's final y): one launch
    each against its plain version (rtol 1e-12), timed after an L2 flush
    beside the plain versions, with the bytes bound of the pass at 8-byte
    values.  Returns ({kid: (ms, plain ms, None)}, {kid: bound},
    {kid: max error})."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    y_l, _, _, jidx_l, jval_l, rev, _ = large
    y = y_l.double().contiguous()
    n, m = y.shape
    fval = jval_l.double()
    rsrc, rdst, rval = _without_padding(rev)
    rag = att.ragged_edges(rsrc, rdst, rval.double(), n)
    z = torch.tensor(float(n) * n, dtype=torch.float64, device="cuda")
    e5, e4 = hold_pass("f64 [large]", y, jidx_l, fval, rag, z,
                       rtol=F64_RTOL)
    t = {"B5_f64": (flushed_ms(lambda: att.attraction_forces(
            y, y, jidx_l, fval, 1.0, ragged=rag))[0],
            cuda_ms(lambda: att.attraction_forces_plain(
                y, y, jidx_l, fval, 1.0, ragged=rag), 1, 0), None),
         "B4_f64": (flushed_ms(lambda: att.attraction_loss(
            y, y, jidx_l, fval, 1.0, z, ragged=rag))[0],
            cuda_ms(lambda: att.attraction_loss_plain(
                y, y, jidx_l, fval, 1.0, z, ragged=rag), 1, 0), None)}
    nnz = int((fval > 0).sum())
    fwd_bytes = fval.numel() * 8 + nnz * 4
    e = int(rval.shape[0])
    rev_bytes = 12.0 * e + 8.0 * (n + 1)
    bounds = {"B5_f64": bound(20.0 * (nnz + e), fwd_bytes + rev_bytes
                              + 2 * n * m * 8, PEAK_FP64_FLOPS),
              "B4_f64": bound(25.0 * (nnz + e), fwd_bytes + rev_bytes
                              + n * m * 8 + n * 8, PEAK_FP64_FLOPS)}
    for kid, (ms, pms, _) in t.items():
        print(f"[f64] {kid} at [large]'s pass (W={jidx_l.shape[1]} + {e} "
              f"reverse edges, after an L2 flush): {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {bounds[kid][0]:.4f} ms by "
              f"{bounds[kid][1]})")
    return t, bounds, {"B5_f64": e5, "B4_f64": e4}


def f64_embed_gate(x_np, labels, csr_kl):
    """``TSNE(dtype="float64")`` at [full]'s configuration (bruteforce,
    CSR, exact repulsion), its launches counted from 0 just before it:
    B1_f64 once, B2_f64 and B3_f64 every iteration, B4_f64 every 10th,
    no float32 or bf16 form; a finite float64 embedding, final KL within
    KL_GUARDRAIL_TOL of [full]'s float32 run, label agreement >= 0.9;
    then the same fit on the test mesh of two shards gives the bits of
    the mesh of one (the sharded optimizer's canonical sums).
    Returns (launches, the final y on the card, the fit's seconds)."""
    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    kw = dict(perplexity=PERPLEXITY, n_iter=ITERATIONS, repulsion="exact",
              attraction="csr", random_state=0, dtype="float64")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    est = TSNE(**kw).fit(x_np)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    want = f64_launches(want_launches(ITERATIONS))
    kl = est.kl_divergence_
    y = torch.from_numpy(est.embedding_).cuda()
    agree = label_agreement(y, labels)
    print(f"[f64] TSNE(dtype='float64') at [full]'s configuration: "
          f"{wall:.3f} s, launches {json.dumps(counts)}, final KL {kl:.6f} "
          f"([full] float32 {csr_kl:.6f}, |dKL| {abs(kl - csr_kl):.6f}), "
          f"10-NN label agreement {agree:.4f}, embedding "
          f"{est.embedding_.dtype}")
    check(counts == want, f"[f64] launches {counts} != {want}")
    check(est.embedding_.dtype == np.float64
          and np.isfinite(est.embedding_).all(),
          "[f64] the embedding is not finite float64")
    check(abs(kl - csr_kl) <= KL_GUARDRAIL_TOL and agree >= 0.9,
          f"[f64] final KL {kl} vs [full]'s {csr_kl}, agreement {agree}")
    # the sharded optimizer at float64: mesh 2 on the test mesh against
    # mesh 1 (its mesh-canonical sums, not the single-device path's)
    fits = {}
    for d in (1, 2):
        reset_launches()
        t0 = time.perf_counter()
        fits[d] = TSNE(mesh=["cuda:0"] * d, **kw).fit(x_np).embedding_
        got = launches()
        print(f"[f64] the same fit on the test mesh of {d} shard(s): "
              f"{time.perf_counter() - t0:.3f} s, launches "
              f"{json.dumps(got)}")
        check(got["B2_f64"] == d * ITERATIONS and got["B2"] == 0,
              f"[f64] mesh {d} launches {got}")
    check(np.array_equal(fits[2].view(np.uint64), fits[1].view(np.uint64)),
          "[f64] mesh 2 differs from mesh 1")
    print("[f64] mesh 2 equals mesh 1 bit for bit")
    return counts, y, wall


def f64_project_gate(x_np, labels, kl_32):
    """``TSNE(dtype="float64", knn_method="project")`` at [project]'s
    configuration (the blobs, 3 seed rounds + the auto refine cycles,
    exact repulsion), its launches counted from 0 just before it: B6_f64
    one a funnel stage a refine chunk a cycle (as [project]'s B6), B2_f64
    every iteration, B3_f64 or B5_f64 every iteration, B4_f64 every 10th,
    no B1 of any form and no float32 or bf16 form; recall@90 of its graph
    against B1_f64's exact graph >= 0.93 ([project]'s bar), final KL
    within KL_GUARDRAIL_TOL of [project]'s float32 run (``kl_32``), label
    agreement >= 0.9.  Returns (launches, seconds)."""
    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn
    n, d = x_np.shape
    b6 = b6_launches(n, d, K, pick_knn_refine(n, d))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with record_knn() as graph:
        est = TSNE(perplexity=PERPLEXITY, n_iter=ITERATIONS,
                   repulsion="exact", knn_method="project", random_state=0,
                   dtype="float64").fit(x_np)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    _, dist_e = fused_knn(torch.from_numpy(x_np.astype(np.float64)).cuda(),
                          K)
    recall = recall_at_k(graph[1], dist_e)
    del dist_e, graph[:]
    kl = est.kl_divergence_
    agree = label_agreement(torch.from_numpy(est.embedding_).cuda(), labels)
    print(f"[f64] TSNE(dtype='float64', knn_method='project') at "
          f"[project]'s configuration: {wall:.3f} s, launches "
          f"{json.dumps(counts)}; recall@{K} against B1_f64's exact graph "
          f"{recall:.4f} (bar 0.93); final KL {kl:.6f} ([project] float32 "
          f"{kl_32:.6f}, |dKL| {abs(kl - kl_32):.6f}), 10-NN label "
          f"agreement {agree:.4f}")
    step = counts["B3_f64"] + counts["B5_f64"]
    check(counts["B6_f64"] == b6 and counts["B2_f64"] == ITERATIONS
          and counts["B4_f64"] == ITERATIONS // 10 and step == ITERATIONS
          and counts["B1_f64"] == 0
          and not any(v for kid, v in counts.items()
                      if not kid.endswith("_f64")),
          f"[f64] project launches {counts} (B6_f64 {b6} wanted)")
    check(est.embedding_.dtype == np.float64
          and np.isfinite(est.embedding_).all(),
          "[f64] project: the embedding is not finite float64")
    check(recall >= 0.93, f"[f64] project recall {recall} < 0.93")
    check(abs(kl - kl_32) <= KL_GUARDRAIL_TOL and agree >= 0.9,
          f"[f64] project final KL {kl} vs {kl_32}, agreement {agree}")
    return counts, wall


def rows_recall(x, idx, rows, dist_exact):
    """recall@k of the graph ``idx``'s rows ``rows`` against the exact
    k-th distances ``dist_exact`` of those rows, each listed id's distance
    recomputed in float64 from ``x`` (the same metric for any run)."""
    import torch
    xr = x[rows].double()
    nb = x[idx[rows].long()].double()
    d = torch.sum((nb - xr[:, None, :]) ** 2, dim=2)
    return recall_at_k(d, dist_exact)


def f64_large_run(xc_np, labels, z_latent, large, b1_rows):
    """Config 5's shape at float64, once end to end: [large]'s
    configuration (1,306,127 x 50 cells, k = 150, auto -> project, FFT
    repulsion, the blocks layout) on float64 cells, its launches counted
    from 0 just before it (B6_f64 as [large]'s B6, B5_f64 and B4_f64 as
    its B5 and B4, no float32 form); the checks of [large] (finite, falling
    KL, label agreement within 0.05 of the latent's); recall@150 on the
    4,096 rows [f64] held B1_f64 on (``b1_rows``: their ids and exact
    distances) within 0.005 of the float32 [large] run's on the same rows;
    final KL within KL_GUARDRAIL_TOL of [large]'s; the memory model's
    allocated peak at the graph's width bound within [1, 2]x of the run's
    measured peak.  Returns (launches, seconds)."""
    import torch
    from tsne_flink_tpu_torch.analysis.audit.hbm import (allocated_peak,
                                                         stage_terms)
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    n, d = xc_np.shape
    cycles = pick_knn_refine(n, d)
    kl_32, cfg = large[1], large[6]
    x64 = xc_np.astype(np.float64)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with record_knn() as graph:
        y, losses, stats, counts = run_embed(
            "large f64", x64, cfg,
            lambda st: f64_launches(layout_launches(
                st["layout"], b1=0, b2=0,
                b6=b6_launches(n, d, K_CELLS, cycles))),
            neighbors=K_CELLS, knn_method="project")
    wall = time.perf_counter() - t0
    measured = stats["peak_bytes"] - held
    agree_z = label_agreement(torch.from_numpy(z_latent).cuda(), labels)
    kl = quality("large f64", y, losses, labels, cfg, agree_z - 0.05)
    rows, dk = b1_rows
    x = torch.from_numpy(xc_np).cuda()
    rec64 = recall_at_k(graph[1][rows], dk)
    rec32 = rows_recall(x, large[3], rows, dk)
    bound_w = width_bound(graph[0])
    del graph[:], x
    plan = charged_plan(PlanConfig(
        n=n, d=d, k=K_CELLS, backend="cuda", dtype="float64",
        n_components=cfg.n_components, iterations=cfg.iterations,
        knn_method="project", repulsion=cfg.repulsion, theta=cfg.theta,
        assembly="auto", attraction=cfg.attraction, sym_width=bound_w,
        row_chunk=cfg.row_chunk, fft_grid=cfg.fft_grid, name="large_f64"))
    terms = stage_terms(plan)
    pa = max(allocated_peak(t) for t in terms.values())
    ratio = pa / measured
    print(f"[f64] config 5's shape at float64 ({n} x {d}, k={K_CELLS}, "
          f"{cycles} refine cycles, {stats['layout']}): {wall:.3f} s; "
          f"recall@{K_CELLS} on the {len(rows)} rows B1_f64 held "
          f"{rec64:.5f} (the float32 [large] run's {rec32:.5f}, |d| "
          f"{abs(rec64 - rec32):.5f}, bar 0.005); final KL {kl:.6f} ("
          f"[large] float32 {kl_32:.6f}, |dKL| {abs(kl - kl_32):.6f}); "
          f"peak allocated {measured / 2**30:.3f} GiB, the memory model "
          f"({plan.assembly} at the graph's width bound {bound_w}) "
          f"{pa / 2**30:.3f} GiB = {ratio:.3f}x (bar [1, 2]); stage terms "
          + json.dumps({st: round(allocated_peak(t) / 2**30, 3)
                        for st, t in terms.items()}))
    check(y.dtype == torch.float64, f"[f64] large: y {y.dtype}")
    check(abs(rec64 - rec32) <= 0.005,
          f"[f64] large recall {rec64} vs float32's {rec32}")
    check(abs(kl - kl_32) <= KL_GUARDRAIL_TOL,
          f"[f64] large final KL {kl} vs float32's {kl_32}")
    check(1.0 <= ratio <= 2.0, f"[f64] large memory model {ratio:.3f}x "
          "the measured peak")
    del y
    return counts, wall


def f64_routes(x_np, xl_np, labels, labels_l, csr_kl):
    """The other routes at float64 on the card, each a full-size run with
    its launches (the float64 forms only): the default configuration on
    the latent blobs (rows layout: B5_f64 every iteration), the blocks
    assembly on the blobs (B5_f64 + B4_f64 over the forward block and the
    reverse edges) and FFT repulsion on the blobs (no B2_f64).  Each
    finite, falling KL, label agreement (the rows run's within 0.05 of
    its latent's bar), the blobs' runs within KL_GUARDRAIL_TOL of [full].
    Returns the rows run's launches."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    x64 = x_np.astype(np.float64)
    cfg_r = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS)
    y, losses, st, counts_r = run_embed(
        "f64 rows", xl_np.astype(np.float64), cfg_r,
        lambda s: f64_launches(layout_launches(s["layout"])))
    check(st["layout"] == "rows" and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(losses).all()),
          f"[f64] latent blobs: layout {st['layout']}, or not finite")
    print(f"[f64 rows] final KL {float(losses[-1]):.6f}")
    for tag, cfg, kw, want in (
            ("f64 blocks", TsneConfig(perplexity=PERPLEXITY,
                                      iterations=ITERATIONS),
             {"affinity_assembly": "blocks"},
             f64_launches(want_launches(0))),
            ("f64 fft", TsneConfig(perplexity=PERPLEXITY,
                                   iterations=ITERATIONS, repulsion="fft",
                                   attraction="csr"),
             {}, f64_launches(want_launches(ITERATIONS, b2=0)))):
        y, losses, st, _ = run_embed(tag, x64, cfg, want, **kw)
        kl = quality(tag, y, losses, labels, cfg, 0.9)
        print(f"[{tag}] final KL {kl:.6f} against [full]'s float32 "
              f"{csr_kl:.6f}")
        check(abs(kl - csr_kl) <= KL_GUARDRAIL_TOL,
              f"[{tag}] final KL {kl} vs [full]'s {csr_kl}")
    return counts_r


#: the CPU's half of the card-against-CPU check: a process of its own on
#: a few of the host's cores, started after [build] and read after
#: [large], so that its 1,000 CPU iterations (~4 minutes) overlap the
#: card's work; writes the kNN graph, P, y after one iteration and the
#: loss trace of the long run to an npz
F64_CPU_CHILD = r"""
import sys, time
t0 = time.perf_counter()
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(int(sys.argv[3]))
from tsne_flink_tpu_torch import TsneConfig, tsne_embed
from tsne_flink_tpu_torch.utils.artifacts import prepare
data = np.load(sys.argv[2])
x, y0 = data["x"], data["y0"]
perp, k, iters = float(data["perplexity"]), int(data["k"]), int(data["iters"])
prep = prepare(torch.as_tensor(x), neighbors=k, perplexity=perp,
               device="cpu")
y1, _ = tsne_embed(x, TsneConfig(perplexity=perp, iterations=1,
                                 repulsion="exact"), neighbors=k,
                   device="cpu", y0=y0)
import chip_smoke as cs
pidx, pdist = cs.project_with_draws(torch.as_tensor(x), k,
                                    cs.project_plan_draws(*x.shape, k))
pprep = prepare(knn=(pidx, pdist), neighbors=k, perplexity=perp,
                device="cpu")
_, losses = tsne_embed(x, TsneConfig(perplexity=perp, iterations=iters,
                                     repulsion="exact"), neighbors=k,
                       device="cpu", y0=y0)
np.savez(sys.argv[2] + ".out.npz", idx=prep.idx.numpy(),
         jidx=prep.jidx.numpy(), jval=prep.jval.numpy(), y1=y1.numpy(),
         losses=losses.numpy(), pidx=pidx.numpy(), pdist=pdist.numpy(),
         pjidx=pprep.jidx.numpy(), pjval=pprep.jval.numpy())
print(time.perf_counter() - t0)
"""
#: host threads the CPU child takes (the card's driving process keeps the
#: rest of the card machine's 8 cores)
F64_CPU_THREADS = 4


def project_plan_draws(n, d, k, rounds=F64_PROJECT_ROUNDS,
                       cycles=F64_PROJECT_CYCLES, seed=F64_PROJECT_SEED):
    """Every draw of the hybrid plan (``ops/knn.knn_project_refined``'s
    order: the seed rounds, then a cycle's ``ZORDER_PER_CYCLE`` shifted
    rounds and its refine round), float64 from a CPU generator, so that
    the card and the CPU run the plan from the same numbers: (seed
    rounds' draws, [(a cycle's Z-order draws, its refine draw)])."""
    import torch
    from tsne_flink_tpu_torch.ops import knn as tknn
    gen = torch.Generator()
    gen.manual_seed(seed)
    m = min(d, 3)
    f64 = torch.float64
    seed_draws = [tknn.draw_project(gen, d, m, it > 0, f64, "cpu")
                  for it in range(rounds)]
    fd = tknn.pick_knn_filter(d)
    plan = tknn._refine_plan(d, k, filter_dims=fd,
                             expand_k=(k + 1) // 2 if fd else None)
    cyc = []
    for _ in range(cycles):
        zd = [tknn.draw_project(gen, d, m, True, f64, "cpu")
              for _ in range(tknn.ZORDER_PER_CYCLE)]
        cyc.append((zd, tknn.draw_refine(gen, plan, n, k, d, f64, "cpu")))
    return seed_draws, cyc


def project_with_draws(x, k, draws):
    """``knn_project_refined``'s steps on ``x`` from injected ``draws``
    (:func:`project_plan_draws`), the card's tile plan on any device (the
    band blocks decide the candidates): B6_f64 runs the refine rounds on
    the card, the plain stages on the CPU.  Returns (idx, dist)."""
    import dataclasses as dc

    from tsne_flink_tpu_torch.ops import knn as tknn
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    n, d = x.shape
    tiles = pick_knn_tiles(n, d, k, "cuda")
    fd = tknn.pick_knn_filter(d)

    def on(dr):
        return dc.replace(dr, **{f.name: getattr(dr, f.name).to(x.device)
                                 for f in dc.fields(dr)
                                 if getattr(dr, f.name) is not None})
    seed_draws, cycles = draws
    idx, dist = tknn.knn_project(x, k, draws=[on(dr) for dr in seed_draws],
                                 tiles=tiles)
    for zd, rd in cycles:
        iz, dz = tknn.knn_project(x, k, draws=[on(dr) for dr in zd],
                                  tiles=tiles)
        idx, dist = tknn.merge_rounds([dist, dz], [idx, iz], k)
        idx, dist = tknn.knn_refine(x, idx, dist, rounds=1, draws=[on(rd)],
                                    filter_dims=fd, tiles=tiles,
                                    expand_k=(k + 1) // 2 if fd else None)
    return idx, dist


def f64_cpu_start(tmp):
    """Start the CPU's half of :func:`f64_card_vs_cpu` (BASELINE config
    1's 2,500 x 50 blobs at float64, its seeded initial y) in a process of
    its own.  Returns (the process, its input path)."""
    x_np, _ = make_data(n=N_F64_CPU, d=F_F64_CPU)
    path = os.path.join(tmp, "f64_cpu.npz")
    np.savez(path, x=x_np.astype(np.float64),
             y0=np.random.default_rng(5).standard_normal((N_F64_CPU, 2))
             * 1e-4, perplexity=PERPLEXITY, k=K, iters=ITER_F64_CPU)
    proc = subprocess.Popen([sys.executable, "-c", F64_CPU_CHILD, ROOT,
                             path, str(F64_CPU_THREADS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, path


def f64_card_vs_cpu(cpu):
    """The card against the CPU at float64 (BASELINE config 1's size,
    2,500 x 50 blobs, perplexity 30, k = 90, exact repulsion): the kNN
    graph's ids equal, P within ±1e-12, y after one iteration from the
    same initial y within ±1e-9, and the final KL after 1,000 iterations
    within 0.05 (the golden tolerances, ROADMAP "Parity"); then the
    project kNN (F64_PROJECT_ROUNDS seed rounds + F64_PROJECT_CYCLES
    refine cycles, B6_f64 on the card) from the same draws
    (:func:`project_plan_draws`): ids equal outside ties and every
    distance within 1e-12 of |d| + ‖a‖² + ‖b‖², at most one row in
    F64_PROJECT_ROWS_PER_DIFF differing (each printed), and P from that
    graph within ±1e-12 of the CPU's.  ``cpu`` is :func:`f64_cpu_start`'s
    (process, path): the card's runs go here, then this waits for the
    CPU's."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    proc, path = cpu
    t0 = time.perf_counter()
    data = np.load(path)
    x, y0 = data["x"], data["y0"]
    g = prepare(torch.as_tensor(x, device="cuda"), neighbors=K,
                perplexity=PERPLEXITY, device="cuda")
    y1, _ = tsne_embed(x, TsneConfig(perplexity=PERPLEXITY, iterations=1,
                                     repulsion="exact"), neighbors=K,
                       y0=y0)
    _, losses = tsne_embed(x, TsneConfig(perplexity=PERPLEXITY,
                                         iterations=ITER_F64_CPU,
                                         repulsion="exact"), neighbors=K,
                           y0=y0)
    xg = torch.as_tensor(x, device="cuda")
    reset_launches()
    pidx, pdist = project_with_draws(xg, K, project_plan_draws(*x.shape, K))
    b6 = launches()["B6_f64"]
    pprep = prepare(knn=(pidx, pdist), neighbors=K, perplexity=PERPLEXITY,
                    device="cuda")
    t_card = time.perf_counter() - t0
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        proc.kill()
        proc.wait()
    t_wait = time.perf_counter() - t0 - t_card
    check(proc.returncode == 0, f"[f64] the CPU run failed: {err[-2000:]}")
    c = np.load(path + ".out.npz")
    same_ids = (np.array_equal(g.idx.cpu().numpy(), c["idx"])
                and np.array_equal(g.jidx.cpu().numpy(), c["jidx"]))
    p_err = float(np.abs(g.jval.cpu().numpy() - c["jval"]).max())
    y1_err = float(np.abs(y1.cpu().numpy() - c["y1"]).max())
    kl_g, kl_c = float(losses[-1]), float(c["losses"][-1])
    print(f"[f64] card vs CPU at {N_F64_CPU}x{F_F64_CPU} (float64): kNN ids "
          f"equal {same_ids}; P max |err| {p_err:.3e} (bar "
          f"{F64_P_ATOL:g}); y after 1 iteration max |err| {y1_err:.3e} "
          f"(bar {F64_Y1_ATOL:g}); final KL after {ITER_F64_CPU} iterations "
          f"card {kl_g:.6f}, CPU {kl_c:.6f} (|dKL| {abs(kl_g - kl_c):.6f}); "
          f"the card's runs {t_card:.1f} s, then {t_wait:.1f} s waiting "
          f"for the CPU's ({F64_CPU_THREADS} threads, "
          f"{float(out.split()[-1]):.1f} s in all, beside the phases since "
          "[build])")
    check(same_ids, "[f64] card vs CPU: the kNN ids differ")
    check(p_err <= F64_P_ATOL, f"[f64] card vs CPU: P err {p_err}")
    check(y1_err <= F64_Y1_ATOL, f"[f64] card vs CPU: y after one "
          f"iteration err {y1_err}")
    check(abs(kl_g - kl_c) <= KL_GUARDRAIL_TOL,
          f"[f64] card vs CPU: final KL {kl_g} vs {kl_c}")
    # the project kNN from the same draws
    ci = torch.from_numpy(c["pidx"]).cuda()
    cd = torch.from_numpy(c["pdist"]).cuda()
    nrm = torch.sum(xg * xg, dim=1)
    tol = F64_RTOL * (cd.abs() + nrm[:, None] + nrm[ci.long()])
    off = (pidx.long() != ci.long()) & ((pdist - cd).abs() > tol)
    rows_off = torch.nonzero(off.any(dim=1)).flatten().tolist()
    same = ~off
    d_err = float((pdist - cd).abs()[same].max())
    beyond = int(((pdist - cd).abs() > tol)[same].sum())
    allowed = N_F64_CPU // F64_PROJECT_ROWS_PER_DIFF
    listed = f": {rows_off[:20]}" if rows_off else ""
    print(f"[f64] card vs CPU project kNN ({F64_PROJECT_ROUNDS} seed rounds "
          f"+ {F64_PROJECT_CYCLES} refine cycles from the same draws, "
          f"B6_f64 x{b6} on the card): {len(rows_off)} rows differ outside "
          f"ties (allowed {allowed}){listed}; distances max |err| "
          f"{d_err:.3e}, {beyond} beyond 1e-12 of |d| + |a|^2 + |b|^2")
    check(b6 == F64_PROJECT_CYCLES * math.ceil(
        N_F64_CPU / pick_refine_chunk(N_F64_CPU, F_F64_CPU, K)),
        f"[f64] card vs CPU project: B6_f64 launched {b6} times")
    check(len(rows_off) <= allowed and beyond == 0,
          f"[f64] card vs CPU project: {len(rows_off)} rows off, {beyond} "
          "distances beyond 1e-12")
    if not rows_off:
        pj_same = np.array_equal(pprep.jidx.cpu().numpy(), c["pjidx"])
        pp_err = float(np.abs(pprep.jval.cpu().numpy() - c["pjval"]).max())
        print(f"[f64] card vs CPU: P from the project graph: ids equal "
              f"{pj_same}, max |err| {pp_err:.3e} (bar {F64_P_ATOL:g})")
        check(pj_same and pp_err <= F64_P_ATOL,
              f"[f64] card vs CPU: P from the project graph err {pp_err}")


def pick_refine_chunk(n, d, k):
    """The refine chunk the card's tile plan gives (n, d, k)."""
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    return pick_knn_tiles(n, d, k, "cuda").refine_chunk


def b2_gates():
    """B2 against its plain version at 60,000 x 2 (rep, row Z and global Z
    within rtol 2e-5; two launches bit-identical), at m = 3, and on a
    masked row shard at a row offset.  Returns (y, plain rep, plain row Z,
    max error)."""
    import torch
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    y = embedding_like(N_FULL, 1)
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True)
    err = max(rel_close(rk, rp, 2e-5, "B2 rep"),
              rel_close(zk, zp, 2e-5, "B2 row Z"))
    zt_k, zt_p = float(torch.sum(zk)), float(torch.sum(zp))
    check(abs(zt_k - zt_p) <= 2e-5 * abs(zt_p), "B2 global Z")
    again = cuda_exact_repulsion(y, row_z=True)
    check(torch.equal(again[0], rk) and torch.equal(again[1], zk),
          "B2: two launches differ")
    print(f"[kernels] B2 {N_FULL}x2: max |rep err| {err:.3e}, "
          f"Z {zt_k:.8e} vs {zt_p:.8e}; two launches bit-identical")
    rng = np.random.default_rng(5)
    y3 = torch.cat([y, torch.from_numpy(3.0 * rng.standard_normal(
        (N_FULL, 1)).astype(np.float32)).cuda()], dim=1).contiguous()
    valid = torch.arange(N_FULL, device=y.device) < N_FULL - 777
    a, b = N_FULL // 3, 2 * N_FULL // 3
    for tag, shard, off, mask in (("m=3", y3, 0, None),
                                  (f"m=3 rows {a}-{b - 1} of a masked y",
                                   y3[a:b].contiguous(), a, valid)):
        r3k, z3k = cuda_exact_repulsion(shard, y3, row_offset=off,
                                        col_valid=mask, row_z=True)
        r3p, z3p = exact_repulsion(shard, y3, row_offset=off,
                                   col_valid=mask, row_z=True)
        e = max(rel_close(r3k, r3p, 2e-5, f"B2 {tag} rep"),
                rel_close(z3k, z3p, 2e-5, f"B2 {tag} row Z"))
        err = max(err, e)
        print(f"[kernels] B2 {tag}: max |rep/Z err| {e:.3e}")
    return y, rp, zp, err


def phase_kernels(x_np, xl_np, xc_np):
    """Kernel vs plain on the card.  Returns each kernel's max abs error,
    the real CSR layout of the blobs, the latent blobs' [N, S] rows and
    the blobs' blocks layout (forward rows, reverse edges)."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import (TsneConfig, TsneState,
                                                  _plan_layout,
                                                  _update_embedding,
                                                  _without_padding)
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.affinities import (affinity_blocks,
                                                     assemble_edges,
                                                     edge_count)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    errs = {}
    # B1 at 8,192 x 784, k = 90 (the blobs) and 8,192 x 50, k = 150 (the
    # cells, padded to 64 features)
    errs["B1"] = max(b1_gates("blobs", x_np[:N_B1_CHECK], K),
                     b1_gates("cells", xc_np[:N_B1_CHECK], K_CELLS))

    y, _, zp, errs["B2"] = b2_gates()

    # the CSR layout of the blobs, built on the card, against the host
    # build of the same rows (the build's peak above what was held)
    prep = prepare(x_np, neighbors=K, perplexity=PERPLEXITY)
    cfg = TsneConfig(perplexity=PERPLEXITY, attraction="csr")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - held
    hidx, hval, _, _, tval = csr
    t0 = time.perf_counter()
    host = att.build_csr(prep.jidx.cpu(), prep.jval.cpu(), hidx.shape[1])
    t_host = time.perf_counter() - t0
    check(all(a.device == prep.jidx.device and a.dtype == b.dtype
              and torch.equal(a.cpu(), b)
              for a, b in zip(csr, host[0] + host[1])),
          "build_csr on the card differs from the host build")
    del host
    print(f"[kernels] build_csr {N_FULL} x S={prep.jidx.shape[1]} -> W="
          f"{hidx.shape[1]} + {int((tval > 0).sum())} tail edges: on the "
          f"card {t_card:.4f} s (peak {extra / 2**30:.3f} GiB above what "
          f"was held), the same function on the host {t_host:.3f} s; the "
          f"card's head and tail equal the host's bit for bit")

    # B3 / B4 at 60,000 rows over the real CSR head + tail
    tail_rag = att.ragged_edges(*_without_padding(csr[2:]), N_FULL)
    z = torch.sum(zp)
    exag, momentum = 1.0, 0.8
    both = att.attraction_forces(y, y, hidx, hval, exag, ragged=tail_rag)
    both_p = att.attraction_forces_plain(y, y, hidx, hval, exag,
                                         ragged=tail_rag)
    # tie-free inputs: rep puts every grad (head + tail) − rep/Z at
    # s·(|att| + 1e-3·max|att|), so the gains ladder's sign test has a
    # margin far above rounding while att still shapes grad
    rng = np.random.default_rng(2)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], y.shape).astype(
        np.float32)).cuda()
    mag = torch.abs(both_p) + 1e-3 * torch.max(torch.abs(both_p))
    rep = ((both_p - sign * mag) * z).contiguous()
    upd = (1e-2 * torch.from_numpy(rng.standard_normal(y.shape).astype(
        np.float32)).cuda()).contiguous()
    gains = (1.0 + torch.from_numpy(rng.random(y.shape).astype(
        np.float32)).cuda()).contiguous()
    args = (y, y, hidx, hval, exag, rep, z, None, upd, gains, momentum)
    kw = dict(eta=1000.0, min_gain=0.01, ragged=tail_rag)
    out_k = att.fused_step_update(*args, **kw)
    out_p = att.fused_step_plain(*args, **kw)
    check(torch.equal(out_k[2], out_p[2]), "B3 gains not exactly equal")
    errs["B3"] = max(rel_close(out_k[0], out_p[0], 1e-4, "B3 y"),
                     rel_close(out_k[1], out_p[1], 1e-4, "B3 update"))
    again = att.fused_step_update(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          "B3: two launches differ")
    lk = att.attraction_loss(y, y, hidx, hval, exag, z)
    lp = att.attraction_loss_plain(y, y, hidx, hval, exag, z)
    errs["B4"] = rel_close(lk, lp, 2e-5, "B4 per-row loss")
    check(abs(float(lk.sum()) - float(lp.sum()))
          <= 2e-5 * abs(float(lp.sum())), "B4 total loss")
    print(f"[kernels] B3 (one launch over head + tail) {N_FULL}x"
          f"{hidx.shape[1]} + {int(tail_rag.dst.shape[0])} tail edges: "
          f"gains equal, max |y/upd err| {errs['B3']:.3e}; two launches "
          f"bit-identical; B4 over the head: max |loss err| "
          f"{errs['B4']:.3e}")

    # the same CSR step unfused: B5 over head + tail, att − rep/Z, then the
    # vdM update in PyTorch — the same bits
    unfused = _update_embedding(TsneState(y, upd, gains), both - rep / z,
                                momentum,
                                TsneConfig(learning_rate=kw["eta"],
                                           min_gain=kw["min_gain"]))
    check(all(torch.equal(a, b) for a, b in zip(out_k[:3], unfused)),
          "B3's one launch vs the unfused step (B5 over head + tail, "
          "att - rep/Z, vdM update): bits differ")
    # the visit orders move no bit
    for name, order in visit_orders(y, tail_rag).items():
        out_o = att.fused_step_update(*args, order=order, **kw)
        check(all(torch.equal(a, b) for a, b in zip(out_k, out_o)),
              f"B3 with its rows {name} differs from B3 in index order")
    print("[kernels] CSR step: B3's one launch equals the unfused step (B5 "
          "over head + tail, att - rep/Z, vdM update) bit for bit, and B3 "
          "with its rows hubs first, in a Z-order of y, or both equals B3 "
          "in index order bit for bit")

    # B5 and B4 over the real CSR head + tail, its tail alone, and one
    # launch over both = the head's + the tail's
    for tag, blk in (("CSR head + tail", (hidx, hval)),
                     ("CSR tail alone (W = 0)", (None, None))):
        e5, e4 = hold_pass(f"{N_FULL} x {tag}", y, *blk, tail_rag, z)
        errs["B5"] = max(errs.get("B5", 0.0), e5)
        errs["B4"] = max(errs["B4"], e4)
    parts = (att.attraction_forces(y, y, hidx, hval, exag)
             + att.attraction_forces(y, y, None, None, exag,
                                     ragged=tail_rag))
    check(torch.equal(both, parts), "B5 over head + tail is not the head's "
          "launch + the tail's, bit for bit")

    # B5 and B4 at the three widths of the new paths
    prep_l = prepare(xl_np, neighbors=K, perplexity=PERPLEXITY)
    _, fwd_val, rev = affinity_blocks(prep.idx, prep.dist, PERPLEXITY)
    widths = {"latent-blobs rows": (prep_l.jidx, prep_l.jval),
              "blobs rows": (prep.jidx, prep.jval),
              "blobs blocks forward": (prep.idx, fwd_val)}
    # the blocks layout's whole pass, the flat edge list of the blobs' rows
    # (the edges layout: no row block), and the edge problem
    rev_rag = att.ragged_edges(*_without_padding(rev), N_FULL)
    edges = assemble_edges(prep.jidx, prep.jval, edge_count(prep.jval))
    edge_rag = att.ragged_edges(*_without_padding(edges), N_FULL)
    eidx, eval_, erag = edge_problem(y, 90, 6)
    for tag, blk, rag in (
            ("blobs blocks (forward + reverse)", (prep.idx, fwd_val),
             rev_rag),
            ("blobs edges layout (W = 0)", (None, None), edge_rag),
            ("edge problem (hub row, empty row, padding)", (eidx, eval_),
             erag)):
        e5, e4 = hold_pass(tag, y, *blk, rag, z)
        errs["B5"] = max(errs["B5"], e5)
        errs["B4"] = max(errs["B4"], e4)
    for name, (ji, jv) in widths.items():
        fk = att.attraction_forces(y, y, ji, jv, 4.0)
        fp = att.attraction_forces_plain(y, y, ji, jv, 4.0)
        e5 = rel_close(fk, fp, 2e-5, f"B5 {name}")
        lk = att.attraction_loss(y, y, ji, jv, 1.0, z)
        lp = att.attraction_loss_plain(y, y, ji, jv, 1.0, z)
        e4 = rel_close(lk, lp, 2e-5, f"B4 {name}")
        check(abs(float(lk.sum()) - float(lp.sum()))
              <= 2e-5 * abs(float(lp.sum())), f"B4 {name} total loss")
        errs["B5"], errs["B4"] = max(errs["B5"], e5), max(errs["B4"], e4)
        print(f"[kernels] B5/B4 {name} {N_FULL}x{ji.shape[1]} "
              f"({int((jv > 0).sum())} entries): max |att err| {e5:.3e}, "
              f"max |loss err| {e4:.3e}")
    ji, jv = widths["blobs rows"]
    ms, plain_ms, bms, by, b4 = b5_times(y, ji, jv)
    print(f"[kernels] B5 at W={ji.shape[1]} (blobs rows): {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}); B4 there "
          f"{b4:.4f} ms")
    return errs, csr, widths["latent-blobs rows"], (prep.idx, fwd_val, rev)


def library_knn(x, k, chunk=1024):
    """One-PyTorch-call yardstick for B1: chunked matmul + topk."""
    import torch
    n = x.shape[0]
    r = torch.sum(x * x, 1)
    out = []
    for s in range(0, n, chunk):
        d = r[s:s + chunk, None] + r[None, :] - 2.0 * (x[s:s + chunk] @ x.T)
        d[torch.arange(d.shape[0]), torch.arange(s, s + d.shape[0])] = \
            float("inf")
        out.append(torch.topk(d, k, dim=1, largest=False))
    return out


def label_agreement(y, labels, n_sub=5000, nn=10, seed=3):
    import torch
    rng = np.random.default_rng(seed)
    sub = rng.choice(y.shape[0], min(n_sub, y.shape[0]), replace=False)
    ys = y[torch.from_numpy(sub).cuda()].double()
    d = torch.cdist(ys, ys)
    d.fill_diagonal_(float("inf"))
    nb = torch.topk(d, nn, dim=1, largest=False).indices.cpu().numpy()
    lab = labels[sub]
    return float(np.mean(lab[nb] == lab[:, None]))


def run_embed(tag, x_np, cfg, want, neighbors=K, knn_method="bruteforce",
              **kw):
    """One ``tsne_embed`` at full size, its launches counted from 0 just
    before it: prints the stage seconds, launches and peak memory, checks
    the launches against ``want`` (a dict, or a function of the run's
    stats); returns (y, losses, stats, launches)."""
    import torch
    from tsne_flink_tpu_torch import tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    y, losses = tsne_embed(x_np, cfg, neighbors=neighbors,
                           knn_method=knn_method, seed=0, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    n, f = x_np.shape
    print(f"[{tag}] {n}x{f} k={neighbors} knn {knn_method} perplexity="
          f"{cfg.perplexity} repulsion {cfg.repulsion} {cfg.iterations} "
          f"iterations, assembly {stats['assembly']}, layout "
          f"{stats['layout']}: {wall:.3f} s end to end")
    print(f"[{tag}] stages s: " + ", ".join(
        f"{k}={v:.4f}" for k, v in stats.items() if isinstance(v, float))
        + f", s/iter={stats['optimize'] / cfg.iterations:.6f}")
    print(f"[{tag}] knn substages s: " + ", ".join(
        f"{k}={v:.4f}" for k, v in stats["knn_substages"].items()))
    if callable(want):
        want = want(stats)
    print(f"[{tag}] launches {json.dumps(counts)}")
    print(f"[{tag}] peak memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
          "GiB of it held by this script before the run)")
    check(counts == want, f"[{tag}] launch counts {counts} != {want}")
    stats["peak_bytes"] = peak
    return y, losses, stats, counts


def quality(tag, y, losses, labels, cfg, min_agree):
    """Finite, falling KL, 10-NN label agreement >= ``min_agree``;
    returns the final KL."""
    import torch
    lh = losses.cpu().numpy()
    print(f"[{tag}] loss trace head {np.round(lh[:5], 5).tolist()} tail "
          f"{np.round(lh[-5:], 5).tolist()}; final KL {lh[-1]:.6f}")
    check(bool(torch.isfinite(y).all()) and bool(np.isfinite(lh).all()),
          f"[{tag}] non-finite embedding or loss")
    first_post = cfg.exaggeration_end // 10  # slot of iteration 110
    check(lh[-1] < lh[first_post], f"[{tag}] KL did not fall: {lh[-1]} vs "
          f"slot {first_post} {lh[first_post]}")
    agree = label_agreement(y, labels)
    print(f"[{tag}] 10-NN label agreement (5k subsample) {agree:.4f} "
          f"(bar {min_agree:.4f})")
    check(agree >= min_agree, f"[{tag}] label agreement {agree} < "
          f"{min_agree}")
    return float(lh[-1])


def want_launches(b3, b1=1, b2=None, b6=0, b1_bf16=0):
    """Launches of one run: B2 every iteration unless given, B3 every
    iteration of a fused CSR run (``b3``: the whole step, head and tail),
    B5 every iteration of any other (the unfused step's attraction
    pass), B4 every 10th (the KL over both parts); B1's bf16 form only in
    a bf16-operand run."""
    return {"B1": b1, "B1_bf16": b1_bf16, **NO_F64, **NO_WIDE, **NO_UNSTAGED,
            "B2": ITERATIONS if b2 is None else b2, "B3": b3,
            "B4": ITERATIONS // 10, "B5": ITERATIONS - b3, "B6": b6}


def layout_launches(layout, **kw):
    """The launches of a run whose attraction layout resolved to
    ``layout``: B3 alone runs the CSR step, B5 every other layout's, B4
    every layout's KL."""
    return want_launches(b3=ITERATIONS if layout == "csr" else 0, **kw)


def b6_launches(n, d, k, cycles):
    """B6 launches of the hybrid plan: one per funnel stage (JL filter,
    cascade, exact) per refine chunk per cycle."""
    from tsne_flink_tpu_torch.ops import knn as tknn
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    fd = tknn.pick_knn_filter(d)
    plan = tknn._refine_plan(d, k, filter_dims=fd,
                             expand_k=(k + 1) // 2 if fd else None)
    stages = 1 + bool(plan.filter_dims) + bool(plan.cascade_dims)
    chunk = pick_knn_tiles(n, d, k, "cuda").refine_chunk
    return cycles * math.ceil(n / chunk) * stages


@contextlib.contextmanager
def record_knn():
    """Keep the graph the run's kNN stage returns (the list yielded gets
    (idx, dist)); the stage itself runs unchanged."""
    from tsne_flink_tpu_torch.ops import knn as tknn
    real = tknn.knn
    graph = []

    def recorded(*a, **kw):
        out = real(*a, **kw)
        graph[:] = out
        return out

    tknn.knn = recorded
    try:
        yield graph
    finally:
        tknn.knn = real


def recall_at_k(dist_approx, dist_exact, tol=1e-5):
    """scripts/measure_recall.recall_at_k: the approximate distances
    within the exact k-th (ties count as hits)."""
    import torch
    kth = dist_exact[:, -1:] * (1 + tol) + tol
    return float(torch.mean((dist_approx <= kth).double()))


def timed_exact_graph(x, k):
    """B1's exact graph of ``x`` and its seconds (host clock to the end
    of the device's work)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn import knn_bruteforce
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = knn_bruteforce(x, k)
    torch.cuda.synchronize()
    return idx, dist, time.perf_counter() - t0


def kernel_record(kid, name, src, repl, launches, err, times, bnd):
    ms, plain_ms, lib_ms = times
    bms, by = bnd
    return {"name": f"{kid} {name}", "route": "cuda", "source": src,
            "replaces": repl, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def phase_full(x_np, labels, errs, csr):
    """The CSR run; returns the records of B1-B3, its final KL, its final
    embedding and launches, and B1's and B2's ms at its shapes."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.knn_cuda import (knn_sweep_cuda,
                                                   knn_sweep_plain)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact", attraction="csr")
    y, losses, stats, counts = run_embed("full", x_np, cfg,
                                         want_launches(ITERATIONS))
    check(stats["layout"] == "csr", f"[full] layout {stats['layout']}")
    final_kl = quality("full", y, losses, labels, cfg, 0.9)

    staged = sum(stats[k] for k in ("knn", "affinities", "plan", "optimize"))
    print(f"[full] plan stage (build_csr on the card) {stats['plan']:.4f} "
          f"s of {staged:.4f} s in stages")
    # each kernel at the run's shapes: the final embedding and the real CSR
    x = torch.from_numpy(x_np).cuda()
    hidx, hval, tsrc, tdst, tval = csr
    n, w, m = N_FULL, hidx.shape[1], 2
    rep, zrow = cuda_exact_repulsion(y, row_z=True)
    z = torch.sum(zrow)
    # the tail as optimize runs it (without its padding)
    tail_rag = att.ragged_edges(*_without_padding((tsrc, tdst, tval)), n)
    upd, gains = torch.zeros_like(y), torch.ones_like(y)
    step = (y, y, hidx, hval, 1.0, rep, z, None, upd, gains, 0.8)
    kw = dict(eta=cfg.learning_rate, min_gain=cfg.min_gain, ragged=tail_rag)
    # B3 with its rows in each visit order and in index order, in turns,
    # at the run's final y; each order's cost beside it (the hubs-first
    # order is built once a run, a Z-order of y would be refreshed every
    # 10th iteration)
    orders = visit_orders(y, tail_rag)
    fns = {"index order": lambda: att.fused_step_update(*step, **kw)}
    for name, order in orders.items():
        fns[name] = (lambda o: lambda: att.fused_step_update(
            *step, order=o, **kw))(order)
    b3 = alternated_ms(fns, [*fns, *reversed(fns)] * 3, reps=20)
    build = {name: cuda_ms(lambda: visit_orders(y, tail_rag, name), 20)
             for name in orders}
    for name, ms in b3.items():
        extra = ("" if name == "index order" else
                 f"; building the order {build[name]:.4f} ms")
        print(f"[full] B3 one launch at the run's final y, W={w} + "
              f"{int(tail_rag.dst.shape[0])} tail edges, rows {name}: "
              f"{spread(ms)}{extra}")
    b3_ms = statistics.median(b3[PATH_ORDER])
    # B1 and its one-call yardstick in turns, after a warm-up of each
    b1 = alternated_ms({"kernel": lambda: knn_sweep_cuda(x, K, False),
                        "library": lambda: library_knn(x, K)},
                       ["kernel", "library", "library", "kernel", "kernel",
                        "library"])
    t = {
        "B1": (statistics.median(b1["kernel"]),
               cuda_ms(lambda: knn_sweep_plain(x, K, False), 1, 0),
               statistics.median(b1["library"])),
        "B2": (cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20),
               cuda_ms(lambda: exact_repulsion(y, row_z=True), 3), None),
        "B3": (b3_ms, cuda_ms(lambda: att.fused_step_plain(*step, **kw), 5),
               None),
        "B4": (cuda_ms(lambda: att.attraction_loss(
                   y, y, hidx, hval, 1.0, z, ragged=tail_rag), 50),
               cuda_ms(lambda: att.attraction_loss_plain(
                   y, y, hidx, hval, 1.0, z, ragged=tail_rag), 5), None),
    }
    nnz, head_bytes = head_need(hval)
    b1_tf32, b1_fp32 = b1_bounds(n, F_FULL, K)
    print(f"[full] B1 knn {n}x{F_FULL} k={K}: {spread(b1['kernel'])}; "
          f"library (chunked matmul + topk) {spread(b1['library'])}; "
          f"bound {b1_tf32[0]:.4f} ms (3xTF32 on the tensor cores), "
          f"{b1_fp32[0]:.4f} ms (one FP32 pass outside them)")
    e_tail = int(tail_rag.dst.shape[0])
    tail_bytes = 8.0 * e_tail + 8.0 * (n + 1)
    bounds = {
        "B1": b1_tf32,
        "B2": bound(20.0 * n * n, n * m * 4 * 2 + n * 4),
        # head + tail, y, rep, update, gains read and y, update, gains
        # written, gsq and the order
        "B3": bound(20.0 * (nnz + e_tail),
                    head_bytes + tail_bytes + 7 * n * m * 4 + 2 * n * 4),
        "B4": bound(25.0 * (nnz + e_tail),
                    head_bytes + tail_bytes + n * m * 4 + n * 4),
    }
    kernels = []
    for kid, (ms, plain_ms, lib_ms) in t.items():
        name, src, repl = KERNEL_META[kid]
        bms, by = bounds[kid]
        what = {"B3": f" (head + tail, rows {PATH_ORDER})",
                "B4": " (head + tail)"}
        print(f"[full] {kid} {name}{what.get(kid, '')}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
              f"{bms:.4f} ms by {by}) x{counts[kid]} launches")
        if kid in ("B1", "B2", "B3"):  # B4-B6: from the large run
            kernels.append(kernel_record(kid, name, src, repl, counts[kid],
                                         errs[kid], t[kid], bounds[kid]))
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    order_ms = build[PATH_ORDER] / ITERATIONS  # built once a run
    rest = (it_ms - t["B2"][0] - t["B3"][0] - order_ms - t["B4"][0] / 10)
    print(f"[full] per iteration {it_ms:.4f} ms: B2 {t['B2'][0]:.4f}, B3 "
          f"(one launch, head + {e_tail} tail edges) {t['B3'][0]:.4f}, the "
          f"visit order (built once, /{ITERATIONS}) {order_ms:.4f}, B4/10 "
          f"{t['B4'][0] / 10:.4f}, the rest {rest:.4f} (by difference)")
    return kernels, final_kl, (y, counts), t["B1"][0], t["B2"][0]


def b5_times(y, jidx, jval):
    """(ms, plain ms, bound ms, bound by) of B5, and B4's ms, at a
    layout's shapes.  B5's bound: the bytes of ``head_need`` + y read and
    att written (2·N·m·4), about 20 operations a valid entry."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    n = jidx.shape[0]
    m = y.shape[1]
    nnz, need = head_need(jval)
    z = torch.tensor(float(n) * n, device=y.device)
    return (cuda_ms(lambda: att.attraction_forces(y, y, jidx, jval, 1.0),
                    50),
            cuda_ms(lambda: att.attraction_forces_plain(y, y, jidx, jval,
                                                        1.0), 5),
            *bound(20.0 * nnz, need + 2 * n * m * 4),
            cuda_ms(lambda: att.attraction_loss(y, y, jidx, jval, 1.0, z),
                    50))


def pass_times(tag, y, fidx, fval, rev):
    """The blocks layout's attraction pass at a run's shapes, each call
    timed after an L2 flush (median of 10): one launch of B5 and of B4
    over the forward block and the reverse edges (without their padding,
    as optimize runs them), beside the old pair — B5 over the forward
    block + the reverse edges' sorted segment sum, B4 + their KL — and the
    plain versions.  Bounds: the bytes of the pass (each slot's value,
    each valid slot's index, 8 bytes an edge and a row pointer, the [N, m]
    planes) at the HBM rate; beside them the L2 sectors its gathers touch
    (32 B a gathered neighbour row).  Returns ({kid: (ms, plain ms,
    None)}, {kid: bound})."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    n, m = y.shape
    rsrc, rdst, rval = _without_padding(rev)
    rag = att.ragged_edges(rsrc, rdst, rval, n)
    lengths = torch.diff(rag.rowptr)
    z = torch.tensor(float(n) * n, device=y.device)
    fns = {
        "B5": lambda: att.attraction_forces(y, y, fidx, fval, 1.0,
                                            ragged=rag),
        "B4": lambda: att.attraction_loss(y, y, fidx, fval, 1.0, z,
                                          ragged=rag),
        "B5 forward": lambda: att.attraction_forces(y, y, fidx, fval, 1.0),
        "segment sum": lambda: att.edge_forces_plain(y, y, rsrc, rdst, rval,
                                                     1.0, lengths),
        "B4 forward": lambda: att.attraction_loss(y, y, fidx, fval, 1.0, z),
        "edge loss": lambda: att.edge_loss_plain(y, y, rsrc, rdst, rval, 1.0,
                                                 z, lengths),
    }
    t = {name: flushed_ms(fn)[0] for name, fn in fns.items()}
    plain5 = cuda_ms(lambda: att.attraction_forces_plain(
        y, y, fidx, fval, 1.0, ragged=rag), 3)
    plain4 = cuda_ms(lambda: att.attraction_loss_plain(
        y, y, fidx, fval, 1.0, z, ragged=rag), 3)
    nnz, fwd_bytes = head_need(fval)
    e = int(rval.shape[0])
    rev_bytes = 8.0 * e + 8.0 * (n + 1)
    bounds = {"B5": bound(20.0 * (nnz + e),
                          fwd_bytes + rev_bytes + 2 * n * m * 4),
              "B4": bound(25.0 * (nnz + e),
                          fwd_bytes + rev_bytes + n * m * 4 + n * 4)}
    old5 = t["B5 forward"] + t["segment sum"]
    old4 = t["B4 forward"] + t["edge loss"]
    print(f"[{tag}] attraction pass over W={fidx.shape[1]} ({nnz} entries) "
          f"+ {e} reverse edges, each call after an L2 flush (medians of "
          f"10): B5 one launch {t['B5']:.4f} ms vs B5 forward "
          f"{t['B5 forward']:.4f} + reverse segment sum "
          f"{t['segment sum']:.4f} = {old5:.4f} ms; B4 one launch "
          f"{t['B4']:.4f} ms vs B4 forward {t['B4 forward']:.4f} + reverse "
          f"edge loss {t['edge loss']:.4f} = {old4:.4f} ms")
    print(f"[{tag}] the pass's bound: B5 {bounds['B5'][0]:.4f} ms, B4 "
          f"{bounds['B4'][0]:.4f} ms (bytes: {fwd_bytes / 1e9:.4f} GB of "
          f"slots + {rev_bytes / 1e9:.4f} GB of edges); its gathers touch "
          f"{(nnz + e) / 1e6:.2f}M L2 sectors ({32.0 * (nnz + e) / 1e9:.3f} "
          f"GB at 32 B each); plain B5 {plain5:.4f} ms, plain B4 "
          f"{plain4:.4f} ms")
    return ({"B5": (t["B5"], plain5, None), "B4": (t["B4"], plain4, None)},
            bounds)


def phase_rows(xl_np, labels, z_latent, rows, errs):
    """The default configuration on the latent blobs: auto must take the
    rows layout; B5 and B4 timed at its [N, S] rows.  Returns its final
    embedding and launches."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS)
    agree_z = label_agreement(torch.from_numpy(z_latent).cuda(), labels)
    print(f"[rows] the 3-D latent's own 10-NN label agreement {agree_z:.4f}")
    y, losses, stats, counts = run_embed("rows", xl_np, cfg,
                                         want_launches(0))
    check(stats["layout"] == "rows",
          f"[rows] auto resolved to {stats['layout']}, not rows")
    kl = quality("rows", y, losses, labels, cfg, agree_z - 0.05)
    jidx, jval = rows
    n, s = jidx.shape
    print(f"[rows] S={s}, {int((jval > 0).sum())} entries "
          f"({float((jval > 0).sum()) / n:.2f} a row)")
    b2 = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20)
    ms, plain_ms, bms, by, b4 = b5_times(y, jidx, jval)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    rest = it_ms - b2 - ms - b4 / 10
    print(f"[rows] B5 at W={s}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms by {by}) x{counts['B5']} launches; B4 "
          f"{b4:.4f} ms")
    print(f"[rows] per iteration {it_ms:.4f} ms: B2 {b2:.4f}, B5 {ms:.4f}, "
          f"B4/10 {b4 / 10:.4f}, the rest {rest:.4f} (by difference)")
    return y, counts, kl, stats["optimize"]


def phase_blocks(x_np, labels, blocks, csr_kl):
    """The blocks assembly on the blobs: the CSR run's checks, its final KL
    within KL_GUARDRAIL_TOL of the CSR run's, and its attraction pass
    timed as ``pass_times`` says."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact")
    y, losses, stats, counts = run_embed("blocks", x_np, cfg,
                                         want_launches(0),
                                         affinity_assembly="blocks")
    check(stats["layout"] == "blocks", f"[blocks] layout {stats['layout']}")
    kl = quality("blocks", y, losses, labels, cfg, 0.9)
    print(f"[blocks] final KL {kl:.6f} vs the CSR run's {csr_kl:.6f}: gap "
          f"{kl - csr_kl:+.6f} (bar {KL_GUARDRAIL_TOL})")
    check(abs(kl - csr_kl) <= KL_GUARDRAIL_TOL,
          f"[blocks] final KL {kl} vs CSR {csr_kl}")
    fidx, fval, rev = blocks
    b2 = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20)
    t, _ = pass_times("blocks", y, fidx, fval, rev)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    b5, b4 = t["B5"][0], t["B4"][0]
    print(f"[blocks] per iteration {it_ms:.4f} ms: B2 {b2:.4f}, B5 {b5:.4f} "
          f"x{counts['B5']}, B4/10 {b4 / 10:.4f}, the rest "
          f"{it_ms - b2 - b5 - b4 / 10:.4f} (by difference)")


class _Captured(Exception):
    pass


def capture_refine_chunks(x, k, chunks, row_chunk=None):
    """The funnel stages of the first ``chunks`` chunks of one refine round
    over a three-round Z-order seed graph of ``x`` (the seed the hybrid
    plan starts from), as the round calls them: per chunk, a list of
    (kind, args, kwargs), kind "keep" or "final".  The round stops once
    they are taken (``chunks`` None: every chunk of the round).
    ``row_chunk`` replaces the tile plan's chunk rows."""
    import torch
    from tsne_flink_tpu_torch.ops import knn as tknn
    got = [[]]
    real = {"keep": tknn.refine_keep, "final": tknn.refine_final}

    def grab(kind):
        def stage(*args, **kwargs):
            got[-1].append((kind, args, kwargs))
            out = real[kind](*args, **kwargs)
            if kind == "final":
                if chunks is not None and len(got) == chunks:
                    raise _Captured
                got.append([])
            return out
        return stage

    gen = torch.Generator(device=x.device)
    gen.manual_seed(0)
    idx, dist = tknn.knn_project(x, k, rounds=3, generator=gen)
    fd = tknn.pick_knn_filter(x.shape[1])
    tknn.refine_keep, tknn.refine_final = grab("keep"), grab("final")
    try:
        tknn.knn_refine(x, idx, dist, generator=gen, filter_dims=fd,
                        expand_k=(k + 1) // 2 if fd else None,
                        row_chunk=row_chunk)
    except _Captured:
        pass
    finally:
        tknn.refine_keep, tknn.refine_final = real["keep"], real["final"]
    return [chunk for chunk in got if chunk and chunk[-1][0] == "final"]


def chunks_ms(stages, plain=False):
    """CUDA-event milliseconds a chunk of one funnel stage run over
    consecutive chunks of a round (``stages``: their (kind, args, kwargs)),
    in sequence as the round runs them, after a 1 GiB write that flushes
    the L2 cache and keeps the card busy while the host enqueues."""
    import torch
    for kind, args, kwargs in stages[:2]:
        stage_call(kind, args, kwargs, plain)
    flush = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    flush.zero_()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for kind, args, kwargs in stages:
        stage_call(kind, args, kwargs, plain)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / len(stages)


def stage_call(kind, args, kwargs, plain=False):
    """One funnel stage through its wrapper (kernel B6 on the card) or its
    plain version, on the same inputs."""
    from tsne_flink_tpu_torch.ops import knn_cuda as kc
    fn = {("keep", False): kc.refine_keep, ("keep", True): kc.refine_keep_plain,
          ("final", False): kc.refine_final,
          ("final", True): kc.refine_final_plain}[kind, plain]
    return fn(*args, **kwargs)


def stage_rows(kind, args):
    """The stage's chunk rows and its scoring operand (base, its norms)."""
    import torch
    if kind == "keep":
        base, sq, row0, cand = args[:4]
    else:
        _, base, sq, row0, cand = args[:5]
    rows = torch.arange(row0, row0 + cand.shape[0], device=cand.device)
    return rows, base, sq


def stage_candidates(kind, args, kwargs):
    """Each row's candidates as the stage sees them: (ids [c, Z] with -1
    for none, per-row count) — built from the gateways in a first stage."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import refine_candidates_plain
    rows, _, _ = stage_rows(kind, args)
    cand = args[3] if kind == "keep" else args[4]
    if kwargs.get("graph") is not None:
        ids, bad = refine_candidates_plain(int(rows[0]), cand,
                                           kwargs["graph"], kwargs["ke"],
                                           kwargs.get("n_valid"))
        ids = torch.where(bad, -1, ids)
    else:
        ids = cand.long()
    return ids, (ids >= 0).sum(dim=1)


def stage_bound(kind, args, kwargs, out):
    """B6's bound on one stage from this run's inputs: each input read once
    — the U distinct rows of the scored operand the stage touches (F + 1
    values each: the row and its norm, 4 bytes or 8 at float64), the
    gateways and the first ke ids of each distinct gateway's list (a first
    stage) or the candidate list, the old lists (exact stage) — and each
    output written once; 2F + 3 operations a unique candidate of a row
    (the FP32 pipe, or the FP64 pipe for B6_f64)."""
    import torch
    rows, base, _ = stage_rows(kind, args)
    ids, count = stage_candidates(kind, args, kwargs)
    c, f = rows.shape[0], base.shape[1]
    isz = base.element_size()
    u = int(torch.unique(torch.cat([rows, ids[ids >= 0]])).numel())
    cand = args[3] if kind == "keep" else args[4]
    nbytes = isz * u * (f + 1) + 4.0 * cand.numel()
    if kwargs.get("graph") is not None:
        nbytes += 4.0 * int(torch.unique(cand).numel()) * kwargs["ke"]
    outs = out if isinstance(out, tuple) else (out,)
    nbytes += sum(t.element_size() * t.numel() for t in outs
                  if t is not None)
    if kind == "final":
        nbytes += (4.0 + isz) * args[5].numel()
    peak = PEAK_FP32_FLOPS if isz == 4 else PEAK_FP64_FLOPS
    return bound(float(count.sum()) * (2.0 * f + 3.0), nbytes, peak), u, count


def check_row_ids(what, ids, rows):
    """A stage's output ids: the row itself absent, no id twice in a row
    (-1 marks no candidate).  Returns the mask of listed ids."""
    import torch
    valid = ids >= 0
    check(not bool((ids == rows[:, None]).any()), f"{what}: self kept")
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        ids.shape[1], device=ids.device)), dim=1).values
    check(not bool((srt[:, 1:] == srt[:, :-1]).any()),
          f"{what}: an id twice in a row")
    return valid


def hold_stage(tag, kind, args, kwargs, got=None):
    """The kernel against its plain version on one stage's inputs, on the
    card.  Exact stage: every output distance is the plain formula's for
    its (row, id), or the id's old distance where that is smaller, to
    rtol 2e-5; neighbour sets agree with the plain
    stage's >= 0.999; each row's k-th distance agrees to rtol 2e-5; ids
    are distinct per row, the row itself absent, rows ordered by (d, id).
    Keep stage: each row keeps min(keep, its unique candidates), the kept
    sets agree >= 0.999, the last kept score agrees to rtol 2e-5, ids are
    distinct, the row absent, -1 only after the kept ones and in rank
    order.  Both: two launches bit-identical.  ``got``: the kernel's
    output for these rows, taken from a larger launch (whose bits the
    caller holds).  Returns the max |error| of the distances (exact stage)
    or scores (keep stage)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (cand_exact_plain,
                                                   cand_sqdist_plain)
    rows, base, sq = stage_rows(kind, args)
    if got is None:
        got, again = (stage_call(kind, args, kwargs),
                      stage_call(kind, args, kwargs))
    else:  # a slice of a launch whose bits the caller held
        again = got
    want = stage_call(kind, args, kwargs, plain=True)
    torch.cuda.synchronize()
    if kind == "final":
        (gi, gd), (wi, wd) = got, want
        check(torch.equal(gi, again[0]) and torch.equal(gd, again[1]),
              f"B6 {tag}: two launches differ")
        # an id the stage scored carries the formula's distance, or its old
        # one where that is smaller (the old lists' distances come from
        # earlier stages, rounded their own way)
        metric, old_i, old_d = args[0], args[5], args[6]
        formula = cand_exact_plain(metric, base, sq, rows, gi)
        in_old = gi[:, :, None] == old_i[:, None, :]
        old = torch.where(in_old, old_d[:, None, :], math.inf).amin(dim=2)
        err = rel_close(gd, torch.minimum(formula, old), 2e-5,
                        f"B6 {tag} distances vs the formula")
        rel_close(gd[:, -1], wd[:, -1], 2e-5, f"B6 {tag} k-th distance")
        ids_k, ids_p = gi.long(), wi.long()
        same_d = gd[:, 1:] == gd[:, :-1]
        ordered = bool(((gd[:, 1:] > gd[:, :-1])
                        | (same_d & (ids_k[:, 1:] > ids_k[:, :-1]))).all())
        check(ordered, f"B6 {tag}: rows not ordered by (d, id)")
    else:
        gi, wi = got[0].long(), torch.where(want[1], -1, want[0])
        check(torch.equal(got[0], again[0]), f"B6 {tag}: two launches differ")
        _, count = stage_candidates(kind, args, kwargs)
        kept = (gi >= 0).sum(dim=1)
        check(torch.equal(kept, torch.clamp(count, max=gi.shape[1])),
              f"B6 {tag}: rows keep the wrong number of candidates")
        pos = torch.arange(gi.shape[1], device=gi.device)
        check(bool(((gi >= 0) == (pos[None, :] < kept[:, None])).all()),
              f"B6 {tag}: -1 before a kept candidate")
        safe_k = torch.where(gi >= 0, gi, rows[:, None])
        safe_p = torch.where(wi >= 0, wi, rows[:, None])
        sk = cand_sqdist_plain(base, sq, rows, safe_k)
        sp = cand_sqdist_plain(base, sq, rows, safe_p)
        last = torch.clamp(kept - 1, min=0)[:, None]
        err = rel_close(torch.gather(sk, 1, last), torch.gather(sp, 1, last),
                        2e-5, f"B6 {tag} last kept score")
        tol = 2e-5 * (torch.abs(sk[:, :-1]) + torch.max(torch.abs(sk)))
        valid = (gi[:, 1:] >= 0)
        check(bool(((sk[:, 1:] >= sk[:, :-1] - tol) | ~valid).all()),
              f"B6 {tag}: kept candidates not in rank order")
        ids_k, ids_p = gi, wi
    valid = check_row_ids(f"B6 {tag}", ids_k, rows)
    hits = (ids_k[:, :, None] == ids_p[:, None, :]).any(dim=2) & valid
    sets = float(hits.sum()) / max(1, int(valid.sum()))
    check(sets >= 0.999, f"B6 {tag}: set agreement with plain {sets:.5f}")
    return err, sets


def ids_off_outside_ties(ids_k, d_k, ids_p, d_p, tol):
    """Slots whose ids differ though their distances do not tie: at a
    slot where the two lists hold other ids, the two distances lie more
    than ``tol`` (per slot) apart."""
    return int(((ids_k.long() != ids_p.long())
                & ((d_k - d_p).abs() > tol)).sum())


def hold_stage_f64(tag, kind, args, kwargs, got=None):
    """B6_f64 against its plain version on one stage's float64 inputs, on
    the card, at B1_f64's bar.  Exact stage: every output distance within
    1e-12 of |d²| + ‖a‖² + ‖b‖² of the plain formula's for its (row, id)
    (or of the id's old distance where that is smaller; squared for
    euclidean), the ids equal the plain stage's outside ties (a slot may
    hold another id only at a distance within that bar), rows ordered by
    (d, id).  Keep stage: each row keeps min(keep, its unique candidates),
    -1 only after them, and its kept set equals the plain stage's outside
    ties at the cut (an id in one set alone scores within the bar of the
    plain stage's last kept score).  Both: ids distinct, the row absent,
    two launches bit-identical (``got`` as :func:`hold_stage`'s).
    Returns (the max |error| of the distances or of the cut's score, the
    slots or ids off outside ties: 0)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (cand_exact_plain,
                                                   cand_sqdist_plain)
    rows, base, sq = stage_rows(kind, args)
    if got is None:
        got, again = (stage_call(kind, args, kwargs),
                      stage_call(kind, args, kwargs))
    else:  # a slice of a launch whose bits the caller held
        again = got
    want = stage_call(kind, args, kwargs, plain=True)
    torch.cuda.synchronize()

    def tol_of(ids, d2):
        safe = torch.where(ids >= 0, ids, rows[:, None]).long()
        return F64_RTOL * (d2.abs() + sq[rows][:, None] + sq[safe])
    if kind == "final":
        (gi, gd), (wi, wd) = got, want
        check(gd.dtype == torch.float64, f"B6_f64 {tag}: distances {gd.dtype}")
        check(torch.equal(gi, again[0]) and torch.equal(gd, again[1]),
              f"B6_f64 {tag}: two launches differ")
        metric, old_i, old_d = args[0], args[5], args[6]
        sqr = 2 if metric == "euclidean" else 1
        formula = cand_exact_plain(metric, base, sq, rows, gi)
        in_old = gi[:, :, None] == old_i[:, None, :]
        old = torch.where(in_old, old_d[:, None, :], math.inf).amin(dim=2)
        ref = torch.minimum(formula, old) ** sqr
        err_t = (gd ** sqr - ref).abs()
        beyond = int((err_t > tol_of(gi, ref)).sum())
        err = float(err_t.max())
        off = ids_off_outside_ties(gi, gd ** sqr, wi, wd ** sqr,
                                   tol_of(wi, wd ** sqr))
        check(beyond == 0, f"B6_f64 {tag}: {beyond} distances beyond 1e-12 "
              "of |d| + |a|^2 + |b|^2")
        check(off == 0, f"B6_f64 {tag}: {off} ids differ outside ties")
        ids_k = gi.long()
        same_d = gd[:, 1:] == gd[:, :-1]
        check(bool(((gd[:, 1:] > gd[:, :-1])
                    | (same_d & (ids_k[:, 1:] > ids_k[:, :-1]))).all()),
              f"B6_f64 {tag}: rows not ordered by (d, id)")
    else:
        gi, wi = got[0].long(), torch.where(want[1], -1, want[0]).long()
        check(torch.equal(got[0], again[0]),
              f"B6_f64 {tag}: two launches differ")
        _, count = stage_candidates(kind, args, kwargs)
        kept = (gi >= 0).sum(dim=1)
        check(torch.equal(kept, torch.clamp(count, max=gi.shape[1]))
              and torch.equal(kept, (wi >= 0).sum(dim=1)),
              f"B6_f64 {tag}: rows keep the wrong number of candidates")
        pos = torch.arange(gi.shape[1], device=gi.device)
        check(bool(((gi >= 0) == (pos[None, :] < kept[:, None])).all()),
              f"B6_f64 {tag}: -1 before a kept candidate")
        sw = cand_sqdist_plain(base, sq, rows,
                               torch.where(wi >= 0, wi, rows[:, None]))
        sk = cand_sqdist_plain(base, sq, rows,
                               torch.where(gi >= 0, gi, rows[:, None]))
        last = torch.clamp(kept - 1, min=0)[:, None]
        cut = torch.gather(sw, 1, last)
        err = float((torch.gather(sk, 1, last) - cut).abs().max())
        off = 0
        for ids, other, s_ in ((gi, wi, sk), (wi, gi, sw)):
            alone = (ids >= 0) & ~(ids[:, :, None] == other[:, None, :]
                                   ).any(dim=2)
            far = (s_ - cut).abs() > tol_of(ids, cut.expand_as(s_))
            off += int((alone & far).sum())
        check(off == 0, f"B6_f64 {tag}: {off} kept ids differ outside ties "
              "at the cut")
        ids_k = gi
    check_row_ids(f"B6_f64 {tag}", ids_k, rows)
    return err, off


def edge_chunks(kind, args, kwargs):
    """Two synthetic variants of a first stage's inputs: every gateway of
    every row one id (the first row's first gateway), and the first row's
    gateways all the row itself (its candidates: its own list's first ke
    ids, fewer than a keep stage keeps)."""
    import torch
    cand = args[3] if kind == "keep" else args[4]
    row0 = args[2] if kind == "keep" else args[3]
    one = torch.full_like(cand, int(cand[0, 0]))
    short = cand.clone()
    short[0] = row0
    pos = 3 if kind == "keep" else 4
    return {f"every gateway one id": args[:pos] + (one,) + args[pos + 1:],
            f"row {row0}: gateways all itself": args[:pos] + (short,)
            + args[pos + 1:]}


#: consecutive refine chunks over which phase_b6 times each funnel stage
B6_TIMED_CHUNKS = 32


def phase_b6(x_np, xc_np):
    """B6 against its plain version on the stages of a real refine chunk:
    the blobs' cascade (F = 128, first stage) and exact stage (F = 784),
    and the cells' exact stage (F = 50, first stage); two synthetic edge
    chunks at each first stage.  Each stage is timed over the round's
    first B6_TIMED_CHUNKS chunks, kernel and plain.  Returns its max error
    and, per stage, its (ms, plain ms, library ms), bound and chunk rows."""
    import torch
    err, shapes = 0.0, {}
    for tag, data, k in (("blobs", x_np, K), ("cells", xc_np, K_CELLS)):
        x = torch.from_numpy(data).cuda()
        chunks = capture_refine_chunks(x, k, B6_TIMED_CHUNKS)
        for s_idx, (kind, args, kwargs) in enumerate(chunks[0]):
            rows, base, _ = stage_rows(kind, args)
            c, f = rows.shape[0], base.shape[1]
            first = kwargs.get("graph") is not None
            name = (f"{tag} {'cascade' if kind == 'keep' else 'exact'} "
                    f"stage F={f}")
            e, sets = hold_stage(name, kind, args, kwargs)
            err = max(err, e)
            if first:
                for edge, eargs in edge_chunks(kind, args, kwargs).items():
                    ee, _ = hold_stage(f"{name}, {edge}", kind, eargs,
                                       kwargs)
                    err = max(err, ee)
                    print(f"[kernels] B6 {name}, edge chunk '{edge}': held, "
                          f"max err {ee:.3e}")
            stages = [chunk[s_idx] for chunk in chunks]
            times = (chunks_ms(stages), chunks_ms(stages, plain=True), None)
            per = [stage_bound(*st, stage_call(*st)) for st in stages]
            bnd = (statistics.mean(b[0][0] for b in per), per[0][0][1])
            u = statistics.mean(b[1] for b in per)
            count = torch.cat([b[2] for b in per])
            shapes[(tag, kind, f)] = (times, bnd, c)
            width = (args[3] if kind == "keep" else args[4]).shape[1]
            zdesc = (f"{width} gateways -> up to {int(count.max())} unique "
                     f"candidates a row, mean {float(count.float().mean()):.1f}"
                     if first else f"a list of {width}")
            print(f"[kernels] B6 {name} c={c} ({zdesc}; {u:.0f} distinct "
                  f"rows a chunk): max err {e:.3e}, sets {sets:.6f}; "
                  f"{times[0]:.4f} ms a chunk over {len(stages)} chunks in "
                  f"sequence (plain chunk body on the card {times[1]:.4f} "
                  f"ms, bound {bnd[0]:.4f} ms by {bnd[1]}); two launches "
                  f"bit-identical")
        del x, chunks
    return err, shapes


def phase_b6_f64(x_np, xc_np):
    """[f64] B6_f64 against its plain version (:func:`hold_stage_f64`) on
    the stages of real refine chunks captured at float64: the blobs'
    cascade (F = 128, first stage) and exact stage (F = 784), the cells'
    exact stage (F = 50, first stage); the two edge chunks at each first
    stage; the blobs' first stage with n_valid = N − 64 (no kept id at or
    past it); one chunk at K_B6_DEEP on the [widths] cuts of both.  Each
    full-size stage is timed over the round's first B6_TIMED_CHUNKS chunks
    in sequence, kernel and plain, beside its bound.  Returns its max
    error and, per stage, its (ms, plain ms, library ms), bound and chunk
    rows."""
    import torch
    t_phase = time.perf_counter()
    err, shapes = 0.0, {}
    for tag, data, k in (("blobs", x_np, K), ("cells", xc_np, K_CELLS)):
        x = torch.from_numpy(data.astype(np.float64)).cuda()
        n = x.shape[0]
        chunks = capture_refine_chunks(x, k, B6_TIMED_CHUNKS)
        for s_idx, (kind, args, kwargs) in enumerate(chunks[0]):
            rows, base, _ = stage_rows(kind, args)
            c, f = rows.shape[0], base.shape[1]
            first = kwargs.get("graph") is not None
            name = (f"{tag} {'cascade' if kind == 'keep' else 'exact'} "
                    f"stage F={f}")
            e, _ = hold_stage_f64(name, kind, args, kwargs)
            err = max(err, e)
            if first:
                for edge, eargs in edge_chunks(kind, args, kwargs).items():
                    ee, _ = hold_stage_f64(f"{name}, {edge}", kind, eargs,
                                           kwargs)
                    err = max(err, ee)
                    print(f"[f64] B6_f64 {name}, edge chunk '{edge}': held, "
                          f"max err {ee:.3e}")
                nv = dict(kwargs, n_valid=n - 64)
                ev, _ = hold_stage_f64(f"{name}, n_valid {n - 64}", kind,
                                       args, nv)
                got = stage_call(kind, args, nv)
                new = got[0] if isinstance(got, tuple) else got
                if kind == "final":  # old entries past n_valid may stay
                    new = torch.where((new[:, :, None] == args[5][:, None, :])
                                      .any(dim=2), -1, new)
                check(not bool((new >= n - 64).any()),
                      f"B6_f64 {name}: a new id at or past n_valid")
                err = max(err, ev)
                print(f"[f64] B6_f64 {name} with n_valid {n - 64} of {n}: "
                      f"held, max err {ev:.3e}, no new id past it")
            stages = [chunk[s_idx] for chunk in chunks]
            times = (chunks_ms(stages), chunks_ms(stages, plain=True), None)
            per = [stage_bound(*st, stage_call(*st)) for st in stages]
            bnd = (statistics.mean(b[0][0] for b in per), per[0][0][1])
            u = statistics.mean(b[1] for b in per)
            shapes[(tag, kind, f)] = (times, bnd, c)
            print(f"[f64] B6_f64 {name} c={c} ({u:.0f} distinct rows a "
                  f"chunk): max err {e:.3e}, ids equal outside ties; "
                  f"{times[0]:.4f} ms a chunk over {len(stages)} chunks in "
                  f"sequence (plain chunk body on the card {times[1]:.4f} "
                  f"ms, bound {bnd[0]:.4f} ms by {bnd[1]}, library none); "
                  f"two launches bit-identical")
        del x, chunks
    for tag, data in (("blobs", x_np), ("cells", xc_np)):
        x = torch.from_numpy(data[:N_REFINE_DEEP].astype(np.float64)).cuda()
        (chunk,) = capture_refine_chunks(x, K_B6_DEEP, 1)
        for kind, args, kwargs in chunk:
            rows, base, _ = stage_rows(kind, args)
            name = (f"{tag} k={K_B6_DEEP} "
                    f"{'keep' if kind == 'keep' else 'exact'} stage "
                    f"F={base.shape[1]}")
            e, _ = hold_stage_f64(name, kind, args, kwargs)
            err = max(err, e)
            print(f"[f64] B6_f64 {name} c={rows.shape[0]}: max err {e:.3e}, "
                  f"ids equal outside ties; two launches bit-identical")
        del x, chunk
    print(f"[f64] B6_f64 holds {time.perf_counter() - t_phase:.1f} s")
    return err, shapes


def phase_widths(x_np, xc_np):
    """The kernels at the limits they were widened to, against their plain
    versions on the card: B2-B5 at m = 1, 4 and 8 (B5/B4 over a row block
    and a ragged part with a hub row, an empty row and padding; B3's gains
    exactly equal on tie-free inputs), B1 at k = 300 and K_DEEP on a cut
    of the blobs, B6 at K_B6_DEEP on refine chunks captured from cuts of
    the blobs and the cells (and at K_DEEP on the cells); then
    ``tsne_embed`` at n_components 1, 4, 8 and at k = K_DEEP on the
    bruteforce and project paths, and 12,289 features on a refining
    project plan (once refused) through B6u.  Returns each kernel's max
    error."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

    errs = {kid: 0.0 for kid in KERNEL_META}
    rng = np.random.default_rng(8)
    for m in (1, 4, 8):
        y = torch.from_numpy((10.0 * rng.standard_normal(
            (N_WIDTHS, m))).astype(np.float32)).cuda()
        rk, zk = cuda_exact_repulsion(y, row_z=True)
        rp, zp = exact_repulsion(y, row_z=True)
        e2 = max(rel_close(rk, rp, 2e-5, f"B2 m={m} rep"),
                 rel_close(zk, zp, 2e-5, f"B2 m={m} row Z"))
        again = cuda_exact_repulsion(y, row_z=True)
        check(torch.equal(again[0], rk) and torch.equal(again[1], zk),
              f"B2 m={m}: two launches differ")
        jidx, jval, rag = edge_problem(y, 64, m)
        e5, e4 = hold_pass(f"m={m}", y, jidx, jval, rag, torch.sum(zp))
        # B3 over head + tail on tie-free inputs: every grad sits at
        # ±(|att| + a margin)
        forces = att.attraction_forces(y, y, jidx, jval, 4.0, ragged=rag)
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], y.shape).astype(
            np.float32)).cuda()
        margin = torch.abs(forces) + 1e-3 * torch.max(torch.abs(forces))
        rep = (forces - sign * margin).contiguous()
        upd = (1e-2 * torch.randn(y.shape, device="cuda")).contiguous()
        gains = (1.0 + torch.rand(y.shape, device="cuda")).contiguous()
        args = (y, y, jidx, jval, 4.0, rep, torch.ones((), device="cuda"),
                None, upd, gains, 0.8)
        kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
        out_k = att.fused_step_update(*args, **kw)
        out_p = att.fused_step_plain(*args, **kw)
        check(torch.equal(out_k[2], out_p[2]), f"B3 m={m}: gains differ")
        e3 = max(rel_close(out_k[0], out_p[0], 1e-4, f"B3 m={m} y"),
                 rel_close(out_k[1], out_p[1], 1e-4, f"B3 m={m} update"))
        for kid, e in (("B2", e2), ("B3", e3), ("B4", e4), ("B5", e5)):
            errs[kid] = max(errs[kid], e)
        print(f"[widths] m={m} on {N_WIDTHS} rows: B2 max err {e2:.3e}, B3 "
              f"gains equal and max |y/upd err| {e3:.3e}, B5/B4 as above")
    for k in (300, K_DEEP):
        errs["B1"] = max(errs["B1"], b1_deep_gates(f"blobs k={k}",
                                                   x_np[:N_B1_CHECK], k))
    for tag, data, k in (("blobs", x_np, K_B6_DEEP),
                         ("cells", xc_np, K_B6_DEEP),
                         ("cells", xc_np, K_DEEP)):
        x = torch.from_numpy(data[:N_REFINE_DEEP]).cuda()
        (chunk,) = capture_refine_chunks(x, k, 1)
        for kind, args, kwargs in chunk:
            rows, base, _ = stage_rows(kind, args)
            name = (f"{tag} k={k} {'keep' if kind == 'keep' else 'exact'} "
                    f"stage F={base.shape[1]}")
            e, sets = hold_stage(name, kind, args, kwargs)
            errs["B6"] = max(errs["B6"], e)
            print(f"[widths] B6 {name} c={rows.shape[0]}: max err {e:.3e}, "
                  f"sets {sets:.6f}; two launches bit-identical")
        del x, chunk
    # tsne_embed at the new widths and k, on the card
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITER_WIDTHS)
    for m in (1, 4, 8):
        reset_launches()
        y, losses = tsne_embed(x_np[:N_WIDTHS], TsneConfig(
            n_components=m, perplexity=PERPLEXITY, iterations=ITER_WIDTHS),
            neighbors=K, seed=0)
        counts = launches()
        check(tuple(y.shape) == (N_WIDTHS, m)
              and bool(torch.isfinite(y).all())
              and bool(torch.isfinite(losses).all()),
              f"[widths] tsne_embed n_components={m}: bad output")
        # each iteration one step: B3 (a fused CSR run) or B5, not both
        check(counts["B2"] == ITER_WIDTHS
              and sorted((counts["B3"], counts["B5"])) == [0, ITER_WIDTHS],
              f"[widths] tsne_embed n_components={m} launches {counts}")
        print(f"[widths] tsne_embed n_components={m}: {N_WIDTHS} x {m}, "
              f"finite; final KL {float(losses[-1]):.5f}; launches "
              f"{json.dumps(counts)}")
    for method in ("bruteforce", "project"):
        reset_launches()
        t0 = time.perf_counter()
        # two refine cycles: the auto plan's at this N
        y, losses = tsne_embed(x_np[:N_EMBED_DEEP], dataclasses.replace(
            cfg, perplexity=K_DEEP / 3.0), neighbors=K_DEEP, seed=0,
            knn_method=method, knn_refine=2 if method == "project" else None)
        torch.cuda.synchronize()
        counts = launches()
        want = "B1" if method == "bruteforce" else "B6"
        check(bool(torch.isfinite(y).all())
              and bool(torch.isfinite(losses).all()) and counts[want] > 0,
              f"[widths] tsne_embed k={K_DEEP} {method}: {counts}")
        print(f"[widths] tsne_embed {N_EMBED_DEEP} x {x_np.shape[1]} k="
              f"{K_DEEP} {method}: {time.perf_counter() - t0:.2f} s, finite; "
              f"final KL {float(losses[-1]):.5f}; launches "
              f"{json.dumps(counts)}")
    # 12,289 features on a refining project plan, once refused, run: the
    # cascade in B6, the exact stage in B6u (k past 1,024 runs in [bigk],
    # n_components past 8 in [wide], 32,738 features at size in
    # [features])
    from tsne_flink_tpu_torch.ops.knn_cuda import STAGED_F_MAX
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    d = STAGED_F_MAX + 1
    r, c, v, _ = make_counts(N_WIDTHS, d)
    wide_x = counts_dense(r, c, v, N_WIDTHS, d)
    del r, c, v
    reset_launches()
    t0 = time.perf_counter()
    y, losses = tsne_embed(wide_x, cfg, knn_method="project", knn_refine=1)
    torch.cuda.synchronize()
    counts = launches()
    chunks = math.ceil(N_WIDTHS / pick_knn_tiles(N_WIDTHS, d, K,
                                                 "cuda").refine_chunk)
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(losses).all())
          and counts["B6u"] == counts["B6"] == chunks
          and counts["B1"] == counts["B6_f64"] == counts["B6u_f64"] == 0,
          f"[widths] tsne_embed at {d} features, project: {counts}")
    print(f"[widths] tsne_embed {N_WIDTHS} x {d} project (one refine "
          f"cycle): {time.perf_counter() - t0:.2f} s, finite; final KL "
          f"{float(losses[-1]):.5f}; B6 x{counts['B6']} (cascade), B6u "
          f"x{counts['B6u']} (exact stage)")
    del wide_x, y
    return errs


def fft_split(y, cfg):
    """CUDA-event ms of one FFT repulsion call on ``y`` and its parts:
    (spread = stencil + sorted segment sum, the FFTs with the spectral Z,
    the gather, the whole call)."""
    import torch
    from tsne_flink_tpu_torch.ops import repulsion_fft as rf
    geom = rf.fft_geometry(y.shape[1], cfg.fft_grid, y.dtype, y.device)
    g, p = geom.grid, cfg.fft_interp
    ones = torch.ones(y.shape[0], device=y.device)
    rows = torch.arange(y.shape[0], device=y.device)
    st = rf.fft_stencil(y, g, p)
    grid = rf.fft_spread(y, st, g, ones)
    pot, _ = rf.fft_convolve(grid, geom, st.h)
    return (cuda_ms(lambda: rf.fft_spread(y, rf.fft_stencil(y, g, p), g,
                                          ones), 10),
            cuda_ms(lambda: rf.fft_convolve(grid, geom, st.h), 10),
            cuda_ms(lambda: rf.fft_gather(y, pot, st, g, rows, ones), 10),
            cuda_ms(lambda: rf.fft_repulsion(y, geom=geom,
                                             interp=p), 10))


def phase_project(x_np, labels, b1_ms, b6_shapes, ckpt_path):
    """The blobs with the hybrid kNN: exact launch counts, substages,
    recall@90 against B1's exact graph, the checks of phase 4; the run is
    written to ``ckpt_path`` as a fat checkpoint for [serve].  Returns
    its final embedding, launches, peak memory and final KL."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine

    n, d = x_np.shape
    cycles = pick_knn_refine(n, d)
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact")
    with record_knn() as graph, record_prepare() as prep:
        y, losses, stats, counts = run_embed(
            "project", x_np, cfg,
            lambda st: layout_launches(st["layout"], b1=0,
                                       b6=b6_launches(n, d, K, cycles)),
            knn_method="project")
    quality("project", y, losses, labels, cfg, 0.9)
    write_fat_checkpoint(ckpt_path, y, losses, prep[0])
    del prep[:]
    _, dist_e, t_b1 = timed_exact_graph(torch.from_numpy(x_np).cuda(), K)
    recall = recall_at_k(graph[1], dist_e)
    print(f"[project] recall@{K} against B1's exact graph {recall:.4f} "
          f"(bar 0.93)")
    check(recall >= 0.93, f"[project] recall {recall} < 0.93")
    per = {key: v for key, v in b6_shapes.items() if key[0] == "blobs"}
    b6_ms = " + ".join(f"{v[0][0]:.4f} ms ({key[1]} stage, F={key[2]})"
                       for key, v in per.items())
    print(f"[project] {cycles} refine cycles; B6 x{counts['B6']} launches "
          f"({b6_ms} a chunk); knn stage {stats['knn']:.3f} s vs B1's "
          f"exact sweep {t_b1:.3f} s here ({b1_ms / 1e3:.3f} s in [full])")
    refine_split("project", stats, counts["B6"] // len(per),
                 sum(v[0][0] for v in per.values()))
    return y, counts, stats["peak_bytes"], float(losses[-1])


def _digits(a, width):
    """[n, width] ASCII digits of the non-negative int64 ``a`` and the mask
    of those that print (no leading zeros; a lone 0 prints)."""
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = (a[:, None] // powers) % 10 + ord("0")
    return digits.astype(np.uint8), (a[:, None] >= powers) | (powers == 1)


#: "00".."99" as [100, 2] ASCII
_PAIRS = np.array([[ord(a), ord(b)] for a in "0123456789"
                   for b in "0123456789"], np.uint8)


def coo_text(x, r0=0):
    """The non-zero entries of ``x`` (values in [0, 1e15)) as
    ``point,feature,value`` lines (:func:`coo_lines`), points numbered from
    ``r0``."""
    rows, cols = np.nonzero(x)
    return coo_lines(rows + r0, cols, x[rows, cols], r0, r0 + x.shape[0],
                     x.shape[1])


def coo_lines(rows, cols, vals, row_lo, row_hi, n_cols):
    """``point,feature,value`` lines of the entries (rows in [row_lo,
    row_hi), columns below ``n_cols``, values in [0, 1e15)), built in a
    uint8 buffer with numpy: the value is a 15-digit integer mantissa and
    a negative power of ten, which reads back (correctly rounded to
    float64, then cast) as the same float32."""
    v = np.asarray(vals).astype(np.float64)
    check(bool((v >= 0).all() and (v < 1e15).all()),
          "[cli] coo_text takes values in [0, 1e15)")
    e = 14 - np.floor(np.log10(v)).astype(np.int64)  # 15 digits before e-
    mant = np.rint(v * 10.0 ** e).astype(np.int64)   # 1e14 <= mant <= 1e15
    digits = np.empty((len(v), 16), np.uint8)
    rest = mant
    for j in range(7, -1, -1):  # two digits a step, from the right
        rest, pair = np.divmod(rest, 100)
        digits[:, 2 * j:2 * j + 2] = _PAIRS[pair]
    lead = np.ones((len(v), 16), bool)
    lead[:, 0] = mant >= 10 ** 15

    def lit(text):
        chars = np.frombuffer(text.encode(), np.uint8)
        return (np.broadcast_to(chars, (len(v), len(chars))),
                np.ones((len(v), len(chars)), bool))

    def table(a, lo, hi, width):  # the digits of a in [lo, hi) by lookup
        d, m = _digits(np.arange(lo, hi, dtype=np.int64), width)
        return d[a - lo], m[a - lo]

    pieces = (table(rows, row_lo, row_hi, 7), lit(","),
              table(cols, 0, n_cols, 5), lit(","), (digits, lead),
              lit("e-"), table(e, 0, 1000, 3), lit("\n"))
    chars = np.concatenate([c for c, _ in pieces], 1)
    return chars[np.concatenate([m for _, m in pieces], 1)].tobytes()


def write_coo(path, x, rows_per_block=1000):
    """``x``'s non-zero entries as a COO CSV, blocks of rows built on a
    few threads (numpy releases the GIL) and written in order."""
    from concurrent.futures import ThreadPoolExecutor
    starts = range(0, x.shape[0], rows_per_block)
    with open(path, "wb") as f, ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        for text in pool.map(
                lambda r0: coo_text(x[r0:r0 + rows_per_block], r0), starts):
            f.write(text)


#: id(x) -> (the COO CSV of x, the seconds its write took)
_COO = {}


def shared_coo(x_np):
    """``x_np`` as a COO CSV, written once a process (1.3 GB at 60,000 x
    784 blobs), into a directory of its own removed at exit: the phases
    that run the command line ([cli], [bigk], [spmd], [runtime]) read one
    file."""
    import atexit
    import shutil
    import tempfile
    if id(x_np) not in _COO:
        d = tempfile.mkdtemp(prefix="tsne_coo_")
        atexit.register(shutil.rmtree, d, True)
        path = os.path.join(d, "mnist60k.csv")
        t0 = time.perf_counter()
        write_coo(path, x_np)
        _COO[id(x_np)] = (path, time.perf_counter() - t0)
    return _COO[id(x_np)][0]


def run_cli(tag, argv, mesh_devices=None):
    """The port's CLI in this process (on the test mesh ``mesh_devices``
    when given), its launches counted from 0 just before it.  Returns
    (the embedding it wrote, launches, stage seconds from its '# stages
    s:' line, its stderr)."""
    import io as _io

    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.utils import native
    from tsne_flink_tpu_torch.utils.cli import main as cli_main
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    err = _io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv, mesh_devices=mesh_devices)
    wall = time.perf_counter() - t0
    counts = launches()
    check(rc == 0, f"[cli] {tag}: exit {rc}")
    text = err.getvalue()
    for line in text.splitlines():
        print(f"[cli] {tag}: {line}")
    stages = {}
    for line in text.splitlines():
        if line.startswith("# stages s: "):
            stages = {kv.split("=")[0]: float(kv.split("=")[1])
                      for kv in line[len("# stages s: "):].split()}
    m = (int(argv[argv.index("--nComponents") + 1])
         if "--nComponents" in argv else 2)
    out = native.load_coo(argv[argv.index("--output") + 1], cols=1 + m)
    check(np.array_equal(out[:, 0], np.arange(out.shape[0])),
          f"[cli] {tag}: the embedding's ids are not 0..N-1")
    y = out[:, 1:].astype(np.float32)
    peak = torch.cuda.max_memory_allocated()
    print(f"[cli] {tag}: {wall:.3f} s end to end, launches "
          f"{json.dumps(counts)}, peak memory {peak / 2**30:.3f} GiB, "
          f"y digest {hashlib.sha256(y.tobytes()).hexdigest()[:16]}")
    return y, counts, stages, text


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint32),
        np.ascontiguousarray(b).view(np.uint32))


def cli_f64_gate(argv, config2, kl_32, tmp):
    """[cli] gate 10: config 2's command line (``argv``, ``config2``) at
    ``--dtype float64``, with the exact kNN and with its own project kNN
    (3 seed rounds + 6 refine cycles through B6_f64): each runs on the
    float64 forms alone and ends within KL_GUARDRAIL_TOL of config 2's
    float32 run (``kl_32``); the project line launches B6_f64 as config
    2's float32 line launches B6.  Returns the project line's launches."""
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    x_n, x_d = N_FULL, F_FULL
    b6 = b6_launches(x_n, x_d, K, pick_knn_refine(x_n, x_d))
    lines = {"bruteforce": ("--knnMethod", "bruteforce", "--theta", "0.5",
                            "--noCache", "--dtype", "float64"),
             "project": (*config2, "--noCache", "--dtype", "float64")}
    out = None
    for method, line in lines.items():
        name = f"f64{method[0]}.csv"
        y_64, counts_64, _, _ = run_cli(f"config 2 float64 {method}",
                                        argv(name, *line))
        kl_64 = float(np.loadtxt(os.path.join(tmp, name + ".loss"),
                                 delimiter=",", ndmin=2)[-1, 1])
        print(f"[cli] gate 10: config 2 --dtype float64 --knnMethod "
              f"{method}: final KL {kl_64:.6f} against config 2's float32 "
              f"{kl_32:.6f} (|dKL| {abs(kl_64 - kl_32):.6f}); launches "
              f"{json.dumps(counts_64)}")
        want_b1, want_b6 = (1, 0) if method == "bruteforce" else (0, b6)
        check(counts_64["B1_f64"] == want_b1
              and counts_64["B6_f64"] == want_b6
              and counts_64["B2_f64"] == ITERATIONS
              and not any(v for kid, v in counts_64.items()
                          if not kid.endswith("_f64")),
              f"[cli] gate 10: float64 {method} launches {counts_64}")
        check(np.isfinite(y_64).all() and abs(kl_64 - kl_32)
              <= KL_GUARDRAIL_TOL, f"[cli] gate 10: float64 {method} KL "
              f"{kl_64} vs float32 {kl_32}")
        out = counts_64
    return out


def phase_cli(x_np, xl_np, full, rows, project, y_bh):
    """The batch job's front door at 60,000 x 784: config 2's command line
    through the port's ``main`` from a COO CSV (gate 1), a warm artifact
    cache (gate 2), a fat-checkpoint resume (gate 3), the estimator
    (gate 4); config 2 with ``--repulsion bh`` (gate 5), the sentinel and
    telemetry on the checkpointed run (gate 6), an autopilot run resumed
    from its checkpoint (gate 7).  ``full``, ``rows``, ``project``: (y,
    launches[, peak, KL]) of those phases; ``y_bh`` [bh]'s config 2 y."""
    import shutil
    import tempfile

    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    from tsne_flink_tpu_torch.utils import io as tio
    from tsne_flink_tpu_torch.utils import native
    from tsne_flink_tpu_torch.utils.cli import EXACT_N_MAX, pick_repulsion

    tmp = tempfile.mkdtemp(prefix="tsne_cli_")
    try:
        n, f = x_np.shape
        coo = shared_coo(x_np)
        size = os.path.getsize(coo)
        nnz = int(np.count_nonzero(x_np))
        print(f"[cli] wrote {nnz} point,feature,value lines ({size / 1e9:.3f}"
              f" GB) in {_COO[id(x_np)][1]:.2f} s (not part of a run; the "
              "command-line phases read this one file)")
        t0 = time.perf_counter()
        ids, x_back = tio.read_input(coo, f)
        t_read = time.perf_counter() - t0
        check(np.array_equal(ids, np.arange(n))
              and same_bits(x_back.astype(np.float32), x_np),
              "[cli] the COO file does not read back as x bit for bit")
        del x_back
        # the native parser against numpy's on the first 2,000 rows' lines
        head = os.path.join(tmp, "head.csv")
        with open(head, "wb") as fh:
            fh.write(coo_text(x_np[:2000]))
        lines = int(np.count_nonzero(x_np[:2000]))
        t0 = time.perf_counter()
        got = native.load_coo(head)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = np.loadtxt(head, delimiter=",", dtype=np.float64, ndmin=2)
        t_np = time.perf_counter() - t0
        check(np.array_equal(got, ref), "[cli] native parse != numpy's")
        print(f"[cli] read_input of the whole file {t_read:.3f} s; on "
              f"{lines} lines the native parser {t_nat:.4f} s "
              f"({lines / t_nat / 1e6:.2f} M lines/s), numpy.loadtxt "
              f"{t_np:.4f} s ({lines / t_np / 1e6:.3f} M lines/s): "
              f"{t_np / t_nat:.1f}x")
        rep = pick_repulsion("auto", 0.5, n, 2, theta_explicit=True)
        print(f"[cli] pick_repulsion('auto', theta 0.5 explicit, N={n}) -> "
              f"{rep} (EXACT_N_MAX['cuda'] = {EXACT_N_MAX['cuda']})")
        check(rep == "exact", f"[cli] auto resolved to {rep} at N={n}")

        def argv(out, *extra):
            return ["--input", coo, "--output", os.path.join(tmp, out),
                    "--loss", os.path.join(tmp, out + ".loss"),
                    "--dimension", str(f), "--perplexity", str(PERPLEXITY),
                    "--iterations", str(ITERATIONS), "--randomState", "0",
                    *extra]

        # gate 1: config 2's command line is the tsne_embed it wraps
        y_p, counts_p, peak_p, _ = project
        config2 = ("--knnMethod", "project", "--theta", "0.5")
        y, counts, st, _ = run_cli("config 2", argv("c2.csv", *config2,
                                                    "--noCache"))
        print("[cli] config 2 stages s: " + ", ".join(
            f"{k}={v:.4f}" for k, v in st.items())
            + f" (the [project] run's peak {peak_p / 2**30:.3f} GiB)")
        check(same_bits(y, y_p.cpu().numpy()),
              "[cli] gate 1: config 2's embedding != [project]'s")
        check(counts == counts_p, f"[cli] gate 1: launches {counts} != "
              f"[project]'s {counts_p}")

        # [analysis] (queue A16) on this command line and input
        phase_analysis(x_np, argv, config2, y, counts, tmp)

        # gate 8: the mesh flags (queue A14a) on the same command line
        mesh_cli_gates(x_np, argv, run_cli, config2)

        # gate 2: a warm artifact cache runs no kNN and gives the same bits
        cache = ("--cacheDir", os.path.join(tmp, "cache"))
        y_c, counts_c, st_c, _ = run_cli("cache cold", argv(
            "cold.csv", *config2, *cache))
        y_w, counts_w, st_w, err_w = run_cli("cache warm", argv(
            "warm.csv", *config2, *cache))
        print(f"[cli] prepare (knn + affinities) cold "
              f"{st_c['knn'] + st_c['affinities']:.4f} s, warm "
              f"{st_w['knn'] + st_w['affinities']:.4f} s")
        check("(warm)" in err_w and "(cold)" not in err_w,
              "[cli] gate 2: the rerun did not load both stages warm")
        check(counts_w["B6"] == 0 and counts_c == counts_p,
              f"[cli] gate 2: launches cold {counts_c}, warm {counts_w}")
        check(same_bits(y_c, y_p.cpu().numpy())
              and same_bits(y_w, y_p.cpu().numpy()),
              "[cli] gate 2: the cached runs' embeddings differ")

        # gate 9: config 2 under --dtype bfloat16 reads none of the warm
        # float32 cache, and ends within KL_GUARDRAIL_TOL of its f32 run
        y_16, counts_16, _, err_16 = run_cli("config 2 bfloat16", argv(
            "bf16.csv", *config2, *cache, "--dtype", "bfloat16"))
        kl_32 = float(np.loadtxt(os.path.join(tmp, "c2.csv.loss"),
                                 delimiter=",", ndmin=2)[-1, 1])
        kl_16 = float(np.loadtxt(os.path.join(tmp, "bf16.csv.loss"),
                                 delimiter=",", ndmin=2)[-1, 1])
        print(f"[cli] gate 9: config 2 --dtype bfloat16: final KL "
              f"{kl_16:.6f} against float32 {kl_32:.6f} (|dKL| "
              f"{abs(kl_16 - kl_32):.6f}); launches {json.dumps(counts_16)}; "
              f"the warm float32 cache not read")
        check("(warm)" not in err_16 and counts_16["B6"] > 0,
              "[cli] gate 9: the bf16 run read the float32 cache")
        check(np.isfinite(y_16).all() and abs(kl_16 - kl_32)
              <= KL_GUARDRAIL_TOL, f"[cli] gate 9: bf16 KL {kl_16} vs "
              f"float32 {kl_32}")
        shutil.rmtree(cache[1])

        # gate 10: --dtype float64 on config 2's command line
        cli_f64_gate(argv, config2, kl_32, tmp)

        # gate 3: a fat checkpoint resumes bit for bit, with no kNN
        y_f, counts_f = full
        ck = os.path.join(tmp, "c")
        brute = ("--knnMethod", "bruteforce", "--noCache")
        y_u, counts_u, st_u, _ = run_cli("checkpointed", argv(
            "u.csv", *brute, "--checkpoint", ck, "--checkpointEvery", "100",
            "--fatCheckpoint"))
        check(same_bits(y_u, y_f.cpu().numpy()) and counts_u == counts_f,
              "[cli] gate 3: the checkpointed run != [full]")
        _, nxt, _ = ckpt.load(ck + ".1")
        print(f"[cli] {ck}.1 holds iteration {nxt} (checkpoint files "
              f"{os.path.getsize(ck) / 1e9:.3f} GB; "
              f"{st_u.get('checkpoint', 0.0):.3f} s writing three)")
        check(nxt == 200, f"[cli] gate 3: c.1 holds iteration {nxt}")
        y_r, counts_r, st_r, _ = run_cli("resumed", argv(
            "r.csv", *brute, "--resume", ck + ".1"))
        print(f"[cli] the resume: checkpoint read and verified "
              f"{st_r['resume']:.4f} s, prepare (payload check + upload) "
              f"{st_r['knn'] + st_r['affinities']:.4f} s")
        check(counts_r["B1"] == 0 and counts_r["B6"] == 0
              and counts_r["B2"] == ITERATIONS - 200,
              f"[cli] gate 3: the resume launched {counts_r}")
        check(same_bits(y_r, y_u), "[cli] gate 3: resumed != uninterrupted")
        for path in (ck, ck + ".1"):
            os.remove(path)

        # gate 5: config 2 with Barnes-Hut is [bh]'s run
        y_b, counts_b, st_b, _ = run_cli("config 2 bh", argv(
            "bh.csv", *config2, "--repulsion", "bh", "--noCache"))
        check(same_bits(y_b, y_bh.cpu().numpy()) and counts_b["B2"] == 0,
              "[cli] gate 5: config 2 with --repulsion bh != [bh]'s run")

        # gate 6: the sentinel and telemetry keep the checkpointed run's
        # bits (the KL then runs every iteration: B4 x300)
        hc = os.path.join(tmp, "h")
        y_h, counts_h, _, err_h = run_cli("health + telemetry", argv(
            "h.csv", *brute, "--checkpoint", hc, "--checkpointEvery", "100",
            "--healthCheck", "--telemetry"))
        check(same_bits(y_h, y_f.cpu().numpy())
              and counts_h["B4"] == ITERATIONS,
              f"[cli] gate 6: --healthCheck --telemetry changed the run "
              f"(launches {counts_h})")
        check("all finite True" in err_h and "# sentinel event" not in err_h,
              "[cli] gate 6: telemetry rows not finite, or a rollback")
        for path in (hc, hc + ".1"):
            os.remove(path)

        # gate 7: a resumed autopilot run makes the uninterrupted run's
        # decisions: the same y and policy trace
        pc = os.path.join(tmp, "p")
        pilot = (*brute, "--autopilot", "--checkpointEvery", "100")
        y_a, counts_a, st_a, err_a = run_cli("autopilot", argv(
            "a.csv", *pilot, "--checkpoint", pc))
        pc2 = os.path.join(tmp, "p2")
        y_ar, counts_ar, _, _ = run_cli("autopilot resumed", argv(
            "ar.csv", *pilot, "--checkpoint", pc2, "--resume", pc + ".1"))
        pa, pb = ckpt.load_pilot(pc), ckpt.load_pilot(pc2)
        print(f"[cli] autopilot: B2 x{counts_a['B2']} of {ITERATIONS} "
              f"(optimize {st_a['optimize']:.4f} s against the "
              f"checkpointed run's {st_u['optimize']:.4f} s); the resume "
              f"from iteration 200: B2 x{counts_ar['B2']}")
        check(same_bits(y_ar, y_a) and pa is not None and pb is not None
              and np.array_equal(pa[0], pb[0])
              and np.array_equal(pa[1], pb[1]),
              "[cli] gate 7: the resumed autopilot run differs")
        for path in (pc, pc + ".1", pc2):
            os.remove(path)

        # gate 4: the estimator is the [rows] run
        y_rows, counts_rows = rows
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        est = TSNE(random_state=0).fit(xl_np)
        torch.cuda.synchronize()
        counts_e = launches()
        print(f"[cli] TSNE(random_state=0).fit on the latent blobs: "
              f"{time.perf_counter() - t0:.3f} s, launches "
              f"{json.dumps(counts_e)}, final KL {est.kl_divergence_:.6f}")
        check(same_bits(est.embedding_, y_rows.cpu().numpy())
              and counts_e == counts_rows,
              "[cli] gate 4: TSNE().fit != [rows]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


def _cli_captured(argv, cwd=None):
    """``utils/cli.main(argv)`` with its stdout and stderr captured and
    echoed, its launches counted from 0 just before it: (exit code or the
    SystemExit message, stdout, launches, seconds, allocated peak less
    what was allocated before)."""
    import io as _io

    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.utils.cli import main as cli_main
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, err = _io.StringIO(), _io.StringIO()
    here = os.getcwd()
    reset_launches()
    t0 = time.perf_counter()
    try:
        if cwd is not None:
            os.chdir(cwd)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(argv)
    except SystemExit as e:
        rc = str(e)
    finally:
        os.chdir(here)
    secs = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated() - before
    for line in (out.getvalue() + err.getvalue()).splitlines():
        print(f"[analysis]   {line}")
    return rc, out.getvalue(), counts, secs, peak


def phase_analysis(x_np, argv, config2, y_c2, counts_c2, tmp):
    """[analysis] (queue A16): the analysis tier on the card.
    1. ``--auditPlan`` on config 2's command line at the kNN graph's row
       width bound (``--symWidth``): its report, the predicted peak within
       [1, 2]x of the measured one, the bits and launches of the run
       without the flag (``y_c2``, ``counts_c2``), the gate's seconds;
       then on the command line as users give it (no ``--symWidth``: the
       pre-read gate takes rows of 2k, printed, not gated; the re-check
       after the kNN stage charges the graph's width bound, its predicted
       / measured peak within [1, 2]), its bits and launches held as
       well;
    2. a plan the model puts above the card (1M x 2 points, ``--neighbors
       1024 --affinityAssembly sorted``): refused with the JAX message,
       no kernel launched;
    3. ``--executionPlan`` at 60k: the JSON, no CSV, its ops B2 and B3 on
       the iteration, then B4 on the KL pass;
    4. ``python -m tsne_flink_tpu_torch.analysis --audit``'s entry point
       on the card, in this process: clean, its seconds."""
    import re

    import torch
    from tsne_flink_tpu_torch.analysis.audit.record import kernel_steps
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    t_phase = time.perf_counter()
    # 1: the gate at the width the run's graph bounds
    prep = prepare(torch.as_tensor(x_np, device="cuda"), neighbors=K,
                   knn_method="project", seed=0, perplexity=PERPLEXITY,
                   device="cuda")
    w = width_bound(prep.idx)
    del prep
    torch.cuda.empty_cache()
    rc, out, counts, secs, peak = _cli_captured(argv(
        "audit.csv", *config2, "--noCache", "--auditPlan", "--symWidth",
        str(w)))
    check(rc == 0, f"[analysis] the audited run: {rc}")
    got = re.search(r"# auditPlan: peak HBM est ([0-9.]+) GiB in '(\w+)' "
                    r"vs ([0-9.]+) GiB budget", out)
    gate = re.search(r"# auditPlan: gate ([0-9.]+) s", out)
    check(got is not None and gate is not None,
          "[analysis] the gate's report lines are missing")
    for key in ("# auditPlan:   knn:", "# auditPlan:   affinities:",
                "# auditPlan:   optimize:", "# auditPlan: determinism: 0 "
                "unblessed", "# auditPlan: comms: mode canonical"):
        check(key in out, f"[analysis] the gate printed no '{key}'")
    pred = float(got.group(1)) * 2**30
    ratio = pred / peak
    y_a = native_embedding(argv("audit.csv")[3])
    print(f"[analysis] 1. --auditPlan at width bound {w}: gate "
          f"{float(gate.group(1)):.3f} s, predicted {pred / 2**30:.3f} GiB "
          f"in '{got.group(2)}' vs measured {peak / 2**30:.3f} GiB "
          f"allocated (x{ratio:.3f}); run {secs:.3f} s, launches "
          f"{json.dumps(counts)}")
    check(1.0 <= ratio <= 2.0,
          f"[analysis] predicted / measured peak {ratio:.3f} outside [1, 2]")
    check(same_bits(y_a, y_c2) and counts == counts_c2,
          "[analysis] --auditPlan changed the run's bits or launches")
    # 1b: the same command line as given: the model's default row width
    rc, out, counts, secs, peak = _cli_captured(argv(
        "audit_given.csv", *config2, "--noCache", "--auditPlan"))
    check(rc == 0, f"[analysis] the audited run as given: {rc}")
    got = re.search(r"# auditPlan: peak HBM est ([0-9.]+) GiB in '(\w+)' "
                    r"vs ([0-9.]+) GiB budget", out)
    gate = re.search(r"# auditPlan: gate ([0-9.]+) s", out)
    check(got is not None and gate is not None,
          "[analysis] the gate's report lines are missing (as given)")
    pred = float(got.group(1)) * 2**30
    again = re.search(r"# auditPlan: after kNN: width bound (\d+): peak "
                      r"HBM est ([0-9.]+) GiB in '(\w+)'", out)
    check(again is not None, "[analysis] 1b: no re-check after the kNN "
          "stage without --symWidth")
    pred2 = float(again.group(2)) * 2**30
    y_a = native_embedding(argv("audit_given.csv")[3])
    print(f"[analysis] 1b. --auditPlan as given (rows of 2k): gate "
          f"{float(gate.group(1)):.3f} s, predicted {pred / 2**30:.3f} GiB "
          f"in '{got.group(2)}' vs measured {peak / 2**30:.3f} GiB "
          f"allocated (x{pred / peak:.3f}, not gated); re-checked after "
          f"the kNN stage at width bound {again.group(1)}: "
          f"{pred2 / 2**30:.3f} GiB in '{again.group(3)}' "
          f"(x{pred2 / peak:.3f}); run {secs:.3f} s")
    check(int(again.group(1)) == w and 1.0 <= pred2 / peak <= 2.0,
          f"[analysis] 1b: the re-check at width {again.group(1)} (bound "
          f"{w}) reads x{pred2 / peak:.3f}, outside [1, 2]")
    check(same_bits(y_a, y_c2) and counts == counts_c2,
          "[analysis] --auditPlan as given changed the run's bits or "
          "launches")

    # 2: a predicted OOM, refused before any launch
    rng = np.random.default_rng(5)
    big = os.path.join(tmp, "big.csv")
    write_coo(big, (rng.random((1_000_000, 2)) * 100.0).astype(np.float32))
    rc, out, counts, secs, _ = _cli_captured([
        "--input", big, "--output", os.path.join(tmp, "big_out.csv"),
        "--dimension", "2", "--knnMethod", "bruteforce", "--neighbors",
        "1024", "--affinityAssembly", "sorted", "--noCache", "--auditPlan"])
    print(f"[analysis] 2. 1M x 2, k = 1024, sorted: refused in {secs:.3f} "
          f"s, launches {json.dumps(counts)}")
    check(isinstance(rc, str) and rc.startswith("plan predicted to OOM")
          and "--auditPlan=warn" in rc,
          f"[analysis] the predicted OOM was not refused: {rc}")
    check(not any(counts.values()), "[analysis] the refused plan launched")
    check(not os.path.exists(os.path.join(tmp, "big_out.csv")),
          "[analysis] the refused plan wrote its output")
    os.remove(big)

    # 3: the execution plan at 60k
    rc, out, counts, secs, _ = _cli_captured(
        argv("plan.csv", "--knnMethod", "bruteforce", "--noCache",
             "--executionPlan"), cwd=tmp)
    path = os.path.join(tmp, "tsne_executionPlan.json")
    check(rc == 0 and os.path.exists(path),
          f"[analysis] --executionPlan: {rc}")
    with open(path) as f:
        plan = json.load(f)
    steps = kernel_steps(plan["ops"])
    it = kernel_steps([r for r in plan["ops"] if r["section"] == "iteration"])
    kl = kernel_steps([r for r in plan["ops"] if r["section"] == "kl_pass"])
    print(f"[analysis] 3. --executionPlan: {os.path.getsize(path)} bytes, "
          f"{len(plan['ops'])} ops, program {plan['program']} on "
          f"{plan['backend']} x{plan['devices']}, kernel steps: iteration "
          f"{it}, KL pass {kl}; {secs:.3f} s")
    check(it == ["B2", "B3"] and kl[-1:] == ["B4"]
          and steps.index("B4") > steps.index("B3"),
          f"[analysis] the plan's kernel steps {steps}")
    check(plan["backend"] == "cuda" and not os.path.exists(
        os.path.join(tmp, "plan.csv")), "[analysis] --executionPlan wrote "
          "the output CSV, or names another backend")

    # 4: the audit tier on the card: ``python -m
    # tsne_flink_tpu_torch.analysis --audit``'s main, in this process (the
    # process start and PyTorch's lazy imports are paid already)
    import io as _io
    from tsne_flink_tpu_torch.analysis.__main__ import main as analysis_main
    out = _io.StringIO()
    here = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(ROOT)
        with contextlib.redirect_stdout(out):
            rc = analysis_main(["--audit"])
    finally:
        os.chdir(here)
    secs = time.perf_counter() - t0
    for line in out.getvalue().splitlines()[-12:]:
        print(f"[analysis]   {line}")
    print(f"[analysis] 4. --audit on the card: exit {rc}, {secs:.1f} s")
    check(rc == 0, "[analysis] --audit on the card: "
          + out.getvalue()[-2000:])
    print(f"[analysis] {time.perf_counter() - t_phase:.1f} s")


# ---- [bigk]: k past the deep class -------------------------------------------

#: the k each B1 form is held at past its deep class (its pending class),
#: the rows of the plain check, the rows a B6 stage is held on (the plain
#: merge holds [rows, k, k] masks), the cut B6's stages are captured from,
#: and the full-width runs' perplexity (k = 3·perplexity = 1,500)
K_BIG = (1025, 1500, 2048, 4096)
N_BIGK_ROWS, N_BIGK_HOLD, N_BIGK_CUT = 1024, 128, 20_000
PERPLEXITY_BIG = 500.0
K_BIG_RUN = 1500


def route_counts():
    from tsne_flink_tpu_torch.ops.knn_cuda import ROUTE_LAUNCHES
    return dict(ROUTE_LAUNCHES)


def route_delta(before):
    now = route_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


#: each B1 form's bar against its plain version run in float64 on the
#: form's operands: a distance within this fraction of |d| + ‖a‖² + ‖b‖²
#: (3xTF32 drops lo·lo, ~2^-22 of a product; bf16 operands' products are
#: exact in float64, their FP32 sums hold ~1e-7; float64 is B1_f64's bar)
B1_FORM_RTOL = {"B1": 1e-5, "B1_bf16": 1e-5, "B1_f64": F64_RTOL}


def b1_form_gates(form, x, k, rows):
    """One B1 form against its plain version on the sample ``rows``, the
    plain sweep run in float64 on the form's operands (bf16-rounded for
    B1_bf16): distances within B1_FORM_RTOL of the norm trick's terms,
    ids equal outside ties (a slot whose plain distance lies within that
    tolerance of a neighbouring slot's, the (k+1)-th included); two
    launches bit-identical.  Returns (max |d err|, the first launch's ms,
    the held rows' ordered ids and distances)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    mdt = torch.bfloat16 if form == "B1_bf16" else None
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    raw = knn_sweep_cuda(x, k, False, mdt)
    b.record()
    again = knn_sweep_cuda(x, k, False, mdt)
    torch.cuda.synchronize()
    ms = a.elapsed_time(b)
    check(torch.equal(raw[0], again[0]) and torch.equal(raw[1], again[1]),
          f"[bigk] {form} k={k}: two launches differ")
    del again
    ik, dk = _fused_final(*raw, "sqeuclidean")
    del raw
    ik, dk = ik[rows], dk[rows]
    x64 = x.double()
    dp, ip = knn_sweep_plain(x64, k + 1, False, row_chunk=256,
                             matmul_dtype=mdt, rows=rows)
    r = torch.sum(x64 * x64, 1)
    tol = B1_FORM_RTOL[form] * (dp.abs() + r[rows][:, None]
                                + r[ip.long()])
    diff = (dk.double() - dp[:, :k]).abs()
    beyond = int((diff > tol[:, :k]).sum())
    gap = dp[:, 1:] - dp[:, :-1]
    tied = gap[:, :k] <= tol[:, :k]
    tied[:, 1:] |= gap[:, :k - 1] <= tol[:, 1:k]
    same = ik.long() == ip[:, :k].long()
    off = int((~same & ~tied).sum())
    print(f"[bigk] {form} {x.shape[0]}x{x.shape[1]} k={k} ({rows.numel()} "
          f"rows held): max |d err| vs the plain version (float64) "
          f"{float(diff.max()):.3e}, {beyond} beyond "
          f"{B1_FORM_RTOL[form]:.0e} of the norm trick's terms; ids equal "
          f"{float(same.float().mean()):.6f}, ids off outside ties {off}; "
          f"the launch {ms:.3f} ms; two launches bit-identical")
    check(beyond == 0, f"[bigk] {form} k={k}: {beyond} distances off")
    check(off == 0, f"[bigk] {form} k={k}: {off} ids differ outside ties")
    return float(diff.max()), ms, ik, dk


def b1_forms_past_1024(x):
    """Each B1 form at every k of K_BIG on the blobs: against its plain
    version on N_BIGK_ROWS sampled rows at the form's bar (0 ids off
    outside ties, two launches bit for bit); the first 1,024 slots of the
    held rows bit for bit the deep class's k = 1,024 list (one selection
    over the same distances); each launch counted under the pending
    class, the k = 1,024 one under the deep class (the float64 form's
    k-list class).  Returns {form: (max err, {k: launch ms})}."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(19)
    rows = torch.randperm(x.shape[0], generator=gen)[:N_BIGK_ROWS].cuda()
    out = {}
    for form in ("B1", "B1_bf16", "B1_f64"):
        xf = x.double() if form == "B1_f64" else x
        mdt = torch.bfloat16 if form == "B1_bf16" else None
        before = route_counts()
        di, dd = _fused_final(*knn_sweep_cuda(xf, 1024, False, mdt),
                              "sqeuclidean")
        di, dd = di[rows], dd[rows]
        deep = route_delta(before)
        check(deep == {"B1 deep": 1}, f"[bigk] {form} k=1024: class {deep}")
        errs, times = 0.0, {}
        for k in K_BIG:
            before = route_counts()
            err, ms, ik, dk = b1_form_gates(form, xf, k, rows)
            cls = route_delta(before)
            check(cls == {"B1 pending": 2}, f"[bigk] {form} k={k}: the "
                  f"launches took {cls}, not the pending class")
            prefix = (torch.equal(ik[:, :1024], di)
                      and torch.equal(dk[:, :1024], dd))
            print(f"[bigk] {form} k={k}: both launches in the pending "
                  f"class; the held rows' first 1,024 slots = the deep "
                  f"class's k=1024 list: {prefix}")
            check(prefix, f"[bigk] {form} k={k}: the first 1,024 slots "
                  "differ from the deep class's list")
            errs, times[k] = max(errs, err), ms
            del ik, dk
            torch.cuda.empty_cache()
        out[form] = (errs, times)
        del xf
    return out


def cut_stage(kind, args, kwargs, m):
    """A captured stage on its chunk's first ``m`` rows."""
    if kind == "keep":
        return kind, (*args[:3], args[3][:m], *args[4:]), kwargs
    return kind, (*args[:4], args[4][:m], args[5][:m], args[6][:m]), kwargs


def stage_f64(kind, args, kwargs):
    """A captured float32 stage's inputs at float64: the scored operand in
    float64, its squared norms summed in float64, and (the exact stage)
    the old lists' distances recomputed at float64 by the plain formula,
    as a float64 run's earlier stages would have left them; the ids as
    they are."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import cand_exact_plain
    if kind == "keep":
        b = args[0].double()
        return kind, (b, torch.sum(b * b, dim=1), *args[2:]), kwargs
    metric, b, row0, cand, old_i = args[0], args[1].double(), *args[3:6]
    sq = torch.sum(b * b, dim=1)
    rows = torch.arange(row0, row0 + cand.shape[0], device=b.device)
    old_d = cand_exact_plain(metric, b, sq, rows, old_i).contiguous()
    return kind, (metric, b, sq, row0, cand, old_i, old_d), kwargs


def b6_past_1024(x_np, xc_np):
    """B6 and B6_f64 at k = 1,500 on stages captured from refine chunks of
    N_BIGK_CUT-row cuts (B6_f64 on the same stages' inputs at float64,
    ``stage_f64``):
    the cells' first (exact) stage, with 16·1,501 candidates a row (past
    the on-chip block: the workspace route), and the blobs' cascade and
    exact stages (on chip at float32; B6_f64's cascade on the workspace
    route); the cells' first stage again with n_valid = N − 64.  Each
    held to its plain version at the B6 bars on the chunk's first
    N_BIGK_HOLD rows, the route each took printed and the workspace route
    taken at least once a form; each stage timed a chunk over 8 chunks in
    sequence, with its bound.  Returns {form: (max err, {stage: (ms, plain
    ms, bound)})}."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import refine_route
    out = {"B6": (0.0, {}, {}), "B6_f64": (0.0, {}, {})}
    for tag, data in (("cells", xc_np), ("blobs", x_np)):
        x = torch.from_numpy(data[:N_BIGK_CUT]).cuda()
        captured = capture_refine_chunks(x, K_BIG_RUN, 8)
        del x
        for form in ("B6", "B6_f64"):
            err, shapes, routes = out[form]
            chunks = ([[stage_f64(*st) for st in chunk] for chunk in captured]
                      if form == "B6_f64" else captured)
            for s_idx, (kind, args, kwargs) in enumerate(chunks[0]):
                _, base, _ = stage_rows(kind, args)
                name = (f"{tag} k={K_BIG_RUN} "
                        f"{'keep' if kind == 'keep' else 'exact'} stage "
                        f"F={base.shape[1]}")
                cases = [("", kwargs)]
                if kwargs.get("graph") is not None and tag == "cells":
                    cases.append((" n_valid", dict(
                        kwargs, n_valid=N_BIGK_CUT - 64)))
                for extra, kw in cases:
                    before = route_counts()
                    held = cut_stage(kind, args, kw, N_BIGK_HOLD)
                    if form == "B6":
                        e, off = hold_stage(name + extra, *held)
                    else:
                        e, off = hold_stage_f64(name + extra, *held)
                    took = route_delta(before)
                    routes.update(took)
                    err = max(err, e)
                    print(f"[bigk] {form} {name}{extra} ({N_BIGK_HOLD} rows"
                          f"): max err {e:.3e} ({'sets' if form == 'B6' else 'off'}"
                          f" {off}); route {took}")
                stages = [chunk[s_idx] for chunk in chunks]
                ms = chunks_ms(stages)
                plain = chunks_ms(stages[:2], plain=True)
                got = stage_call(*stages[0])
                bnd, u, _ = stage_bound(kind, stages[0][1], stages[0][2], got)
                cand = args[3] if kind == "keep" else args[4]
                first = kwargs.get("graph") is not None
                ke = kwargs.get("ke", 0) if first else 0
                w = cand.shape[1]
                keep = (min(args[4], w * (1 + ke) if first else w)
                        if kind == "keep" else 0)
                rt = refine_route(base.shape[1], w, ke, keep, K_BIG_RUN,
                                  first, kind == "final",
                                  base.element_size())
                print(f"[bigk] {form} {name} c={cand.shape[0]}: {ms:.4f} ms a "
                      f"chunk over {len(stages)} chunks (plain {plain:.4f});"
                      f" bound {bnd[0]:.4f} ms by {bnd[1]} ({u} distinct "
                      f"rows); route {'workspace' if rt.workspace else 'chip'}"
                      f" ({rt.workspace} B a row of workspace, {rt.smem} B "
                      "shared memory)")
                shapes[(tag, kind, base.shape[1])] = (ms, plain, bnd)
            out[form] = (err, shapes, routes)
            del chunks
        del captured
        torch.cuda.empty_cache()
    for form, (_, _, routes) in out.items():
        check(any(k.endswith("workspace") for k in routes),
              f"[bigk] {form}: no stage took the workspace route ({routes})")
    return {form: (err, shapes) for form, (err, shapes, _) in out.items()}


def bigk_cross(x, graph):
    """B1's cross sweep (the ring's hop) at k = 1,500: a row block against
    every column gives the single sweep's rows bit for bit; against a
    column block, against its plain version on 256 of its rows (distances
    rtol 1e-4, neighbour sets >= 0.999, no padding or self); and the ring
    on the test mesh at D = 2 gives the single sweep's graph bit for bit
    (two hops a shard)."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_cross, knn_cross_plain
    from tsne_flink_tpu_torch.parallel.knn import ring_knn
    from tsne_flink_tpu_torch.parallel.mesh import run_shards
    n, k = x.shape[0], K_BIG_RUN
    want_i, want_d = graph
    si, sd = knn_cross(x[:20_000], x, k, False, 0, 0, n)
    check(torch.equal(si, want_i[:20_000]) and torch.equal(sd,
                                                           want_d[:20_000]),
          "[bigk] a cross hop against every column != the single sweep")
    hi, hd = knn_cross(x[:256], x[20_000:40_000], k, False, 0, 20_000, n)
    pd, pi = knn_cross_plain(x[:256], x[20_000:40_000], k, False, 0,
                             20_000, n)
    e = rel_close(hd, pd, 1e-4, "[bigk] cross hop distances")
    sets = set_agreement(hi, pi)
    check(sets >= 0.999 and bool((hi >= 20_000).all()),
          f"[bigk] cross hop: sets {sets}")
    reset_launches()
    outs = run_shards([x.device] * 2, lambda ax: ring_knn(
        x[ax.index * (n // 2):(ax.index + 1) * (n // 2)], k, n, axis=ax))
    torch.cuda.synchronize()
    ri = torch.cat([o[0] for o in outs])
    rd = torch.cat([o[1] for o in outs])
    same = torch.equal(ri, want_i) and torch.equal(rd, want_d)
    print(f"[bigk] cross hop k={k}: 20,000 rows x every column = the single"
          f" sweep's rows bit for bit; x a 20,000-column block vs plain: "
          f"max err {e:.3e}, sets {sets:.6f}; the ring on the test mesh of "
          f"2: the single sweep's graph bit for bit: {same} (B1 "
          f"{launches()['B1']} hops)")
    check(same and launches()["B1"] == 4,
          "[bigk] the ring at D = 2 != the single sweep")
    return e


def bigk_memory(tag, n, d, method, peak, held, bound, cycles=None):
    """The memory model's allocated peak for the run against the measured
    one (the run's peak less what the script held before it), within [1,
    2]x, the plan charged at the graph's row-width bound."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import (allocated_peak,
                                                         stage_terms)
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    plan = charged_plan(PlanConfig(
        n=n, d=d, k=K_BIG_RUN, backend="cuda", knn_method=method,
        knn_refine=cycles, repulsion="exact", sym_width=bound, name=tag))
    terms = stage_terms(plan)
    pa = max(allocated_peak(t) for t in terms.values())
    alloc = peak - held
    print(f"[bigk] {tag}: memory model allocated peak {pa / 2**30:.3f} GiB "
          f"vs measured {alloc / 2**30:.3f} GiB = {pa / alloc:.3f} (bar "
          f"[1, 2]); knn terms " + json.dumps(
              {t: round(v / 2**30, 4) for t, v in terms["knn"].items()
               if not isinstance(v, str)}))
    check(alloc <= pa <= 2 * alloc, f"[bigk] {tag}: the memory model "
          f"predicts {pa} for {alloc} measured")


def bigk_fit(tag, x_np, labels, method, want):
    """``TSNE(perplexity=500)`` at 60,000 x 784, 300 iterations, exact
    repulsion, ``knn_method``: launches counted from 0 just before it (B1
    / B6 and the routes they took), finite and falling KL, label
    agreement >= 0.9, its memory against the model.  Returns (estimator,
    kNN graph, launches, routes)."""
    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    from tsne_flink_tpu_torch.ops.knn_cuda import reset_route_launches
    n, d = x_np.shape
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_route_launches()
    t0 = time.perf_counter()
    with record_knn() as graph:
        est = TSNE(perplexity=PERPLEXITY_BIG, n_iter=ITERATIONS,
                   knn_method=method, theta=0.5, random_state=0).fit(x_np)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts, routes = launches(), route_counts()
    lh = est.kl_trace_
    print(f"[bigk] {tag}: TSNE(perplexity={PERPLEXITY_BIG}, knn_method="
          f"{method!r}).fit {n}x{d} (k={K_BIG_RUN}): {wall:.3f} s end to "
          f"end; launches {json.dumps(counts)}; classes and routes "
          f"{json.dumps(routes)}; KL head {np.round(lh[:3], 5).tolist()} "
          f"tail {np.round(lh[-3:], 5).tolist()}; peak {peak / 2**30:.3f} "
          "GiB")
    check(counts == want(counts), f"[bigk] {tag}: launches {counts}")
    check(bool(np.isfinite(est.embedding_).all()) and bool(
        np.isfinite(lh).all()) and lh[-1] < lh[11],
          f"[bigk] {tag}: non-finite or no falling KL")
    agree = label_agreement(torch.from_numpy(est.embedding_).cuda(), labels)
    print(f"[bigk] {tag}: 10-NN label agreement {agree:.4f} (bar 0.9)")
    check(agree >= 0.9, f"[bigk] {tag}: label agreement {agree}")
    bigk_memory(tag, n, d, method, peak, held, width_bound(graph[0]),
                pick_knn_refine(n, d) if method == "project" else None)
    return est, (graph[0].clone(), graph[1].clone()), counts, routes


def bigk_times(x, k):
    """B1 at 60,000 x 784 and k: its ms (median of 3 warm launches taken in
    turns with its library yardstick, chunked torch.matmul + torch.topk),
    the plain version's (one launch), and its bound (3xTF32 operations)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (knn_sweep_cuda,
                                                   knn_sweep_plain)
    t = alternated_ms({"kernel": lambda: knn_sweep_cuda(x, k, False),
                       "library": lambda: library_knn(x, k)},
                      ["kernel", "library", "library", "kernel", "kernel",
                       "library"])
    plain = cuda_ms(lambda: knn_sweep_plain(x, k, False), 1, 0)
    bnd = b1_bounds(x.shape[0], x.shape[1], k)[0]
    ms, lib = statistics.median(t["kernel"]), statistics.median(t["library"])
    print(f"[bigk] B1 {x.shape[0]}x{x.shape[1]} k={k} (pending class): "
          f"{spread(t['kernel'])}; library (chunked matmul + topk) "
          f"{spread(t['library'])}; plain {plain:.3f} ms; bound "
          f"{bnd[0]:.3f} ms by {bnd[1]} ({bnd[0] / ms:.3f} of it)")
    return (ms, plain, lib), bnd


def phase_bigk(x_np, labels, xc_np):
    """[bigk]: every kernel past k = 1,024 on the card (module docstring,
    phase 8c).  Returns {kernel id: its record's "bigk" entry}."""
    import shutil
    import tempfile

    import torch
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    t0 = time.perf_counter()
    x = torch.from_numpy(x_np).cuda()
    forms = b1_forms_past_1024(x)
    b6 = b6_past_1024(x_np, xc_np)
    n, d = x_np.shape
    cycles = pick_knn_refine(n, d)
    exact, graph_e, counts_e, _ = bigk_fit(
        "bruteforce", x_np, labels, "bruteforce",
        lambda c: {**{kid: 0 for kid in c}, "B1": 1, "B2": ITERATIONS,
                   "B3": c["B3"], "B5": c["B5"], "B4": ITERATIONS // 10})
    check(counts_e["B3"] + counts_e["B5"] == ITERATIONS,
          "[bigk] bruteforce: one attraction step an iteration")
    e_cross = bigk_cross(x, graph_e)
    del exact
    proj, graph_p, counts_p, routes_p = bigk_fit(
        "project", x_np, labels, "project",
        lambda c: {**{kid: 0 for kid in c},
                   "B6": b6_launches(n, d, K_BIG_RUN, cycles),
                   "B2": ITERATIONS, "B3": c["B3"], "B5": c["B5"],
                   "B4": ITERATIONS // 10})
    recall = recall_at_k(graph_p[1], graph_e[1])
    print(f"[bigk] project: recall@{K_BIG_RUN} against B1's graph "
          f"{recall:.4f} (bar 0.90); {cycles} refine cycles")
    check(recall >= 0.90, f"[bigk] project recall {recall} < 0.90")
    del graph_p
    # config 2's own command line at --perplexity 500: the estimator's bits
    tmp = tempfile.mkdtemp(prefix="tsne_bigk_")
    try:
        coo = shared_coo(x_np)
        out = os.path.join(tmp, "c2_500.csv")
        y_cli, counts_cli, _, _ = run_cli("config 2 --perplexity 500", [
            "--input", coo, "--output", out, "--dimension", str(d),
            "--perplexity", str(PERPLEXITY_BIG), "--iterations",
            str(ITERATIONS), "--randomState", "0", "--knnMethod", "project",
            "--theta", "0.5", "--noCache"])
        check(same_bits(y_cli, proj.embedding_) and counts_cli == counts_p,
              "[bigk] config 2 --perplexity 500 != TSNE(perplexity=500, "
              "knn_method='project')")
        print("[bigk] config 2 --perplexity 500: the estimator's embedding "
              "bit for bit, its launches")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # one 256-row serving bucket from the project model
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    q = make_data(256, seed=7)[0]
    reset_launches()
    y256 = proj.transform(q, bucket=256)
    c256 = launches()
    # four requests of 64 rows, each its own (padded) 256-row bucket
    y64 = np.concatenate([proj.transform(q[s:s + 64], bucket=256)
                          for s in range(0, 256, 64)])
    print(f"[bigk] serving: a 256-row bucket (query kNN k={K_BIG_RUN}, B5 "
          f"at [256, {K_BIG_RUN}]) launches {json.dumps(c256)}; finite "
          f"{bool(np.isfinite(y256).all())}; 1 x 256 = 4 x 64 bit for bit: "
          f"{same_bits(y256, y64)}")
    check(bool(np.isfinite(y256).all()) and same_bits(y256, y64)
          and c256["B5"] > 0 and c256["B2"] > 0,
          "[bigk] the serving bucket")
    del proj
    times, bnd = bigk_times(x, K_BIG_RUN)
    lib_err = forms["B1"][0]
    rec = {"B1": {"k": K_BIG_RUN, "launches": counts_e["B1"],
                  "max_abs_err": max(lib_err, e_cross), "ms": times[0],
                  "plain_ms": times[1], "library_ms": times[2],
                  "bound_ms": bnd[0], "bound_by": bnd[1],
                  "launch_ms": forms["B1"][1]}}
    for form in ("B1_bf16", "B1_f64"):
        rec[form] = {"k": list(K_BIG), "max_abs_err": forms[form][0],
                     "launch_ms": forms[form][1]}
    for form in ("B6", "B6_f64"):
        err, shapes = b6[form]
        rec[form] = {"k": K_BIG_RUN, "max_abs_err": err,
                     "launches": counts_p["B6"] if form == "B6" else 0,
                     "stages": {f"{t} {kind} F={f}": {
                         "ms": v[0], "plain_ms": v[1], "bound_ms": v[2][0],
                         "bound_by": v[2][1]}
                         for (t, kind, f), v in shapes.items()}}
    print(f"[bigk] phase {time.perf_counter() - t0:.1f} s")
    return rec


#: the wide phase: the widths B2w-B5w are held at (both dtypes), and the
#: width of its 60k runs, where they are held and timed again
WIDE_MS = (9, 12, 16, 31, 32, 50, 64, 100, 256)
M_WIDE = 16
#: the wide forms' ids, float32 then float64
WIDE_FORMS = tuple(NO_WIDE)


def wide_plain_chunk(m):
    """The plain B2's row chunk at width m: its m [chunk, N] difference
    planes stay under ~4 GiB at 60,000 columns."""
    return max(64, 16384 // m)


def wide_b2_gate(tag, y, rtol):
    """B2w (or B2w_f64) on y against its plain version (rep and the row
    Z within ``rtol`` with an absolute part of rtol·max), two launches
    bit for bit, a masked row shard against plain, and a shard's rows
    at the canonical split count the full launch's rows bit for bit.
    Returns the max error."""
    import torch
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    n, m = y.shape
    ch = wide_plain_chunk(m)
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True, row_chunk=ch)
    err = max(rel_close(rk, rp, rtol, f"[wide] {tag} rep"),
              rel_close(zk, zp, rtol, f"[wide] {tag} row Z"))
    again = cuda_exact_repulsion(y, row_z=True)
    check(torch.equal(again[0], rk) and torch.equal(again[1], zk),
          f"[wide] {tag}: two launches differ")
    valid = torch.arange(n, device="cuda") % 13 != 5
    a, b = n // 4, n // 2 + 3
    sk = cuda_exact_repulsion(y[a:b], y, row_offset=a, col_valid=valid,
                              row_z=True)
    sp = exact_repulsion(y[a:b], y, row_offset=a, col_valid=valid,
                         row_z=True, row_chunk=ch)
    err = max(err, rel_close(sk[0], sp[0], rtol, f"[wide] {tag} shard rep"),
              rel_close(sk[1], sp[1], rtol, f"[wide] {tag} shard Z"))
    canon = n // 8
    full = cuda_exact_repulsion(y, row_z=True, split_rows=canon)
    shard = cuda_exact_repulsion(y[a:b], y, row_offset=a, row_z=True,
                                 split_rows=canon)
    check(torch.equal(shard[0], full[0][a:b])
          and torch.equal(shard[1], full[1][a:b]),
          f"[wide] {tag}: a shard's rows differ from the full launch's")
    return err


def wide_b3_gate(tag, y, jidx, jval, rag, rtol, vs_f64=False):
    """B3w (or B3w_f64): one launch over a head block and a ragged tail,
    with a padded-row mask, on tie-free inputs (every grad at ±(|att| + a
    margin)): the gains exactly its plain version's, y, update and
    ‖grad‖² within ``rtol`` — with ``vs_f64`` (a float32 run's final y,
    where the forward part's norm trick cancels) instead each within
    twice the plain float32 version's own error against the plain
    version in float64 —, the unfused step (B5w over head + tail, att −
    rep/Z, the vdM update in PyTorch) bit for bit, two launches bit for
    bit.  Returns the max error against the plain version (and, with
    ``vs_f64``, also {output: (kernel's, plain's) max error against
    float64})."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    n, m = y.shape
    rng = np.random.default_rng(m)
    dt = y.dtype

    def t(a):
        return torch.from_numpy(np.asarray(a)).to("cuda", dt)
    forces = att.attraction_forces(y, y, jidx, jval, 4.0, ragged=rag)
    sign = t(rng.choice([-1.0, 1.0], (n, m)))
    margin = torch.abs(forces) + 1e-3 * torch.max(torch.abs(forces))
    rep = (forces - sign * margin).contiguous()
    upd = t(1e-2 * rng.standard_normal((n, m)))
    gains = t(1.0 + rng.random((n, m)))
    valid = torch.arange(n, device="cuda") % 9 != 4
    z = torch.ones((), dtype=dt, device="cuda")
    args = (y, y, jidx, jval, 4.0, rep, z, valid, upd, gains, 0.8)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
    ok = att.fused_step_update(*args, **kw)
    op = att.fused_step_plain(*args, **kw)
    check(torch.equal(ok[2], op[2]), f"[wide] {tag}: gains differ")
    names = ("y", "update", "gains", "|grad|^2")
    vs = {}
    if vs_f64:
        args64 = tuple(a.double() if torch.is_tensor(a)
                       and a.dtype == torch.float32 else a for a in args)
        o64 = att.fused_step_plain(*args64, **{
            **kw, "ragged": rag._replace(val=rag.val.double())})
        for a, b, r, what in zip(ok, op, o64, names):
            ek = float(torch.max(torch.abs(a.double() - r)))
            ep = float(torch.max(torch.abs(b.double() - r)))
            vs[what] = (ek, ep)
            check(ek <= 2.0 * ep, f"[wide] {tag} {what} against float64: "
                  f"kernel {ek:.3e}, plain f32 {ep:.3e}")
        err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(ok, op))
        beyond = {what: rel_excess(a, b, rtol)[0]
                  for a, b, what in zip(ok, op, names)}
        print(f"[wide] {tag} against the plain version in float64 (kernel, "
              f"plain f32 max |err|): " + ", ".join(
                  f"{w} {e[0]:.3e} / {e[1]:.3e}" for w, e in vs.items())
              + f"; against the plain f32 version max |err| {err:.3e}, "
              f"elements beyond rtol {rtol} {beyond}")
    else:
        err = max(rel_close(a, b, rtol, f"[wide] {tag} {what}")
                  for a, b, what in zip(ok, op, names))
    grad = (forces - rep / z) * valid[:, None].to(dt)
    same = (grad > 0.0) == (upd > 0.0)
    g = torch.clamp(torch.where(same, gains * 0.8, gains + 0.2), min=0.01)
    u = 0.8 * upd - 200.0 * g * grad
    check(all(torch.equal(a, b) for a, b in zip(ok[:3], (y + u, u, g))),
          f"[wide] {tag}: the fused step differs from the unfused")
    again = att.fused_step_update(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(ok, again)),
          f"[wide] {tag}: two launches differ")
    return (err, vs) if vs_f64 else err


def wide_kernel_gates():
    """B2w-B5w and their float64 forms at every width of WIDE_MS on
    N_WIDTHS rows of a spread y (10·N(0, 1)) against their plain versions:
    rtol 2e-5 (B3's y and update 1e-4, its gains equal) at float32,
    F64_RTOL at float64; B5w/B4w on an edge problem (a hub row, an empty
    row, padding).  Returns {kernel id: max error}."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.kernels.build import M_NARROW
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops import repulsion_cuda as rc
    # the geometry the Python side mirrors (the memory model's split
    # count and slab) is the kernels' own
    for m in range(1, 2 * max(WIDE_MS) + 1):
        check(all(att.kernel_wide_config(m, f) == (
                  M_NARROW, att.wide_dims(f), att.wide_chunks(m, f))
                  and rc.kernel_wide_config(m, f) == (
                      M_NARROW, rc.wide_rows(m, f), rc.wide_chunk(m, f))
                  for f in (False, True)),
              f"[wide] m={m}: the Python geometry is not the kernels'")
    print(f"[wide] the wide forms' geometry (M_NARROW, B2w's rows a block "
          f"and force chunk, B3w-B5w's dims a chunk and chunks) as the "
          f"kernel library states it at m = 1 .. {2 * max(WIDE_MS)}: the "
          f"Python mirror's")
    errs = {kid: 0.0 for kid in WIDE_FORMS}
    rng = np.random.default_rng(20)
    for dt, sfx, rtol, rtol3 in ((torch.float32, "", 2e-5, 1e-4),
                                 (torch.float64, "_f64", F64_RTOL,
                                  F64_RTOL)):
        for m in WIDE_MS:
            t0 = time.perf_counter()
            y = torch.from_numpy(10.0 * rng.standard_normal(
                (N_WIDTHS, m))).to("cuda", dt)
            reset_launches()
            e2 = wide_b2_gate(f"B2w{sfx} m={m}", y, rtol)
            jidx, jval, rag = edge_problem(y, 64, 60 + m)
            jval = jval.to(dt)
            rag = rag._replace(val=rag.val.to(dt))
            z = torch.tensor(float(N_WIDTHS) ** 2 / 7.0, dtype=dt,
                             device="cuda")
            e5, e4 = hold_pass(f"wide{sfx} m={m}", y, jidx, jval, rag, z,
                               rtol=rtol)
            e3 = wide_b3_gate(f"B3w{sfx} m={m}", y, jidx, jval, rag, rtol3)
            got = launches()
            check(all(got[k + sfx] == 0 for k in ("B2", "B3", "B4", "B5"))
                  and all(got[k + sfx] > 0
                          for k in ("B2w", "B3w", "B4w", "B5w")),
                  f"[wide] m={m}{sfx}: launches {got}")
            for kid, e in (("B2w", e2), ("B3w", e3), ("B4w", e4),
                           ("B5w", e5)):
                errs[kid + sfx] = max(errs[kid + sfx], e)
            print(f"[wide] m={m}{' float64' if sfx else ''} on {N_WIDTHS} "
                  f"rows: max abs err B2w {e2:.3e}, B3w {e3:.3e} (gains "
                  f"equal, the unfused step's bits), B4w {e4:.3e}, B5w "
                  f"{e5:.3e}; two launches bit for bit; "
                  f"{time.perf_counter() - t0:.2f} s")
            del y, jidx, jval, rag
    return errs


def wide_b2_bound(n, m, isz):
    """B2w's bound at N rows and width m on the card's fastest pipe for
    each part of the work.  Float32: the (5m + 3)·N² operations (m
    differences and m FMAs of d², m FMAs of the force) plus N² reciprocals
    at RCP64_OPS each on the FP32 pipe (the force's product form cancels
    there, so it has no tensor-core rate).  Float64, at every m: the
    force's Σq²·y_j (2m·N²) on the FP64 tensor cores beside the pipe's
    (3m + 3)·N² + reciprocals, the larger of the two times (the product
    form holds float64's bar).  y read, rep and Z written once."""
    nbytes = n * m * isz + n * (m + 1) * isz
    if isz == 4:
        return bound((5.0 * m + 3 + RCP64_OPS) * n * n, nbytes)
    pipe = bound((3.0 * m + 3 + RCP64_OPS) * n * n, nbytes, PEAK_FP64_FLOPS)
    tc = bound(2.0 * m * n * n, nbytes, PEAK_FP64_TC_FLOPS)
    return max(pipe, tc)


def wide_bounds(n, m, isz, hval, e_tail):
    """The wide forms' bounds at [full]'s CSR (head ``hval``, ``e_tail``
    tail edges) and width m: B2 by operations (``wide_b2_bound``), B3-B5
    the larger of their (6m + 10) operations a set slot and their bytes
    (the head's values and its set ids, 4 + isz bytes a tail edge and the
    row pointer, y read once in m·isz-byte rows, and their own
    planes)."""
    peak = PEAK_FP64_FLOPS if isz == 8 else PEAK_FP32_FLOPS
    nnz = int((hval > 0).sum())
    head = hval.numel() * isz + nnz * 4
    tail = (4.0 + isz) * e_tail + 8.0 * (n + 1)
    ops = (6.0 * m + 10.0) * (nnz + e_tail)  # |y_j|², y_i·y_j, the force
    return {
        "B2w": wide_b2_bound(n, m, isz),
        "B3w": bound(ops, head + tail + 7 * n * m * isz + n * isz, peak),
        "B4w": bound(ops, head + tail + n * m * isz + 2 * n * isz, peak),
        "B5w": bound(ops, head + tail + 2 * n * m * isz, peak)}


def timed_once(fn):
    """(CUDA-event ms, result) of one call of ``fn``, no warm-up."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def wide_times(y, csr, tag):
    """B2w-B5w (or their float64 forms, by y's dtype) at 60,000 rows and
    width y.shape[1] on [full]'s CSR (head W = 256 + the tail), held and
    timed there.  Held, two launches bit for bit each: B2w's rep and row
    Z against its plain version at rtol 2e-5 (F64_RTOL at float64); at
    float64 B5w's forces, B4w's per-row and total KL at F64_RTOL and B3w
    (``wide_b3_gate``: tie-free grads, a padded-row mask) its y, update
    and ‖grad‖² with its gains equal and the unfused step's bits; at
    float32, where the forward part's norm trick cancels at a run's y as
    the plain version's does, B5w, B4w (``against_f64``) and B3w's y,
    update and ‖grad‖² each within twice the plain float32 version's own
    error against the plain version in float64 (gains equal, the
    unfused step's bits), their errors against the float32 plain version
    and the elements beyond 2e-5 (1e-4) printed.
    Timed: each kernel's CUDA-event ms (B3w the run's step, hubs first)
    beside its plain version's and its bound.  Returns ({kid: max error},
    {kid: (kernel's, plain's) max error against float64} (float32 B4w /
    B5w), {kid: ((ms, plain ms, None), bound)})."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    n, m = y.shape
    dt = y.dtype
    f64 = dt == torch.float64
    sfx = "_f64" if f64 else ""
    rtol, rtol3 = (F64_RTOL, F64_RTOL) if f64 else (2e-5, 1e-4)
    hidx, hval = csr[0], csr[1].to(dt)
    tsrc, tdst, tval = _without_padding(csr[2:])
    rag = att.ragged_edges(tsrc, tdst, tval.to(dt), n)
    ch = wide_plain_chunk(m)
    # held at this run's shapes and y
    rep, zr = cuda_exact_repulsion(y, row_z=True)
    again = cuda_exact_repulsion(y, row_z=True)
    check(torch.equal(again[0], rep) and torch.equal(again[1], zr),
          f"[wide] B2w{sfx} {tag}: two launches differ")
    b2_pms, (rp, zp) = timed_once(
        lambda: exact_repulsion(y, row_z=True, row_chunk=ch))
    errs = {"B2w": max(rel_close(rep, rp, rtol, f"[wide] B2w{sfx} {tag} rep"),
                       rel_close(zr, zp, rtol,
                                 f"[wide] B2w{sfx} {tag} row Z"))}
    del rp, zp, again
    z = torch.sum(zr)
    vs64 = {}
    if f64:
        errs["B5w"], errs["B4w"] = hold_pass(f"wide{sfx} {tag}", y, hidx,
                                             hval, rag, z, rtol=rtol)
        errs["B3w"] = wide_b3_gate(f"B3w{sfx} {tag}", y, hidx, hval, rag,
                                   rtol3)
    else:
        # the forward part's norm trick cancels at a run's final y as the
        # plain version's does: held to the plain float32 version's own
        # error against float64 (against_f64), two launches bit for bit
        fk = att.attraction_forces(y, y, hidx, hval, 4.0, ragged=rag)
        lk = att.attraction_loss(y, y, hidx, hval, 1.0, z, ragged=rag)
        check(torch.equal(fk, att.attraction_forces(y, y, hidx, hval, 4.0,
                                                    ragged=rag))
              and torch.equal(lk, att.attraction_loss(y, y, hidx, hval, 1.0,
                                                      z, ragged=rag)),
              f"[wide] B5w/B4w {tag}: two launches differ")
        for kid, k_out, p_out in (
                ("B5w", fk, att.attraction_forces_plain(
                    y, y, hidx, hval, 4.0, ragged=rag)),
                ("B4w", lk, att.attraction_loss_plain(
                    y, y, hidx, hval, 1.0, z, ragged=rag))):
            bad, errs[kid] = rel_excess(k_out, p_out, rtol)
            print(f"[wide] {kid} {tag}: against the plain f32 version max "
                  f"|err| {errs[kid]:.3e}, {bad} of {k_out.numel()} "
                  f"elements beyond rtol {rtol} (held against float64 "
                  f"below)")
        del fk, lk
        got = against_f64(f"wide {tag}", y, hidx, hval, rag, z)
        vs64 = {kid + "w": v for kid, v in got.items()}
        errs["B3w"], v3 = wide_b3_gate(f"B3w {tag}", y, hidx, hval, rag,
                                       rtol3, vs_f64=True)
        vs64["B3w"] = max(v3.values())
    print(f"[wide] {tag} ({n} x {m}, [full]'s CSR W={hidx.shape[1]} + "
          f"{tval.shape[0]} tail edges): against plain, max abs err "
          + ", ".join(f"{k}{sfx} {v:.3e}" for k, v in errs.items())
          + "; two launches bit for bit")
    # timed
    rng = np.random.default_rng(22)
    upd = 1e-2 * torch.from_numpy(rng.standard_normal((n, m))).to(
        "cuda", dt)
    gains = 1.0 + torch.from_numpy(rng.random((n, m))).to("cuda", dt)
    order = att.visit_order(rag)
    step = dict(eta=200.0, min_gain=0.01, ragged=rag)
    calls = {
        "B2w": (lambda: cuda_exact_repulsion(y), None),
        "B3w": (lambda: att.fused_step_update(
                    y, y, hidx, hval, 1.0, rep, z, None, upd, gains, 0.8,
                    order=order, **step),
                lambda: att.fused_step_plain(
                    y, y, hidx, hval, 1.0, rep, z, None, upd, gains, 0.8,
                    **step)),
        "B4w": (lambda: att.attraction_loss(y, y, hidx, hval, 1.0, z,
                                            ragged=rag),
                lambda: att.attraction_loss_plain(y, y, hidx, hval, 1.0, z,
                                                  ragged=rag)),
        "B5w": (lambda: att.attraction_forces(y, y, hidx, hval, 1.0,
                                              ragged=rag),
                lambda: att.attraction_forces_plain(y, y, hidx, hval, 1.0,
                                                    ragged=rag))}
    bnds = wide_bounds(n, m, y.element_size(), hval, int(tval.shape[0]))
    out = {}
    for kid, (kern, plain) in calls.items():
        ms = cuda_ms(kern, 5 if kid == "B2w" else 20)
        pms = b2_pms if plain is None else cuda_ms(plain, 1, 0)
        out[kid + sfx] = ((ms, pms, None), bnds[kid])
        print(f"[wide] {kid}{sfx} {tag} ({n} x {m}"
              + ("" if kid == "B2w" else f", W={hidx.shape[1]} + "
                 f"{tval.shape[0]} tail edges") + f"): {ms:.4f} ms (plain "
              f"{pms:.4f} ms, bound {bnds[kid][0]:.4f} ms by "
              f"{bnds[kid][1]}, {bnds[kid][0] / ms:.3f} of it)")
    return ({k + sfx: v for k, v in errs.items()},
            {k + sfx: v for k, v in vs64.items()}, out)


def wide_fit(tag, fit, labels, want):
    """One m = M_WIDE fit at 60,000 x 784 (``fit()`` returns (y on the
    card, the KL trace)), its launches counted from 0 just before it:
    ``want`` (the launches named there, every other kernel 0; the step's
    kernel, B3w in a fused CSR run and B5w in any other, every
    iteration), finite and falling KL, label agreement >= 0.9.  Returns
    (y, launches, seconds)."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    y, kl = fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    kl = torch.as_tensor(kl).double().cpu().numpy()
    agree = label_agreement(y, labels)
    sfx = "_f64" if y.dtype == torch.float64 else ""
    step = "B3w" if counts["B3w" + sfx] else "B5w"
    want = {**want, step + sfx: ITERATIONS}
    print(f"[wide] {tag}: {wall:.3f} s end to end; launches "
          f"{json.dumps(counts)}; KL head {np.round(kl[:3], 5).tolist()} "
          f"tail {np.round(kl[-3:], 5).tolist()}; 10-NN label agreement "
          f"{agree:.4f} (bar 0.9)")
    check({k: v for k, v in counts.items() if v} == want,
          f"[wide] {tag}: launches {counts}, want {want}")
    check(tuple(y.shape) == (N_FULL, M_WIDE) and bool(torch.isfinite(y).all())
          and bool(np.isfinite(kl).all()) and kl[-1] < kl[11],
          f"[wide] {tag}: non-finite, wrong shape or no falling KL")
    check(agree >= 0.9, f"[wide] {tag}: label agreement {agree}")
    return y, counts, wall


def phase_wide(x_np, labels, csr, m64=False):
    """[wide]: embeddings wider than 8 (module docstring, phase 8e).
    Returns ({kernel id: max error}, {kernel id: (ms, plain ms, None)},
    {kernel id: bound}, {kernel id: launches}, {kernel id: max error at
    the runs' final y}, {kernel id: (kernel's, plain's) max error against
    float64 there}, {kernel id: the m = 64 times, with ``m64``}) for the
    wide forms."""
    import re
    import shutil
    import tempfile

    import torch
    from tsne_flink_tpu_torch import TSNE, TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    t_phase = time.perf_counter()
    errs = wide_kernel_gates()
    n, d = x_np.shape
    it = ITERATIONS
    # the slice's full-width run: tsne_embed at n_components 16
    cfg = TsneConfig(n_components=M_WIDE, perplexity=PERPLEXITY,
                     iterations=it)
    y16, counts, _ = wide_fit(
        "tsne_embed n_components=16 (exact, the default layout)",
        lambda: tsne_embed(x_np, cfg, neighbors=K, seed=0), labels,
        {"B1": 1, "B2w": it, "B4w": it // 10})
    n_launch = {kid: counts[kid] for kid in ("B2w", "B3w", "B4w")}
    # float64 through the estimator, then one serving bucket of its model
    est64 = TSNE(n_components=M_WIDE, perplexity=PERPLEXITY, n_iter=it,
                 random_state=0, dtype="float64")
    y64, c64, _ = wide_fit(
        "TSNE(n_components=16, dtype='float64')",
        lambda: (lambda e: (torch.from_numpy(e.embedding_).cuda(),
                            e.kl_trace_))(est64.fit(x_np)), labels,
        {"B1_f64": 1, "B2w_f64": it, "B4w_f64": it // 10})
    check(est64.embedding_.dtype == np.float64, "[wide] float64 fit dtype")
    n_launch.update({kid: c64[kid] for kid in ("B2w_f64", "B3w_f64",
                                               "B4w_f64")})
    q = make_data(256, seed=7)[0]
    reset_launches()
    t64 = est64.transform(q, bucket=256)
    got = launches()
    check(np.isfinite(t64).all() and t64.shape == (256, M_WIDE)
          and got["B5w_f64"] == 75 and got["B2w_f64"] == 75,
          f"[wide] float64 transform: launches {got}")
    n_launch["B5w_f64"] = got["B5w_f64"]
    print(f"[wide] the float64 model's 256-row bucket: launches "
          f"{json.dumps({k: v for k, v in got.items() if v})}, finite")
    # config 2's command line at --nComponents 16 = the project estimator
    est = TSNE(n_components=M_WIDE, perplexity=PERPLEXITY, n_iter=it,
               knn_method="project", theta=0.5, random_state=0)
    cycles = pick_knn_refine(n, d)
    yp, cp, _ = wide_fit(
        "TSNE(n_components=16, knn_method='project', theta=0.5)",
        lambda: (lambda e: (torch.from_numpy(e.embedding_).cuda(),
                            e.kl_trace_))(est.fit(x_np)), labels,
        {"B6": b6_launches(n, d, K, cycles), "B2w": it, "B4w": it // 10})
    # ... under --auditPlan as users give it: the memory model's re-check
    # at the graph's width bound against the run's measured peak
    tmp = tempfile.mkdtemp(prefix="tsne_wide_")
    try:
        coo = shared_coo(x_np)
        path = os.path.join(tmp, "c2_m16.csv")
        rc, out, c_cli, secs, peak = _cli_captured([
            "--input", coo, "--output", path, "--dimension", str(d),
            "--perplexity", str(PERPLEXITY), "--iterations", str(it),
            "--randomState", "0", "--knnMethod", "project", "--theta",
            "0.5", "--nComponents", str(M_WIDE), "--noCache",
            "--auditPlan"])
        check(rc == 0, f"[wide] config 2 --nComponents 16: exit {rc}")
        from tsne_flink_tpu_torch.utils import native
        y_cli = native.load_coo(path, cols=1 + M_WIDE)[:, 1:].astype(
            np.float32)
        again = re.search(r"# auditPlan: after kNN: width bound (\d+): "
                          r"peak HBM est ([0-9.]+) GiB in '(\w+)'", out)
        check(again is not None, "[wide] no --auditPlan re-check line")
        ratio = float(again.group(2)) * 2**30 / peak
        print(f"[wide] config 2 --nComponents 16 --auditPlan: {secs:.3f} s; "
              f"the re-check at width bound {again.group(1)} predicts "
              f"{float(again.group(2)):.3f} GiB in '{again.group(3)}' vs "
              f"{peak / 2**30:.3f} GiB measured allocated (x{ratio:.3f}, "
              f"bar [1, 2]); the estimator's embedding bit for bit: "
              f"{same_bits(y_cli, est.embedding_)}, its launches: "
              f"{c_cli == cp}")
        check(same_bits(y_cli, est.embedding_) and c_cli == cp,
              "[wide] config 2 --nComponents 16 != the project estimator")
        check(1.0 <= ratio <= 2.0, f"[wide] --auditPlan at m = 16 reads "
              f"x{ratio:.3f} of the measured peak")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # a 256-row serving bucket of the m = 16 model: 1 x 256 = 4 x 64
    reset_launches()
    t256 = est.transform(q, bucket=256)
    c256 = launches()
    t4 = np.concatenate([est.transform(q[s:s + 64], bucket=256)
                         for s in range(0, 256, 64)])
    print(f"[wide] serving: a 256-row bucket of the m = 16 model launches "
          f"{json.dumps({k: v for k, v in c256.items() if v})}; finite "
          f"{bool(np.isfinite(t256).all())}; 1 x 256 = 4 x 64 bit for bit: "
          f"{same_bits(t256, t4)}")
    check(bool(np.isfinite(t256).all()) and same_bits(t256, t4)
          and c256["B5w"] == 75 and c256["B2w"] == 75,
          "[wide] the serving bucket")
    n_launch["B5w"] = c256["B5w"]
    del est, est64
    # the thread mesh at D = 2 gives D = 1's bits
    fits = {}
    for dd in (1, 2):
        reset_launches()
        t0 = time.perf_counter()
        fits[dd] = TSNE(mesh=["cuda:0"] * dd, n_components=M_WIDE,
                        perplexity=PERPLEXITY, n_iter=it,
                        random_state=0).fit(x_np).embedding_
        got = launches()
        print(f"[wide] TSNE(n_components=16) on the test mesh of {dd} "
              f"shard(s): {time.perf_counter() - t0:.3f} s, launches "
              f"{json.dumps({k: v for k, v in got.items() if v})}")
        check(got["B2w"] == dd * it and got["B2"] == 0,
              f"[wide] mesh {dd} launches {got}")
    check(same_bits(fits[2], fits[1]), "[wide] mesh 2 differs from mesh 1")
    print("[wide] mesh 2 equals mesh 1 bit for bit at m = 16")
    # the forms held and timed at 60k at the runs' final y on [full]'s CSR
    # (and, with ``m64``, timed at a spread y at m = 64)
    times, bnds, at_run, vs64, at64 = {}, {}, {}, {}, {}
    for yy, tag in ((y16, "at the m = 16 run's final y"),
                    (y64, "at the float64 run's final y")):
        e_run, v64, tms = wide_times(yy.contiguous(), csr, tag)
        at_run.update(e_run)
        vs64.update(v64)
        for kid, (tm, bd) in tms.items():
            times[kid], bnds[kid] = tm, bd
    del y16, y64, yp
    for kid, e in at_run.items():
        errs[kid] = max(errs[kid], e)
    rng = np.random.default_rng(64)
    for dt in ((torch.float32, torch.float64) if m64 else ()):
        yw = torch.from_numpy(10.0 * rng.standard_normal((n, 64))).to(
            "cuda", dt)
        for kid, (tm, bd) in wide_times(yw, csr, "at a spread y")[2].items():
            at64[kid] = {"m": 64, "ms": tm[0], "plain_ms": tm[1],
                         "bound_ms": bd[0], "bound_by": bd[1]}
        del yw
    torch.cuda.empty_cache()
    print(f"[wide] phase {time.perf_counter() - t_phase:.1f} s")
    return errs, times, bnds, n_launch, at_run, vs64, at64


# ---- [features]: features past 12,288 (B6's unstaged form) ----------------

#: a synthetic stand-in for 10x Genomics' "Fresh 68k PBMCs (Donor A)"
#: (Zheng et al., Nat. Commun. 2017): 68,579 cells x 32,738 genes of raw
#: counts, ~2% of a row detected (a median of ~600 genes), log1p of the
#: counts per 10,000; the routes run on a 20,000-row cut at the full width
N_COUNTS, F_COUNTS, N_COUNTS_CUT = 68_579, 32_738, 20_000
#: cell types, marker genes a type (each 40x its popularity), the median
#: count draws a cell (a multinomial over its type's gene weights)
COUNT_TYPES, COUNT_MARKERS, COUNT_DRAWS = 20, 150, 900
#: the cut's run at perplexity 500 (k = 1,500)
K_COUNTS_BIG = 1_500
#: rows of the slices over which [features] holds B6u / B6u_f64 against
#: their plain versions (the plain chunk body gathers [c, 270, F]: 2.3 GB
#: at 64 rows, 145 GB in the run's own 4,096-row chunks)
B6U_HELD_ROWS = 64


def make_counts(n=N_COUNTS, d=F_COUNTS, types=COUNT_TYPES, seed=0):
    """Cluster-structured raw counts, log1p-normalised, as COO triples on
    the card: each cell draws ~COUNT_DRAWS counts (lognormal spread)
    from its type's gene weights — a Zipf-like popularity shared by every
    type, COUNT_MARKERS markers of its own at 40x — and a gene's value is
    log1p(its count x 10,000 / the cell's total).  The draws come from
    numpy (``seed``); the inverse-CDF lookup and the per-cell dedup run on
    the card.  Returns (rows int64, cols int64, values float32, the cells'
    types), rows ascending."""
    import torch
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, types, n)
    pop = (1.0 / np.arange(1, d + 1) ** 0.9)[rng.permutation(d)]
    w = np.tile(pop, (types, 1))
    for t in range(types):
        w[t, rng.choice(d, COUNT_MARKERS, replace=False)] *= 40.0
    cdf = np.cumsum(w / w.sum(axis=1, keepdims=True), axis=1)
    cdf[:, -1] = 1.0
    cdf += np.arange(types)[:, None]  # type t's CDF in (t, t + 1]
    draws = np.clip(rng.lognormal(np.log(COUNT_DRAWS), 0.3, n), 100,
                    6000).astype(np.int64)
    u = rng.random(int(draws.sum()))
    dev = torch.device("cuda")
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.from_numpy(draws).to(dev))
    lab = torch.from_numpy(labels).to(dev)[row]
    gene = torch.searchsorted(torch.from_numpy(cdf.ravel()).to(dev),
                              torch.from_numpy(u).to(dev) + lab, right=True)
    gene = torch.clamp(gene - lab * d, 0, d - 1)
    del u, lab
    key, cnt = torch.unique(row * d + gene, return_counts=True)
    del row, gene
    r, c = key // d, key % d
    lib = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, r, cnt.double())
    v = torch.log1p(cnt.double() * (1e4 / lib[r])).float()
    return r, c, v, labels


def counts_dense(r, c, v, n, d):
    """The triples as a dense [n, d] float32 matrix on their device."""
    import torch
    x = torch.zeros((n, d), dtype=torch.float32, device=v.device)
    x[r, c] = v
    return x


def features_data(n, d=F_COUNTS, seed=0):
    """make_counts densified on the card: (x, (rows, cols, values) on the
    host, types, seconds), its shape and non-zeros printed."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, c, v, labels = make_counts(n, d, seed=seed)
    x = counts_dense(r, c, v, n, d)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per = torch.bincount(r, minlength=n)
    triples = (r.cpu().numpy(), c.cpu().numpy(), v.cpu().numpy())
    print(f"[features] counts {n} x {d}: {v.numel()} non-zeros "
          f"({v.numel() / (n * d):.4f} of the matrix; a median of "
          f"{int(per.median())} genes a cell, {int(per.min())}-"
          f"{int(per.max())}), {x.numel() * 4 / 1e9:.3f} GB dense float32 "
          f"on the card, {x.numel() / 2**31:.3f} x 2^31 elements; made in "
          f"{secs:.2f} s")
    del r, c, v
    return x, triples, labels, secs


def hold_stage_vs_f64(tag, kind, args, kwargs):
    """A float32 exact stage against float64: the max |d² error| of the
    kernel's list against a float64 evaluation of its (row, id) pairs (each
    id at the smaller of its old and its new distance) within twice the
    plain float32 version's own, and no slot whose ids differ where the
    two lists' d² differ by more than that bar.  Returns (kernel error,
    plain error, ids off)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import cand_exact_plain
    rows, base, _ = stage_rows(kind, args)
    metric, old_i, old_d = args[0], args[5], args[6].double()
    (gi, gd), (wi, wd) = (stage_call(kind, args, kwargs),
                          stage_call(kind, args, kwargs, plain=True))
    x64 = base.double()
    s64 = torch.sum(x64 * x64, dim=1)
    sqr = 2 if metric == "euclidean" else 1

    def err(ids, d):
        new = cand_exact_plain(metric, x64, s64, rows, ids)
        hit = ids[:, :, None] == old_i[:, None, :]
        old = torch.where(hit, old_d[:, None, :], math.inf).amin(dim=2)
        return float((d.double() ** sqr
                      - torch.minimum(new, old) ** sqr).abs().max())
    e_k, e_p = err(gi, gd), err(wi, wd)
    del x64
    off = int(((gi != wi) & ((gd.double() ** sqr - wd.double() ** sqr)
                             .abs() > 2.0 * e_p)).sum())
    print(f"[features] {tag}: d² error against float64 {e_k:.4e} (the "
          f"plain float32 version's {e_p:.4e}; bar 2x), {off} ids off "
          "outside pairs within the bar")
    check(e_k <= 2.0 * e_p, f"[features] {tag}: d² error {e_k} > 2 x "
          f"{e_p}")
    check(off == 0, f"[features] {tag}: {off} ids off outside the bar")
    return e_k, e_p, off


def ids_outside_ties(tag, base, sq, rows, got, want):
    """Slot by slot ``got``'s ids are ``want``'s, but where the two ids'
    formula d² lie within B6's bar of each other (float32: 2e-5 of the
    largest; float64: F64_RTOL of |d²| + ‖a‖² + ‖b‖²), a tie two summation
    orders may break either way.  Returns the slots that differ."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import cand_sqdist_plain
    sg = cand_sqdist_plain(base, sq, rows, torch.where(got >= 0, got,
                                                       rows[:, None]))
    sw = cand_sqdist_plain(base, sq, rows, torch.where(want >= 0, want,
                                                       rows[:, None]))
    safe = torch.where(want >= 0, want, rows[:, None]).long()
    tol = (F64_RTOL * (sw.abs() + sq[rows][:, None] + sq[safe])
           if base.dtype == torch.float64
           else torch.full_like(sw, 2e-5 * float(sw.abs().max())))
    differ = (got != want) & (got >= 0) & (want >= 0)
    check(torch.equal(got >= 0, want >= 0)
          and bool(((sg - sw).abs() <= tol)[differ].all()),
          f"[features] {tag}: ids differ outside ties")
    return int(differ.sum())


def unstaged_forced_at_a_staged_width(x_np):
    """B6's unstaged form forced at F <= 12,288 on the blobs' captured
    cascade (F = 128) and exact stage (F = 784) of a 20,000-row cut, at
    float32 and float64: held against its plain version at B6's bars (or
    B6_f64's), two launches bit for bit, and its ids the staged form's
    outside ties.  Its sums run over F in slabs, so its scores are not the
    staged form's bits."""
    import torch
    from tsne_flink_tpu_torch.ops import knn_cuda as kc
    for dt in (torch.float32, torch.float64):
        x = torch.from_numpy(x_np[:N_REFINE_DEEP]).to("cuda", dt)
        (chunk,) = capture_refine_chunks(x, K, 1)
        for kind, args, kwargs in chunk:
            rows, base, sq = stage_rows(kind, args)
            cand = args[3] if kind == "keep" else args[4]
            call = dict(n_valid=kwargs.get("n_valid"))
            if kind == "keep":
                call["keep"] = args[4]
            else:
                call.update(old=(args[5], args[6]),
                            euclid=args[0] == "euclidean")

            def launch(staged):
                out = kc._refine_launch(base, sq, int(rows[0]), cand,
                                        kwargs.get("graph"),
                                        kwargs.get("ke", 0), staged=staged,
                                        **call)
                return out if isinstance(out, tuple) else (out, None)
            staged, forced, again = launch(True), launch(False), launch(False)
            check(all(a is None or torch.equal(a, b)
                      for a, b in zip(forced, again)),
                  f"[features] the unstaged form forced at F = "
                  f"{base.shape[1]} ({dt}): two launches differ")
            tag = (f"B6u{'_f64' if dt == torch.float64 else ''} forced at "
                   f"F = {base.shape[1]} ({kind} stage)")
            hold = hold_stage_f64 if dt == torch.float64 else hold_stage
            e = hold(tag, kind, args, kwargs, got=forced)
            if isinstance(e, tuple):
                e = e[0]
            off = ids_outside_ties(tag, base, sq, rows, forced[0], staged[0])
            print(f"[features] {tag}: held against the plain version (max "
                  f"err {e:.3e}), two launches bit for bit, {off} slots "
                  "off the staged form's ids, all within a tie")
        del x, chunk


def features_holds(x, dt_name):
    """B6u (float32) or B6u_f64 on the stages of one refine chunk of
    B6U_HELD_ROWS rows captured on ``x`` (the counts, float32 or float64)
    at k = 90: the cascade (F = 128, staged B6 / B6_f64) and the exact
    stage (F = x's width, the unstaged form) held against their plain
    versions — float32 at the B6 bars (``hold_stage``) and against
    float64 (``hold_stage_vs_f64``), float64 at B6_f64's
    (``hold_stage_f64``).  Returns the exact stage's max error."""
    import torch
    f64 = x.dtype == torch.float64
    (chunk,) = capture_refine_chunks(x, K, 1, row_chunk=B6U_HELD_ROWS)
    err = 0.0
    for kind, args, kwargs in chunk:
        rows, base, _ = stage_rows(kind, args)
        c, f = rows.shape[0], base.shape[1]
        name = f"counts {dt_name} {kind} stage F={f}"
        if f64:
            e, _ = hold_stage_f64(name, kind, args, kwargs)
        else:
            e, _ = hold_stage(name, kind, args, kwargs)
        if kind != "final":
            print(f"[features] {'B6_f64' if f64 else 'B6'} {name} c={c}: "
                  f"held, max err {e:.3e}")
            continue
        if not f64:
            hold_stage_vs_f64(name, kind, args, kwargs)
        err = max(err, e)
        print(f"[features] {'B6u_f64' if f64 else 'B6u'} {name} c={c} "
              f"({args[4].shape[1]} candidates a row): held, max err "
              f"{e:.3e}; two launches bit-identical")
    del chunk
    return err


def stage_slice(args, kwargs, s0, s1):
    """An exact stage's inputs for rows s0 .. s1 - 1 of its chunk."""
    metric, base, cache, row0, cand, old_i, old_d = args[:7]
    kw = dict(kwargs)
    if kw.get("bad") is not None:
        kw["bad"] = kw["bad"][s0:s1]
    return (metric, base, cache, row0 + s0, cand[s0:s1], old_i[s0:s1],
            old_d[s0:s1]) + tuple(args[7:]), kw


def hold_run_chunks(x, dt_name):
    """B6u (float32) or B6u_f64 on the exact stage of the refine chunks
    that the tile plan gives a run on ``x`` (k = 90: 4,096 rows at 32,738
    features), every chunk of one round captured: the first chunk and the
    last (at 68,579 rows it holds the rows past 2^31 / F) launched whole,
    twice, bit-identical, and held against the plain version on
    B6U_HELD_ROWS-row slices of them at B6's bars (``hold_stage``) or
    B6_f64's (``hold_stage_f64``); then the kernel timed over the round's
    full chunks in sequence, the plain version over the first chunk's
    slices (its chunk body on the card, a slice at a time: a whole chunk's
    gather does not fit), and the bound from the first chunk's inputs.
    Returns (max error, (ms, plain ms, None), (bound ms, by), the
    kernel's ms a row)."""
    import torch
    f64 = x.dtype == torch.float64
    kid = "B6u_f64" if f64 else "B6u"
    hold = hold_stage_f64 if f64 else hold_stage
    finals = [chunk[-1] for chunk in capture_refine_chunks(x, K, None)]
    c_run = finals[0][1][4].shape[0]
    err = 0.0
    for pos in sorted({0, len(finals) - 1}):
        kind, args, kwargs = finals[pos]
        rows, base, _ = stage_rows(kind, args)
        c, f = rows.shape[0], base.shape[1]
        got = stage_call(kind, args, kwargs)
        again = stage_call(kind, args, kwargs)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"[features] {kid}: two launches of the run's chunk {pos} "
              "differ")
        del again
        e_chunk = 0.0
        for s0 in range(0, c, B6U_HELD_ROWS):
            s1 = min(c, s0 + B6U_HELD_ROWS)
            sa, skw = stage_slice(args, kwargs, s0, s1)
            e, _ = hold(f"counts {dt_name} run chunk {pos} rows "
                        f"{int(rows[s0])}-{int(rows[s1 - 1])}", kind, sa,
                        skw, got=(got[0][s0:s1], got[1][s0:s1]))
            e_chunk = max(e_chunk, e)
        err = max(err, e_chunk)
        past = int((rows.long() * f >= 2 ** 31).sum())
        print(f"[features] {kid} counts {dt_name} {x.shape[0]} x {f}: the "
              f"run's chunk {pos} of {len(finals)} (rows {int(rows[0])}-"
              f"{int(rows[-1])}, {past} of them past 2^31 / F) launched "
              f"whole twice, bit-identical, and held on {B6U_HELD_ROWS}-row "
              f"slices against the plain version: max err {e_chunk:.3e}")
        del got
    full = [st for st in finals if st[1][4].shape[0] == c_run]
    ms = chunks_ms(full)
    slices = [("final",) + stage_slice(finals[0][1], finals[0][2], s0,
                                       min(c_run, s0 + B6U_HELD_ROWS))
              for s0 in range(0, c_run, B6U_HELD_ROWS)]
    plain_ms = chunks_ms(slices, plain=True) * len(slices)
    bnd, u, _ = stage_bound(*finals[0], stage_call(*finals[0]))
    print(f"[features] {kid} counts {dt_name} exact stage in the run's "
          f"{c_run}-row chunks ({finals[0][1][4].shape[1]} candidates a "
          f"row, {u} distinct rows in the first): {ms:.4f} ms a chunk over "
          f"{len(full)} chunks in sequence, {ms / c_run * 1e3:.3f} us a row "
          f"(the plain chunk body on the card in {len(slices)} slices "
          f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}, library "
          "none)")
    del finals, full, slices
    return err, (ms, plain_ms, None), bnd, ms / c_run


def features_launches(n, d, k, cycles, layout, b1=0):
    """A counts run's launches: the refine funnel's cascade in B6 and its
    exact stage in B6u, once a chunk a cycle each."""
    want = layout_launches(layout, b1=b1, b6=b6_launches(n, d, k, cycles))
    want["B6"] //= 2
    want["B6u"] = want["B6"]
    return want


def features_memory(tag, n, d, k, cycles, peak, held, x_bytes, width,
                    assembly):
    """The memory model's allocated peak for a counts run at the graph's
    width bound against the measured one: the run's peak less what the
    script held before it, plus the points (densified on the card before
    the run, as a run would upload them), within [1, 2]x.  The plan is
    the charged one (``charged_plan``) of the assembly the run built:
    under ``auto`` the charge takes split rows up to the rows gate and
    the blocks layout past it, and the run builds one of them from its
    exact split width (blocks at 68,579 x 32,738).  The charge over both
    is printed beside it."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import (allocated_peak,
                                                         charged_plans,
                                                         stage_terms)
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig

    def peak_of(p):
        return max(allocated_peak(t) for t in stage_terms(p).values())
    plans = charged_plans(PlanConfig(
        n=n, d=d, k=k, backend="cuda", knn_method="project",
        knn_refine=cycles, repulsion="exact", sym_width=width, name=tag))
    built = [p for p in plans
             if (p.assembly == "blocks") == (assembly == "blocks")]
    check(len(built) == 1, f"[features] {tag}: the charge has no plan of "
          f"the {assembly} assembly the run built")
    terms = stage_terms(built[0])
    pa = peak_of(built[0])
    alloc = peak - held + x_bytes
    print(f"[features] {tag}: memory model allocated peak {pa / 2**30:.3f} "
          f"GiB ({assembly}, the assembly the run built; over every "
          f"assembly the charge allows {max(map(peak_of, plans)) / 2**30:.3f}"
          f") vs measured {alloc / 2**30:.3f} GiB = {pa / alloc:.3f} (bar "
          "[1, 2]); knn terms " + json.dumps(
              {t: round(v / 2**30, 4) for t, v in terms["knn"].items()
               if not isinstance(v, str)}))
    check(alloc <= pa <= 2 * alloc, f"[features] {tag}: the memory model "
          f"predicts {pa} for {alloc} measured")
    return pa / alloc


def features_run(tag, x, labels, b6u_row_ms):
    """``tsne_embed(x, TsneConfig(perplexity=30), knn_method="project")``
    on the counts (the auto funnel: JL skipped by the 95% rule, cascade at
    128, exact at F): exact launches (B6 the cascade, B6u the exact
    stage, a chunk a cycle each), stage split, finite and falling KL,
    10-NN type agreement, peak memory against the model; then B1's exact
    graph of the same points, timed, and recall@90 against it.  Returns
    a record."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    from tsne_flink_tpu_torch.ops.knn_cuda import reset_route_launches
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    n, d = x.shape
    cycles = pick_knn_refine(n, d)
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact")
    held = torch.cuda.memory_allocated()
    reset_route_launches()
    with record_knn() as graph:
        y, losses, stats, counts = run_embed(
            tag, x, cfg, lambda st: features_launches(n, d, K, cycles,
                                                      st["layout"]),
            knn_method="project")
    routes = route_counts()
    kl = quality(tag, y, losses, labels, cfg, 0.0)
    ratio = features_memory(tag, n, d, K, cycles, stats["peak_bytes"],
                            held, x.numel() * 4, width_bound(graph[0]),
                            stats["assembly"])
    dist_a = graph[1].clone()
    del graph[:], y
    _, dist_e, t_b1 = timed_exact_graph(x, K)
    recall = recall_at_k(dist_a, dist_e)
    del dist_e
    chunk = pick_knn_tiles(n, d, K, "cuda").refine_chunk
    b6u = (f"; B6u ~{cycles * n * b6u_row_ms / 1e3:.3f} s of it at "
           f"{b6u_row_ms * 1e3:.3f} us a row in its chunks")
    print(f"[features] {tag}: {cycles} refine cycles of {math.ceil(n / chunk)}"
          f" chunks of {chunk} rows; B6 x{counts['B6']} (cascade, F=128), "
          f"B6u x{counts['B6u']} (exact, F={d}); routes {json.dumps(routes)}"
          f"; the hybrid knn stage {stats['knn']:.3f} s (refine "
          f"{stats['knn_substages']['refine']:.3f}{b6u}) against B1's exact "
          f"graph {t_b1:.3f} s; recall@{K} {recall:.4f} (bar 0.90)")
    check(recall >= 0.90, f"[features] {tag}: recall@{K} {recall} < 0.90")
    return {"n": n, "d": d, "cycles": cycles, "chunk": chunk,
            "launches": counts, "routes": routes, "stages": {
                k_: v for k_, v in stats.items() if isinstance(v, float)},
            "knn_substages": stats["knn_substages"], "kl": kl,
            "b1_exact_s": t_b1, "recall": recall, "memory_ratio": ratio}


#: one rank of the cut's two-process project job (torch and the port only)
FEATURES_WORKER = r"""
import json, sys
import numpy as np, torch
from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.parallel.mesh import distributed_init
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
spec = json.loads(sys.argv[1])
distributed_init(spec["coordinator"], 2, spec["rank"], timeout_s=300)
x = torch.from_numpy(np.load(spec["x"]))
n, d = x.shape
reset_launches()
pipe = SpmdPipeline(TsneConfig(perplexity=spec["perplexity"],
                               iterations=spec["iterations"]), n, d,
                    spec["k"], knn_method="project")
y, losses = pipe(x, 0)
np.save(spec["out"], y.cpu().numpy())
print("FEATURES_RANK " + json.dumps(launches()))
"""


def features_fit(tag, x, want_kid, **kw):
    """``TSNE(knn_method="project", random_state=0, **kw).fit(x)`` with its
    launches and B6 routes counted from 0 just before it: finite and
    falling KL, ``want_kid`` launched.  Returns (embedding, launches,
    routes, seconds, final KL)."""
    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn_cuda import reset_route_launches
    torch.cuda.synchronize()
    reset_launches()
    reset_route_launches()
    t0 = time.perf_counter()
    est = TSNE(knn_method="project", random_state=0, **kw).fit(x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, routes = launches(), route_counts()
    lh = est.kl_trace_
    print(f"[features] {tag}: {secs:.3f} s end to end; launches "
          f"{json.dumps({k_: v for k_, v in counts.items() if v})}; B6 "
          f"routes {json.dumps(routes)}; KL tail "
          f"{np.round(lh[-3:], 5).tolist()}")
    check(bool(np.isfinite(est.embedding_).all()) and bool(
        np.isfinite(lh).all()) and lh[-1] < lh[11],
          f"[features] {tag}: non-finite or no falling KL")
    check(counts[want_kid] > 0, f"[features] {tag}: no {want_kid} launch")
    return est.embedding_, counts, routes, secs, float(lh[-1])


def write_coo_triples(path, triples, n, d, rows_per_block=1000):
    """The triples (rows ascending) as a COO CSV, blocks of rows built on a
    few threads and written in order; returns its lines."""
    from concurrent.futures import ThreadPoolExecutor
    r, c, v = triples
    cuts = np.searchsorted(r, np.arange(0, n + rows_per_block,
                                        rows_per_block))
    spans = list(zip(range(0, n, rows_per_block), cuts[:-1], cuts[1:]))
    with open(path, "wb") as f, ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        for text in pool.map(lambda s: coo_lines(
                r[s[1]:s[2]], c[s[1]:s[2]], v[s[1]:s[2]], s[0],
                min(n, s[0] + rows_per_block), d), spans):
            f.write(text)
    return len(v)


def features_cut_routes(x, triples, tmp):
    """The cut (20,000 x 32,738) through the routes with a form of their
    own: two gloo processes on the card (started first, run while the
    rest runs here) against the in-process job on the test mesh of 2 bit
    for bit; ``TSNE().fit``; ``TSNE(dtype="float64")`` (B6u_f64);
    ``TSNE(dtype="bfloat16")`` (bf16 operands in the Z-order products; B6u
    keeps its float32 bits); the command line from a COO CSV of the
    triples with ``--auditPlan`` (its embedding TSNE().fit's bit for
    bit); and perplexity 500 (k = 1,500; one refine cycle).  Returns
    {route: record}."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    n, d = x.shape
    out = {}
    xp = os.path.join(tmp, "counts.npy")
    np.save(xp, x.cpu().numpy())
    job = spmd_start([[sys.executable, "-c", FEATURES_WORKER, json.dumps({
        "coordinator": "{coord}", "rank": r, "x": xp, "k": K,
        "perplexity": PERPLEXITY, "iterations": ITERATIONS,
        "out": os.path.join(tmp, f"counts_y{r}.npy")})] for r in range(2)])
    try:
        y32, c32, _, s32, kl32 = features_fit("TSNE().fit (float32)", x,
                                              "B6u")
        out["fit"] = {"seconds": s32, "kl": kl32, "launches": c32}
        y64, c64, r64, s64, kl64 = features_fit(
            "TSNE(dtype='float64').fit", x, "B6u_f64", dtype="float64")
        check(c64["B6u"] == c64["B6"] == 0, "[features] a float32 form ran "
              "in the float64 fit")
        out["f64"] = {"seconds": s64, "kl": kl64, "launches": c64,
                      "routes": r64}
        del y64
        ybf, cbf, _, sbf, klbf = features_fit(
            "TSNE(dtype='bfloat16').fit", x, "B6u", dtype="bfloat16")
        out["bf16"] = {"seconds": sbf, "kl": klbf, "launches": cbf,
                       "kl_gap": klbf - kl32}
        print(f"[features] bf16 operands: final KL {klbf:.5f} against "
              f"float32's {kl32:.5f}")
        del ybf
        out["cli"] = features_cli(triples, n, d, y32, tmp)
        yk, ck, rk, sk, klk = features_fit(
            f"TSNE(perplexity=500).fit (k = {K_COUNTS_BIG}, one refine "
            "cycle)", x, "B6u", perplexity=K_COUNTS_BIG / 3.0, knn_refine=1)
        out["big_k"] = {"seconds": sk, "kl": klk, "launches": ck,
                        "routes": rk}
        del yk, y32
        # the in-process job at the processes' width (the project kNN's
        # band blocks split by range: the graph depends on the width)
        t0 = time.perf_counter()
        y_in, _ = SpmdPipeline(TsneConfig(perplexity=PERPLEXITY,
                                          iterations=ITERATIONS), n, d, K,
                               knn_method="project", devices=test_mesh(2))(
            x, 0)
        t_in = time.perf_counter() - t0
    finally:
        rcs, secs, outs = spmd_wait("features two-process project", job)
    check(rcs == [0, 0], f"[features] two-process job: exit codes {rcs}")
    rank_counts = [json.loads(o.split("FEATURES_RANK ")[1].splitlines()[0])
                   for o in outs]
    ys = [np.load(os.path.join(tmp, f"counts_y{r}.npy")) for r in range(2)]
    check(all(same_bits(y_, y_in.cpu().numpy()) for y_ in ys),
          "[features] the two-process job's embedding != the in-process "
          "job's")
    check(all(c_["B6u"] > 0 for c_ in rank_counts),
          "[features] a rank launched no B6u")
    print(f"[features] two processes: the in-process job's bits on the "
          f"test mesh of 2 ({t_in:.1f} s in process, {secs:.1f} s as two "
          f"processes beside the fits above); a rank's B6 / B6u launches "
          + ", ".join(f"{c_['B6']} / {c_['B6u']}" for c_ in rank_counts))
    os.remove(xp)
    out["spmd"] = {"seconds_in_process": t_in, "seconds": secs,
                   "rank_launches": rank_counts}
    del y_in
    torch.cuda.empty_cache()
    return out


def features_cli(triples, n, d, y_fit, tmp):
    """The command line on the cut, from the triples as a COO CSV, with
    ``--auditPlan``: the plan check before and after the kNN stage, B6u
    launched, the embedding ``y_fit``'s (TSNE().fit's) bit for bit."""
    coo = os.path.join(tmp, "counts.csv")
    t0 = time.perf_counter()
    lines = write_coo_triples(coo, triples, n, d)
    print(f"[features] wrote {lines} point,feature,value lines "
          f"({os.path.getsize(coo) / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.2f} s")
    out_buf = io.StringIO()
    with contextlib.redirect_stdout(out_buf):
        y_cli, c_cli, st_cli, _ = run_cli("features cut", [
            "--input", coo, "--output", os.path.join(tmp, "counts_y.csv"),
            "--loss", os.path.join(tmp, "counts.loss"), "--dimension",
            str(d), "--perplexity", str(PERPLEXITY), "--iterations",
            str(ITERATIONS), "--randomState", "0", "--knnMethod", "project",
            "--auditPlan", "--noCache"])
    os.remove(coo)
    plan_lines = [ln for ln in out_buf.getvalue().splitlines()
                  if ln.startswith("# auditPlan: ") and "peak HBM" in ln]
    for line in out_buf.getvalue().splitlines():
        print(f"[features] cli: {line}" if line.startswith("# auditPlan")
              else line)
    check(len(plan_lines) == 2, "[features] the CLI printed no plan check "
          "before and after the kNN stage")
    check(c_cli["B6u"] > 0, "[features] the CLI run launched no B6u")
    check(same_bits(y_cli, y_fit),
          "[features] the command line's embedding != TSNE().fit's")
    print("[features] the command line's embedding equals TSNE().fit's bit "
          "for bit")
    return {"stages": st_cli, "launches": c_cli}


def phase_features(x_np, full=False, routes=True):
    """[features] More than 12,288 features on a refining project plan:
    B6's unstaged form forced at the blobs' staged widths holds to its
    plain version and gives the staged form's ids outside ties; on the
    counts' 20,000-row cut at the full 32,738
    features, B6u and B6u_f64 held against their plain versions on a
    captured 64-row refine chunk (float32 also against float64), then on
    the run's own chunks (:func:`hold_run_chunks`: B6u's on the run's x,
    the cut or the full size) and timed there; the project run at the
    cut — or, with ``full``, at 68,579 x 32,738 (the script's) — with its
    exact launches, recall@90 against B1's exact
    graph and its memory against the model; then (``routes``) the cut
    through the routes of :func:`features_cut_routes`.  Returns ({kid:
    max error}, {kid: (ms, plain ms, None)}, {kid: (bound ms, by)}, {kid:
    launches}, the records)."""
    import shutil
    import tempfile

    import torch
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tsne_features_")
    try:
        unstaged_forced_at_a_staged_width(x_np)
        x, triples, labels, _ = features_data(N_COUNTS_CUT)
        errs, times, bnds = {}, {}, {}
        e32 = features_holds(x, "float32")
        x64 = x.double()
        e64 = features_holds(x64, "float64")
        e, times["B6u_f64"], bnds["B6u_f64"], _ = hold_run_chunks(
            x64, "float64")
        errs["B6u_f64"] = max(e64, e)
        del x64
        torch.cuda.empty_cache()
        recs = {}
        if full:
            xf, _, labels_f, _ = features_data(N_COUNTS)
        else:
            xf, labels_f = x, labels
        e, times["B6u"], bnds["B6u"], row_ms = hold_run_chunks(
            xf, "float32")
        errs["B6u"] = max(e32, e)
        torch.cuda.empty_cache()
        if full:
            recs["full"] = features_run("features full", xf, labels_f,
                                        row_ms)
            del xf
            torch.cuda.empty_cache()
        else:
            recs["cut"] = features_run("features cut", x, labels, row_ms)
        main = recs["full" if full else "cut"]
        n_launch = {"B6u": main["launches"]["B6u"], "B6u_f64": 0}
        if routes:
            recs["routes"] = features_cut_routes(x, triples, tmp)
            n_launch["B6u_f64"] = recs["routes"]["f64"]["launches"][
                "B6u_f64"]
        del x
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[features] phase {time.perf_counter() - t_phase:.1f} s")
    return errs, times, bnds, n_launch, recs


def native_embedding(path):
    from tsne_flink_tpu_torch.utils import native
    return native.load_coo(path)[:, 1:].astype(np.float32)


def refine_split(tag, stats, chunks, chunk_ms):
    """The refine substage split into B6 (its launches' chunks times the
    held chunk's kernel time) and the rest of the round (draws, gateways,
    reverse sample, gateway dedup, copies), by difference."""
    refine = stats["knn_substages"]["refine"]
    b6 = chunks * chunk_ms / 1e3
    print(f"[{tag}] refine {refine:.4f} s: B6 ~{b6:.4f} s ({chunks} chunks x "
          f"{chunk_ms:.4f} ms), the rest of the rounds {refine - b6:.4f} s "
          f"(by difference)")


def auto_crossover(d, eff_exact, eff_hybrid, k=K):
    """The smallest N (to 1%) at which ``pick_knn_method``'s cost model,
    with these efficiencies, prefers the hybrid plan at width ``d``."""
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine, pick_knn_rounds
    from tsne_flink_tpu_torch.utils.flops import knn_flops

    def hybrid_wins(n):
        exact = knn_flops(n, d, k, "bruteforce") / eff_exact
        hybrid = knn_flops(n, d, k, "project", rounds=pick_knn_rounds(n),
                           refine_rounds=pick_knn_refine(n, d)) / eff_hybrid
        return exact > hybrid

    lo, hi = 1_000, 1_000
    while not hybrid_wins(hi):
        lo, hi = hi, hi * 2
    while hi > lo * 1.01:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if hybrid_wins(mid) else (mid, hi)
    return hi


def phase_large(xc_np, labels, z_latent, y_60k, b2_ms_60k, b6_chunk_ms):
    """The 1.3M-cell shape with the hybrid kNN and FFT repulsion.  Returns
    the run's launches, and B4's and B5's times, bounds and errors on its
    attraction pass."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.affinities import affinity_blocks
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine, pick_knn_rounds
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_sweep_cuda
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.utils.flops import knn_flops

    n, d = xc_np.shape
    rounds, cycles = pick_knn_rounds(n), pick_knn_refine(n, d)
    cfg = TsneConfig(perplexity=PERPLEXITY_CELLS, iterations=ITERATIONS,
                     learning_rate=fitsne_learning_rate(n),
                     repulsion="fft", fft_grid=1024, fft_interp=3)
    agree_z = label_agreement(torch.from_numpy(z_latent).cuda(), labels)
    print(f"[large] the {z_latent.shape[1]}-D latent's own 10-NN label "
          f"agreement {agree_z:.4f}")
    with record_knn() as graph:
        y, losses, stats, counts = run_embed(
            "large", xc_np, cfg,
            lambda st: layout_launches(st["layout"], b1=0, b2=0,
                                       b6=b6_launches(n, d, K_CELLS,
                                                      cycles)),
            neighbors=K_CELLS, knn_method="project")
    kl = quality("large", y, losses, labels, cfg, agree_z - 0.05)
    x = torch.from_numpy(xc_np).cuda()
    _, dist_e, t_b1 = timed_exact_graph(x, K_CELLS)
    recall = recall_at_k(graph[1], dist_e)
    del dist_e
    print(f"[large] {rounds} seed rounds + {cycles} cycles, B6 x"
          f"{counts['B6']}: knn stage {stats['knn']:.3f} s; B1's exact "
          f"graph {t_b1:.3f} s; recall@{K_CELLS} {recall:.4f} (bar 0.90)")
    check(recall >= 0.90, f"[large] recall {recall} < 0.90")
    refine_split("large", stats, counts["B6"], b6_chunk_ms)
    # the blocks layout the run optimized: its attraction pass held and
    # timed as in [blocks]
    _, fwd_val, rev = affinity_blocks(graph[0], graph[1], PERPLEXITY_CELLS)
    rag = att.ragged_edges(*_without_padding(rev), n)
    z = torch.tensor(float(n) * n, device=y.device)
    errs = hold_pass(f"large {n} x W={K_CELLS} + reverse", embedding_like(
        n, 1), graph[0], fwd_val, rag, z)
    against_f64("large", y, graph[0], fwd_val, rag, z)
    del rag
    times, bounds = pass_times("large", y, graph[0], fwd_val, rev)
    # the run's P, its final y and KL, for [bh] and [pilot]
    run = (y, kl, stats["optimize"], graph[0], fwd_val, rev, cfg)
    del graph[:], fwd_val, rev
    # B1 at this shape, warm (the graph above was its first launch; one
    # warm launch, for the smoke's time)
    b1_ms = [cuda_ms(lambda: knn_sweep_cuda(x, K_CELLS, False), 1, 0)]
    del x
    b1_tf32, b1_fp32 = b1_bounds(n, d, K_CELLS)
    print(f"[large] B1 knn {n}x{d} k={K_CELLS}: {spread(b1_ms)}; bound "
          f"{b1_tf32[0]:.4f} ms (3xTF32 on the tensor cores), "
          f"{b1_fp32[0]:.4f} ms (one FP32 pass outside them); the library "
          f"yardstick is not timed at this shape")
    eff_exact = knn_flops(n, d, K_CELLS, "bruteforce") / t_b1
    eff_hybrid = knn_flops(n, d, K_CELLS, "project", rounds=rounds,
                           refine_rounds=cycles) / stats["knn"]
    print(f"[large] knn efficiencies (knn_flops / s): exact (B1) "
          f"{eff_exact:.4e}, hybrid {eff_hybrid:.4e}; with them "
          f"pick_knn_method's exact/hybrid crossover at k = 90 lies near "
          f"N = {auto_crossover(50, eff_exact, eff_hybrid)} (d = 50) and "
          f"N = {auto_crossover(784, eff_exact, eff_hybrid)} (d = 784)")
    sp, ff, ga, whole = fft_split(y, cfg)
    sp6, ff6, ga6, whole6 = fft_split(y_60k, cfg)
    b2_large = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 1, 0)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    print(f"[large] FFT repulsion at N={n}: {whole:.4f} ms (spread "
          f"{sp:.4f}, FFTs {ff:.4f}, gather {ga:.4f}); at N={N_FULL} "
          f"{whole6:.4f} ms (spread {sp6:.4f}, FFTs {ff6:.4f}, gather "
          f"{ga6:.4f}); per iteration {it_ms:.4f} ms")
    b5, b4 = times["B5"][0], times["B4"][0]
    print(f"[large] per iteration {it_ms:.4f} ms: FFT repulsion {whole:.4f}, "
          f"B5 (forward + reverse) {b5:.4f} x{counts['B5']}, B4/10 "
          f"{b4 / 10:.4f}, the rest {it_ms - whole - b5 - b4 / 10:.4f} (by "
          f"difference)")
    # B2 grows as N², the FFT as c0 + c1·N: the N where they cross
    a = b2_ms_60k / N_FULL ** 2
    c1 = (whole - whole6) / (n - N_FULL)
    c0 = whole6 - c1 * N_FULL
    cross = (c1 + math.sqrt(c1 * c1 + 4 * a * c0)) / (2 * a)
    b2_bound = bound(20.0 * n * n, n * 2 * 4 * 2 + n * 4)
    print(f"[large] B2 exact repulsion: {b2_ms_60k:.4f} ms at N={N_FULL}, "
          f"{b2_large:.4f} ms at N={n} (bound {b2_bound[0]:.4f} ms by "
          f"{b2_bound[1]}); exact/FFT crossover at N ~ {cross:.0f}")
    return counts, times, bounds, errs, run


#: the serving path (the JAX package's defaults) and the reference's
#: serve-record quality pins (tests/test_bench_contract.py:432-434)
SERVE_BUCKET, SERVE_ITERS, SERVE_ETA = 256, 75, 0.5
SERVE_SAMPLE, SERVE_KNN_K, SERVE_SPLIT = 256, 10, 1024
SERVE_RECALL, SERVE_DRIFT_MEDIAN, SERVE_DRIFT_P95 = 0.35, 0.01, 0.05
SERVE_DAEMON_ROWS = (64, 256, 1024, 64, 256, 1024, 64, 256)


@contextlib.contextmanager
def record_prepare():
    """Keep what the run's prepare stage returns (the list yielded gets
    it); the stage itself runs unchanged."""
    from tsne_flink_tpu_torch.utils import artifacts
    real = artifacts.prepare
    got = []

    def recorded(*a, **kw):
        out = real(*a, **kw)
        got[:] = [out]
        return out

    artifacts.prepare = recorded
    try:
        yield got
    finally:
        artifacts.prepare = real


def write_fat_checkpoint(path, y, losses, prep):
    """The run as ``--checkpoint --fatCheckpoint`` writes it: the state at
    its last iteration and the joint P in the prepare payload."""
    import torch
    from tsne_flink_tpu_torch import TsneState
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    payload = {"label": prep.label, "jidx": prep.jidx, "jval": prep.jval}
    if prep.affinity_fp is not None:
        payload["affinity_fp"] = prep.affinity_fp
    if prep.extra_edges is not None:
        payload.update(zip(("rsrc", "rdst", "rval"), prep.extra_edges))
    t0 = time.perf_counter()
    ckpt.save(path, TsneState(y=y, update=torch.zeros_like(y),
                              gains=torch.ones_like(y)), ITERATIONS, losses,
              payload)
    print(f"[project] fat checkpoint ({prep.label}, P "
          f"{tuple(prep.jidx.shape)}) written in "
          f"{time.perf_counter() - t0:.3f} s: "
          f"{os.path.getsize(path) / 2**20:.1f} MiB")


def embedding_knn(y_base, q, k):
    """Exact embedding-space kNN rows of ``q`` against ``y_base`` (the
    serve record's oracle: scripts/serve_bench._knn_rows), ties by index."""
    import torch
    d2 = torch.cdist(q.double(), y_base.double()) ** 2
    return torch.sort(d2, dim=1, stable=True).indices[:, :k].cpu().numpy()


def serve_quality(tag, model, sample):
    """scripts/serve_bench.py's quality block: self-transform ``sample``'s
    base rows, the drift from their fitted positions over the embedding
    span, and the recall of their embedding-space 10-NN (the row itself
    dropped on both sides); gated on the reference's serve bars."""
    import torch
    from tsne_flink_tpu_torch.serve.transform import transform
    yb = model.y
    yq = transform(model, model.x[sample].cpu().numpy(), bucket=SERVE_BUCKET,
                   iters=SERVE_ITERS, eta=SERVE_ETA)
    check(yq.shape == (len(sample), yb.shape[1]) and np.isfinite(yq).all(),
          f"[serve] {tag}: self-transform not finite [{len(sample)}, m]")
    y_np = yb.cpu().numpy()
    span = float(y_np.max(0).max() - y_np.min(0).min())
    drift = np.linalg.norm(yq - y_np[sample], axis=1)
    k = SERVE_KNN_K
    nn_fit = embedding_knn(yb, yb[torch.from_numpy(sample).cuda()], k + 2)
    nn_got = embedding_knn(yb, torch.from_numpy(yq).cuda(), k + 2)
    recall = float(np.mean([
        len(set(a[a != s][:k]) & set(b[b != s][:k])) / k
        for s, a, b in zip(sample, nn_fit, nn_got)]))
    med = float(np.median(drift)) / span
    p95 = float(np.quantile(drift, 0.95)) / span
    print(f"[serve] {tag}: self-transform of {len(sample)} base rows: "
          f"knn_recall@{k} {recall:.4f} (bar {SERVE_RECALL}), "
          f"drift_rel_median {med:.6f} (bar {SERVE_DRIFT_MEDIAN}), "
          f"drift_rel_p95 {p95:.6f} (bar {SERVE_DRIFT_P95}), span "
          f"{span:.3f}")
    check(recall >= SERVE_RECALL, f"[serve] {tag}: recall {recall}")
    check(med <= SERVE_DRIFT_MEDIAN, f"[serve] {tag}: drift median {med}")
    check(p95 <= SERVE_DRIFT_P95, f"[serve] {tag}: drift p95 {p95}")
    return yq


def serve_launches(tag, model, buckets, fn):
    """Run ``fn`` with the launches counted from 0 just before it and
    check them: B5 once an iteration a bucket, B2 too on the exact path
    (0 on the FFT field's), nothing else.  Returns (fn's result, counts)."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = launches()
    per = SERVE_ITERS * buckets
    # a float64 model serves through the float64 forms
    sfx = "_f64" if model.x.dtype == torch.float64 else ""
    want = {kid: 0 for kid in counts}
    want["B2" + sfx] = per if model.repulsion == "exact" else 0
    want["B5" + sfx] = per
    print(f"[serve] {tag}: launches {json.dumps(counts)}")
    check(counts == want, f"[serve] {tag}: launches {counts} != {want}")
    return out, counts


def serve_split(model, q):
    """ms of one bucket's knn / init / optimize stages (CUDA events, the
    median of 5 buckets after a warm one)."""
    import torch
    from tsne_flink_tpu_torch.serve.transform import stage_cache
    st = stage_cache(model, SERVE_BUCKET, SERVE_ITERS, SERVE_ETA)
    ms = {"knn": [], "init": [], "optimize": []}
    for rep in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        idx, dist = st.knn(q, model.x)
        ev[1].record()
        p, y0 = st.init(dist, idx, model.y)
        ev[2].record()
        st.optimize(y0, idx, p, model.y, model.field)
        ev[3].record()
        ev[3].synchronize()
        if rep:
            for i, name in enumerate(ms):
                ms[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: statistics.median(v) for k, v in ms.items()}, idx, p, y0


def serve_busy(model, q):
    """(device ms, launches, wall ms) of one bucket under torch.profiler:
    the kernels' summed device time against the bucket's CUDA-event time,
    or None when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tsne_flink_tpu_torch.serve.transform import stage_cache
    st = stage_cache(model, SERVE_BUCKET, SERVE_ITERS, SERVE_ETA)

    def bucket():
        idx, dist = st.knn(q, model.x)
        p, y0 = st.init(dist, idx, model.y)
        return st.optimize(y0, idx, p, model.y, model.field)
    bucket()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        bucket()
        b.record()
        b.synchronize()
    dev_us, kernels = 0.0, 0
    for ev in prof.events():  # device-side events: kernels and copies
        if str(ev.device_type).endswith("CUDA"):
            dev_us += ev.time_range.elapsed_us()
            kernels += 1
    if not kernels:
        return None
    return dev_us / 1e3, kernels, a.elapsed_time(b)


def serve_kernels(tag, model, idx, p, y0):
    """B5 (and B2 on the exact path) at the serving shapes — the bucket's
    query rows against the frozen base — against their plain versions
    (rtol 2e-5), two launches bit for bit, each timed beside its plain
    version and its bound.  Returns {kid: record}."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    yb = model.y
    n, m = yb.shape
    b, k = idx.shape
    got = att.attraction_forces(y0, yb, idx, p, 1.0)
    plain = att.attraction_forces_plain(y0, yb, idx, p, 1.0)
    # B5's forces are y_i·Σw − Σw·y_j: for a query among its neighbours
    # (p sums to 1 a row) terms of the size of |y| cancel to the distance
    # to them, so the absolute part of the tolerance is rtol x the size of
    # what is summed, max_i Σ_a p_ia (|y_i| + |y_j|) (w = p·q <= p)
    terms = float((p[..., None] * (y0.abs()[:, None, :]
                                   + yb[idx.long()].abs())).sum(1).max())
    err = torch.abs(got - plain)
    bad = int(torch.sum(err > 2e-5 * torch.abs(plain) + 2e-5 * terms))
    err5 = float(err.max())
    check(bad == 0, f"[serve] {tag} B5: {bad} elements beyond rtol 2e-5 "
          f"of their value + 2e-5 x {terms:.3f} (max abs err {err5:.3e})")
    f64 = att.attraction_forces_plain(y0.double(), yb.double(), idx,
                                      p.double(), 1.0)
    print(f"[serve] {tag}: B5 against float64: kernel "
          f"{float((got - f64).abs().max()):.3e}, plain "
          f"{float((plain - f64).abs().max()):.3e} (the forces' largest "
          f"{float(f64.abs().max()):.3e}, their summands' {terms:.3f})")
    check(torch.equal(got, att.attraction_forces(y0, yb, idx, p, 1.0)),
          f"[serve] {tag}: two B5 launches differ")
    nnz = int((p > 0).sum())
    out = {"B5": {"shape": f"[{b}, {k}] rows against [{n}, {m}]",
                  "max_abs_err": err5,
                  "ms": cuda_ms(lambda: att.attraction_forces(
                      y0, yb, idx, p, 1.0), 50),
                  "plain_ms": cuda_ms(lambda: att.attraction_forces_plain(
                      y0, yb, idx, p, 1.0), 20)}}
    # every value and index, the gathered rows, y read and forces written
    out["B5"].update(zip(("bound_ms", "bound_by"), bound(
        20.0 * nnz, b * k * 8 + nnz * m * 4 + 2 * b * m * 4)))
    if model.repulsion == "exact":
        r, z = cuda_exact_repulsion(y0, yb, row_offset=n, row_z=True)
        rp, zp = exact_repulsion(y0, yb, row_offset=n, row_z=True)
        err2 = max(rel_close(r, rp, 2e-5, f"[serve] {tag} B2 rep"),
                   rel_close(z, zp, 2e-5, f"[serve] {tag} B2 Z"))
        r2, z2 = cuda_exact_repulsion(y0, yb, row_offset=n, row_z=True)
        check(torch.equal(r, r2) and torch.equal(z, z2),
              f"[serve] {tag}: two B2 launches differ")
        out["B2"] = {"shape": f"[{b}, {m}] rows past [{n}, {m}]",
                     "max_abs_err": err2,
                     "ms": cuda_ms(lambda: cuda_exact_repulsion(
                         y0, yb, row_offset=n, row_z=True), 50),
                     "plain_ms": cuda_ms(lambda: exact_repulsion(
                         y0, yb, row_offset=n, row_z=True), 10)}
        out["B2"].update(zip(("bound_ms", "bound_by"), bound(
            20.0 * b * n, (n + b) * m * 4 + b * (m + 1) * 4)))
    for kid, rec in out.items():
        print(f"[serve] {tag}: {kid} at {rec['shape']}: {rec['ms']:.4f} ms "
              f"(plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.6f} ms by {rec['bound_by']}), max abs err "
              f"{rec['max_abs_err']:.3e}")
    return out


def serve_model(tag, model, rng):
    """[serve] for one frozen model: quality, launches, the bucket split,
    B2/B5 at the serving shapes, batch-split bit identity and peak
    memory.  Returns (B2/B5 records, launches of the self-transform)."""
    import torch
    from tsne_flink_tpu_torch.serve.transform import transform
    n = model.n
    sample = rng.choice(n, SERVE_SAMPLE, replace=False)
    # the first bucket builds nothing (the kernels are built): warm anyway
    transform(model, model.x[:1].cpu().numpy(), bucket=SERVE_BUCKET,
              iters=SERVE_ITERS, eta=SERVE_ETA)
    _, counts = serve_launches(f"{tag} self-transform", model, 1,
                               lambda: serve_quality(tag, model, sample))
    q = model.x[torch.from_numpy(sample).cuda()]
    split, idx, p, y0 = serve_split(model, q)
    whole = sum(split.values())
    print(f"[serve] {tag}: one bucket of {SERVE_BUCKET} rows, "
          f"{SERVE_ITERS} iterations: {whole:.4f} ms (knn "
          f"{split['knn']:.4f}, init {split['init']:.4f}, optimize "
          f"{split['optimize']:.4f}: {split['optimize'] / SERVE_ITERS:.4f} "
          f"an iteration); {SERVE_BUCKET / whole * 1e3:.0f} rows/s")
    busy = serve_busy(model, q)
    if busy is None:
        print(f"[serve] {tag}: device busy share not measured (the "
              "profiler saw no device time)")
    else:
        dev, kernels, wall = busy
        print(f"[serve] {tag}: under torch.profiler one bucket runs "
              f"{kernels} device operations, {dev:.4f} ms of device time "
              f"in {wall:.4f} ms: the device idles {1 - dev / wall:.1%}")
    recs = serve_kernels(tag, model, idx, p, y0)
    # 1,024 new rows: base rows moved off the base by noise
    pick = rng.choice(n, SERVE_SPLIT, replace=False)
    xq = model.x[torch.from_numpy(pick).cuda()].cpu().numpy()
    xq = xq + 0.1 * np.std(xq) * rng.standard_normal(xq.shape).astype(
        xq.dtype)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole_y, _ = serve_launches(
        f"{tag} 1 x {SERVE_SPLIT}", model, SERVE_SPLIT // SERVE_BUCKET,
        lambda: transform(model, xq, bucket=SERVE_BUCKET, iters=SERVE_ITERS,
                          eta=SERVE_ETA))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    pred = model.transform_peak(SERVE_BUCKET)
    resident = sum(t.numel() * t.element_size() for t in (
        model.x, model.y, *((model.field.pot,) if model.field else ())))
    measured = resident + peak
    print(f"[serve] {tag}: {SERVE_SPLIT} rows in {wall:.4f} s "
          f"({SERVE_SPLIT / wall:.0f} rows/s, host clock); peak memory "
          f"above the resident model {peak / 2**20:.1f} MiB, with the "
          f"model ({resident / 2**20:.1f} MiB) {measured / 2**20:.1f} MiB; "
          f"transform_peak predicts {pred / 2**20:.1f} MiB "
          f"(ratio {pred / measured:.3f})")
    # fault C3: the admission unit must cover what a bucket holds
    check(measured <= pred <= 2 * measured,
          f"[serve] {tag}: transform_peak {pred} outside [measured "
          f"{measured}, 2 x measured]")
    recs["memory"] = [(tag, pred, measured)]
    for parts in (4, 16):
        size = SERVE_SPLIT // parts
        got, _ = serve_launches(
            f"{tag} {parts} x {size}", model, parts,
            lambda: np.concatenate([transform(
                model, xq[s:s + size], bucket=SERVE_BUCKET,
                iters=SERVE_ITERS, eta=SERVE_ETA)
                for s in range(0, SERVE_SPLIT, size)]))
        check(same_bits(got, whole_y), f"[serve] {tag}: {parts} x {size} "
              f"differs from 1 x {SERVE_SPLIT}")
    print(f"[serve] {tag}: 1 x {SERVE_SPLIT}, 4 x {SERVE_SPLIT // 4} and "
          f"16 x {SERVE_SPLIT // 16} give the same bits")
    return recs, counts


def serve_daemon(model, tmp, rng):
    """A scheduled ServeDaemon over a spool of 8 requests of 64 / 256 /
    1,024 rows: rows/s, p50/p99, batch fill; every answer equal bit for
    bit to a direct transform."""
    from tsne_flink_tpu_torch.serve.daemon import (ServeDaemon, read_result,
                                                   submit)
    from tsne_flink_tpu_torch.serve.transform import transform
    spool = os.path.join(tmp, "spool")
    os.makedirs(spool)
    reqs = {}
    for i, rows in enumerate(SERVE_DAEMON_ROWS):
        pick = rng.choice(model.n, rows, replace=False)
        reqs[f"r{i}"] = model.x[pick].cpu().numpy()
        submit(spool, reqs[f"r{i}"], f"r{i}")
    d = ServeDaemon(model, spool, bucket=SERVE_BUCKET, iters=SERVE_ITERS,
                    eta=SERVE_ETA, tick_s=0.001, sched="on",
                    idle_exit_s=0.2)
    t0 = time.perf_counter()
    summary = d.serve_forever()
    wall = time.perf_counter() - t0 - 0.2  # less the idle exit
    rows = sum(SERVE_DAEMON_ROWS)
    check(summary["served"] == len(reqs) and summary["failed"] == 0,
          f"[serve] daemon: {summary['served']} served")
    for rid, q in reqs.items():
        check(same_bits(read_result(spool, rid), transform(
            model, q, bucket=SERVE_BUCKET, iters=SERVE_ITERS,
            eta=SERVE_ETA)), f"[serve] daemon: {rid} differs from a "
            "direct transform")
    print(f"[serve] daemon (sched on, bucket {SERVE_BUCKET}): "
          f"{len(reqs)} requests, {rows} rows in {wall:.4f} s: "
          f"{rows / wall:.0f} rows/s; p50 {summary['p50_ms']} ms, p99 "
          f"{summary['p99_ms']} ms (from the spool's first scan); "
          f"{summary['batches']} batches, fill {summary['batch_fill_mean']}"
          "; every answer equals a direct transform bit for bit")
    return {"rows_s": rows / wall, "p50_ms": summary["p50_ms"],
            "p99_ms": summary["p99_ms"]}


def phase_serve(x_np, ckpt_path, large, xc_np, tmp):
    """Out-of-sample serving on both model scales: [project]'s run opened
    from its fat checkpoint (60,000 x 784, exact: B2 and B5), [large]'s
    as arrays (1,306,127 x 50, fft: B5 and the field's gather), then a
    scheduled daemon on the 60k model.  Returns the B2 and B5 records at
    the serving shapes and the self-transforms' launches."""
    import torch
    from tsne_flink_tpu_torch.serve.model import (PlanConfig, from_arrays,
                                                  load_frozen)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    exact = load_frozen(ckpt_path, x_np, PlanConfig(
        n=N_FULL, d=F_FULL, k=K, backend="cuda", name="project"),
        perplexity=PERPLEXITY)
    torch.cuda.synchronize()
    print(f"[serve] 60k model {exact.model_id} ({exact.repulsion}) opened "
          f"from the fat checkpoint in {time.perf_counter() - t0:.3f} s")
    check(exact.repulsion == "exact", "[serve] the 60k model is not exact")
    recs, counts = serve_model("60k exact", exact, rng)
    recs["daemon"] = serve_daemon(exact, tmp, rng)
    del exact
    # the same checkpoint as a float64 model: its own dtype on the card
    exact64 = load_frozen(ckpt_path, x_np, PlanConfig(
        n=N_FULL, d=F_FULL, k=K, backend="cuda", dtype="float64",
        name="project-f64"), perplexity=PERPLEXITY, dtype=torch.float64)
    check(exact64.x.dtype == exact64.y.dtype == torch.float64,
          "[serve] the float64 model is not float64 on the card")
    recs64, counts64 = serve_model("60k exact f64", exact64,
                                   np.random.default_rng(64))
    recs["B2_f64"], recs["B5_f64"] = recs64["B2"], recs64["B5"]
    recs["memory"] += recs64["memory"]
    del exact64
    t0 = time.perf_counter()
    fft = from_arrays(xc_np, large[0].cpu().numpy(), PlanConfig(
        n=N_CELLS, d=F_CELLS, k=K_CELLS, backend="cuda", name="large"),
        perplexity=PERPLEXITY_CELLS)
    torch.cuda.synchronize()
    print(f"[serve] 1.3M model {fft.model_id} ({fft.repulsion}) built in "
          f"{time.perf_counter() - t0:.3f} s (the base field: grid "
          f"{fft.field.grid}, spacing {float(fft.field.h):.5f})")
    check(fft.repulsion == "fft", "[serve] the 1.3M model is not fft")
    recs_l, counts_l = serve_model("1.3M fft", fft, rng)
    recs["B5_large"] = recs_l["B5"]
    recs["memory"] += recs_l["memory"]
    return recs, {kid: counts[kid] + counts_l[kid] + counts64[kid]
                  for kid in counts}


#: [quorum]: replicated serving on the 60k model — each replica's claim
#: horizon (16 x max_batch rows: two buckets, so the replicas share a
#: backlog), the hung triage's heartbeat bound, the watchdog case's stage
#: timeout and the delay past it, the idle exit that lets both replicas of
#: the clean case start before its requests land, and every fleet's
#: deadline
QUORUM_MAX_BATCH = 32
QUORUM_STALE_MS = 3000.0
QUORUM_STAGE_TIMEOUT_S, QUORUM_DELAY_S = 4.0, 8.0
QUORUM_IDLE_CLEAN_S, QUORUM_RUN_S = 4.0, 240.0
#: [quorum] 5: the shed case's bulk (past one bucket) and express
#: requests (rows)
QUORUM_SHED = {"b0": 1024, "b1": 1024, "b2": 1024, "e0": 64, "e1": 256}


def quorum_spec(tag, tmp, ckpt_path, x_path, replicas, *, serve=None,
                **kw):
    """A ServeFleetSpec of ``replicas`` daemons of the 60k exact model (the
    checkpoint [project] wrote, its base features as .npy) at the serving
    defaults, over a spool of its own."""
    from tsne_flink_tpu_torch.runtime.fleet import ServeFleetSpec
    template = {"model": ckpt_path, "input": x_path,
                "perplexity": PERPLEXITY, "neighbors": K,
                "bucket": SERVE_BUCKET, "iters": SERVE_ITERS,
                "eta": SERVE_ETA, "tick_s": 0.001, "poll_max_ms": 200.0,
                "idle_exit_s": 0.5, "max_batch": QUORUM_MAX_BATCH,
                **(serve or {})}
    spool = os.path.join(tmp, f"quorum_{tag}_spool")
    os.makedirs(spool)
    kw.setdefault("stale_ms", 60_000.0)
    return ServeFleetSpec(name=tag, spool=spool,
                          workdir=os.path.join(tmp, f"quorum_{tag}"),
                          serve=template, replicas=replicas,
                          run_s=QUORUM_RUN_S, backoff_base=0.05,
                          backoff_cap=0.5, **kw)


def quorum_thread(spec, out):
    """Run the fleet's supervisor in a thread of this process (it is
    process and file plumbing); its record, or its error, lands in
    ``out``."""
    import threading
    from tsne_flink_tpu_torch.runtime.fleet import run_serve_fleet

    def target():
        try:
            out[spec.name] = run_serve_fleet(spec)
        except BaseException as e:  # re-raised by quorum_join
            out[spec.name] = e
    th = threading.Thread(target=target, name=f"quorum-{spec.name}")
    th.start()
    return th


def quorum_join(th, spec, out):
    th.join(QUORUM_RUN_S + 60.0)
    check(not th.is_alive(), f"[quorum] {spec.name}: the supervisor did not "
          "return")
    rec = out[spec.name]
    if isinstance(rec, BaseException):
        raise SmokeFailure(f"[quorum] {spec.name}: {rec!r}")
    check(not rec["deadline_hit"], f"[quorum] {spec.name}: deadline hit; "
          f"events {json.dumps(rec['events'])[-3000:]}")
    return rec


def quorum_answers(tag, spec, want, extra=()):
    """Every request of ``want`` has exactly one terminal, bit for bit the
    smoke process's transform, and the spool holds terminals only (no
    torn or epoch-tagged tmp, no lock, no sidecar, no beat)."""
    from tsne_flink_tpu_torch.serve.daemon import read_result
    for rid, y in want.items():
        check(same_bits(read_result(spec.spool, rid), y),
              f"[quorum] {tag}: {rid} differs from this process's "
              "transform")
    names = sorted(os.listdir(spec.spool))
    expect = sorted([f"{rid}{suf}" for rid in want
                     for suf in (".lat.json", ".res.npz")] + list(extra))
    check(names == expect, f"[quorum] {tag}: the spool holds {names}")


def quorum_lat(spec, rid):
    with open(os.path.join(spec.spool, rid + ".lat.json")) as f:
        return json.load(f)


def quorum_startup(rec):
    """Each replica attempt's start-up seconds: spawn to warm (its model
    loaded and one bucket run)."""
    spawns = {}
    for e in rec["events"]:
        if e["event"] == "spawn":
            spawns.setdefault(e["replica"], []).append(e["t"])
    out = {}
    for name, sub in rec["replica_records"].items():
        if sub and sub.get("t_warm"):
            out[name] = sub["t_warm"] - max(t for t in spawns[name]
                                            if t <= sub["t_warm"])
    return out


def quorum_submit(spec, queries):
    from tsne_flink_tpu_torch.serve.daemon import submit
    for rid, q in queries.items():
        submit(spec.spool, q, rid)


def quorum_clean(ckpt_path, x_path, tmp, queries, want, solo,
                 cold_build=False):
    """[quorum] 1: two replicas; the requests land once both are warm, so
    the wall from submission to the last result is the fleet's serving
    alone.  Returns the replicas' records."""
    from tsne_flink_tpu_torch.kernels import build as kbuild
    from tsne_flink_tpu_torch.serve import replicas as quorum
    if cold_build:
        import shutil
        shutil.rmtree(kbuild.BUILD_DIR, ignore_errors=True)
        print(f"[quorum] {kbuild.BUILD_DIR} removed: the replicas build "
              "the kernel library themselves, under its cross-process lock")
    out = {}
    clean = quorum_spec("clean", tmp, ckpt_path, x_path, 2,
                        serve={"idle_exit_s": QUORUM_IDLE_CLEAN_S})
    th = quorum_thread(clean, out)
    names = [f"clean-r{i}" for i in range(2)]
    t_wait = time.time()
    while not all(quorum.read_beat(clean.spool, n) for n in names):
        check(th.is_alive() and time.time() - t_wait < QUORUM_RUN_S,
              f"[quorum] clean: the replicas did not start; "
              f"{json.dumps(out.get('clean'), default=repr)[-3000:]}")
        time.sleep(0.005)
    t0 = time.time()
    quorum_submit(clean, queries)
    res = [os.path.join(clean.spool, rid + ".res.npz") for rid in queries]
    while not all(os.path.exists(p) for p in res):
        check(th.is_alive(), "[quorum] clean: the fleet ended early")
        time.sleep(0.001)
    wall = time.time() - t0
    rec = quorum_join(th, clean, out)
    quorum_answers("clean", clean, want)
    subs = rec["replica_records"]
    check(all(sub and sub["status"] == "ok" for sub in subs.values())
          and rec["relaunches"] == 0 and rec["redispatched"] == [],
          f"[quorum] clean: {json.dumps(rec)[-3000:]}")
    rows = sum(len(q) for q in queries.values())
    lat = sorted(quorum_lat(clean, rid)["seconds"] for rid in queries)
    p50 = lat[int(round(0.5 * (len(lat) - 1)))] * 1e3
    p99 = lat[int(round(0.99 * (len(lat) - 1)))] * 1e3
    served = {n: sub["served"] for n, sub in subs.items()}
    startup = quorum_startup(rec)
    print(f"[quorum] clean: 2 replicas, {len(queries)} requests, {rows} "
          f"rows in {wall:.4f} s from submission to the last result: "
          f"{rows / wall:.0f} rows/s (the in-process daemon of [serve], "
          f"this run: {solo['rows_s']:.0f} rows/s); p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms from claim to result ([serve]: {solo['p50_ms']} / "
          f"{solo['p99_ms']} ms); requests served a replica {served}; "
          "start-up (spawn to warm) "
          + ", ".join(f"{n} {s:.3f} s" for n, s in startup.items())
          + "; kernel library " + ", ".join(
              f"{n} {sub['kernel_cache']}" for n, sub in subs.items())
          + "; every answer equals this process's transform bit for bit")
    for n, sub in subs.items():
        launches, b = sub["launches"], sub["batches"]
        check(b > 0 and launches["B5"] == SERVE_ITERS * b
              and launches["B2"] == SERVE_ITERS * b
              and sum(launches.values()) == 2 * SERVE_ITERS * b,
              f"[quorum] clean {n}: launches {launches} over {b} buckets")
        print(f"[quorum] clean {n}: {b} buckets, launches {launches}: B2 "
              f"{launches['B2'] // b} and B5 {launches['B5'] // b} a bucket")
    return subs


def quorum_memory(subs, context, total):
    """[quorum] 6: each replica's footprint (peak reserved + the measured
    context) against the gate's charge (transform_peak with its reserve,
    and the context once), within [1, 2]."""
    feet = 0
    for n, sub in subs.items():
        mem, adm = sub["memory"], sub["admission"]
        foot = mem["peak_reserved"] + context
        feet += foot
        ratio = adm["charged_bytes"] / foot
        print(f"[quorum] memory {n}: peak allocated "
              f"{mem['peak_allocated'] / 2**20:.1f} MiB, reserved "
              f"{mem['peak_reserved'] / 2**20:.1f} MiB, + context "
              f"{context / 2**20:.1f} MiB = footprint {foot / 2**20:.1f} "
              f"MiB; the gate charges {adm['charged_bytes'] / 2**20:.1f} MiB "
              f"(transform_peak {adm['peak_bytes'] / 2**20:.1f} MiB, its "
              f"reserve and the context): {ratio:.3f} x the footprint")
        check(1.0 <= ratio <= 2.0, f"[quorum] memory {n}: the charge is "
              f"{ratio:.3f} x the footprint, outside [1, 2]")
    print(f"[quorum] memory: {len(subs)} replicas hold "
          f"{feet / 2**30:.3f} GiB of the card's {total / 2**30:.3f} GiB")


def quorum_chaos_start(ckpt_path, x_path, tmp, queries, shed_q):
    """Start [quorum] 2-5 at once, each fleet over a spool of its own, its
    supervisor in a thread of this process: both replicas killed at their
    first request's boundary; one replica hung at its second tick; one
    ended by its watchdog; bulk shed before express.  Returns the job for
    :func:`quorum_chaos`."""
    out = {}
    kill = quorum_spec("kill", tmp, ckpt_path, x_path, 2, fault_plans={
        "0": "kill@serve:seg0", "1": "kill@serve:seg0"})
    hang = quorum_spec("hang", tmp, ckpt_path, x_path, 1,
                       fault_plans={"0": "hang@serve:2"},
                       stale_ms=QUORUM_STALE_MS)
    dog = quorum_spec("watchdog", tmp, ckpt_path, x_path, 1,
                      fault_plans={"0": "delay@serve:2"},
                      serve={"stage_timeout": QUORUM_STAGE_TIMEOUT_S,
                             "fault_delay_s": QUORUM_DELAY_S})
    shed = quorum_spec("shed", tmp, ckpt_path, x_path, 1, shed_depth=1)
    for spec in (kill, hang, dog):
        quorum_submit(spec, queries)
    quorum_submit(shed, shed_q)
    t0 = time.perf_counter()
    threads = [(quorum_thread(spec, out), spec)
               for spec in (kill, hang, dog, shed)]
    return out, threads, t0, (kill, hang, dog, shed)


def quorum_chaos(job, want, shed_q, want_e):
    """[quorum] 2-5: wait for :func:`quorum_chaos_start`'s fleets, then
    check each."""
    out, threads, t0, (kill, hang, dog, shed) = job
    recs = {spec.name: quorum_join(th, spec, out) for th, spec in threads}
    print(f"[quorum] kill, hang, watchdog and shed fleets at once (beside "
          f"the clean fleet): {time.perf_counter() - t0:.1f} s")

    rec = recs["kill"]
    quorum_answers("kill", kill, want)
    exits = [e for e in rec["events"] if e["event"] == "exit"]
    epochs = {rid: quorum_lat(kill, rid)["epoch"]
              for rid in rec["redispatched"]}
    check(rec["redispatched"] and all(e >= 2 for e in epochs.values())
          and rec["relaunches"] >= 1
          and any(e["rc"] == -9 for e in exits)
          and all(sub and sub["status"] == "ok"
                  for sub in rec["replica_records"].values()),
          f"[quorum] kill: {json.dumps(rec)[-3000:]}")
    delays = [e["delay_ms"] for e in rec["events"]
              if e["event"] == "relaunch-scheduled"]
    print(f"[quorum] kill: exits {[e['rc'] for e in exits]}, "
          f"re-dispatched {epochs} (epoch on the .lat.json), relaunches "
          f"{rec['relaunches']} after backoffs {delays} ms, relaunched "
          f"start-up {json.dumps(quorum_startup(rec))} s; every request one "
          "terminal, bit for bit")

    rec = recs["hang"]
    quorum_answers("hang", hang, want)
    hung = [e for e in rec["events"] if e["event"] == "sigkill-hung"]
    sub = rec["replica_records"]["hang-r0"]
    check(len(hung) == 1 and rec["sigkills"] == 1 and rec["redispatched"]
          and sub and sub["status"] == "ok" and sub["redispatched"] >= 1,
          f"[quorum] hang: {json.dumps(rec)[-3000:]}")
    print(f"[quorum] hang: sigkill-hung at a beat age of "
          f"{hung[0]['beat_age_ms']} ms (stale bound {QUORUM_STALE_MS} "
          f"ms), re-dispatched {rec['redispatched']}, attempts "
          f"{rec['attempts']}; every request one terminal, bit for bit")

    rec = recs["watchdog"]
    quorum_answers("watchdog", dog, want)
    exits = [e["rc"] for e in rec["events"] if e["event"] == "exit"]
    check(exits == [124, 0] and rec["sigkills"] == 0
          and rec["replica_records"]["watchdog-r0"]["status"] == "ok",
          f"[quorum] watchdog: {json.dumps(rec)[-3000:]}")
    print(f"[quorum] watchdog: delay@serve:2 ({QUORUM_DELAY_S} s) past the "
          f"stage timeout ({QUORUM_STAGE_TIMEOUT_S} s): exits {exits}, "
          f"re-dispatched {rec['redispatched']}, relaunched clean; no torn "
          "result, every request one terminal, bit for bit")

    rec = recs["shed"]
    bulk = [rid for rid in shed_q if rid not in want_e]
    quorum_answers("shed", shed, want_e,
                   extra=[rid + ".err.json" for rid in bulk])
    errs = {}
    for rid in bulk:
        with open(os.path.join(shed.spool, rid + ".err.json")) as f:
            errs[rid] = json.load(f)
    sub = rec["replica_records"]["shed-r0"]
    check(all(e["shed"] is True and e["retry_after_ms"] > 0
              for e in errs.values())
          and sub["shed"] == len(bulk) and sub["served"] == len(want_e),
          f"[quorum] shed: {errs}, {json.dumps(sub)[-2000:]}")
    print(f"[quorum] shed: depth 1, bulk refused with retry_after_ms "
          f"{[e['retry_after_ms'] for e in errs.values()]}, express served "
          "bit for bit")


def phase_quorum(x_np, ckpt_path, tmp, solo, cold_build=False):
    """[quorum]: N ``--serve`` replica processes over one spool on the
    card, on the 60k exact model [project] wrote (queue A13b); every
    answer held bit for bit to this process's own transform.  Returns the
    CUDA context measured here (``runtime_context``), which [runtime]
    reuses."""
    import torch
    from tsne_flink_tpu_torch.serve.model import PlanConfig, load_frozen
    from tsne_flink_tpu_torch.serve.transform import transform
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    x_path = os.path.join(tmp, "quorum_x.npy")
    np.save(x_path, x_np)
    model = load_frozen(ckpt_path, x_np, PlanConfig(
        n=N_FULL, d=F_FULL, k=K, backend="cuda", name="quorum"),
        perplexity=PERPLEXITY)
    rng = np.random.default_rng(12)
    n = x_np.shape[0]
    queries = {f"q{i}": x_np[rng.choice(n, rows, replace=False)]
               for i, rows in enumerate(SERVE_DAEMON_ROWS)}
    shed_q = {rid: x_np[rng.choice(n, rows, replace=False)]
              for rid, rows in QUORUM_SHED.items()}

    def direct(q):
        return transform(model, q, bucket=SERVE_BUCKET, iters=SERVE_ITERS,
                         eta=SERVE_ETA)
    want = {rid: direct(q) for rid, q in queries.items()}
    want_e = {rid: direct(q) for rid, q in shed_q.items()
              if len(q) <= SERVE_BUCKET}
    del model
    torch.cuda.empty_cache()
    # the context is probed while no replica holds the card; then the
    # chaos fleets run beside the clean one
    context = runtime_context()
    chaos = None
    if not cold_build:
        chaos = quorum_chaos_start(ckpt_path, x_path, tmp, queries, shed_q)
    subs = quorum_clean(ckpt_path, x_path, tmp, queries, want, solo,
                        cold_build)
    quorum_memory(subs, context,
                  torch.cuda.get_device_properties(0).total_memory)
    if chaos is None:
        chaos = quorum_chaos_start(ckpt_path, x_path, tmp, queries, shed_q)
    quorum_chaos(chaos, want, shed_q, want_e)
    print(f"[quorum] phase {time.perf_counter() - t_phase:.1f} s")
    return context


def phase_determinism(x_np, xl_np):
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    for name, data, attraction in (("CSR", x_np, "csr"),
                                   ("rows", xl_np, "rows")):
        cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                         attraction=attraction)
        stats = [{}, {}]
        runs = [tsne_embed(data[:N_DETERMINISM], cfg, neighbors=K, seed=0,
                           stats=st) for st in stats]
        check(stats[0]["layout"] == attraction,
              f"[determinism] {name} ran {stats[0]['layout']}")
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"[determinism] {name} N={N_DETERMINISM} two runs "
              f"bit-identical: {same}")
        check(same, f"two {name} runs at N={N_DETERMINISM} differ")
    # the large-N path: hybrid kNN (two refine cycles, so B6 runs) + FFT
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="fft")
    reset_launches()
    runs = [tsne_embed(x_np[:N_DETERMINISM], cfg, neighbors=K, seed=0,
                       knn_method="project", knn_refine=2)
            for _ in range(2)]
    b6 = launches()["B6"]
    check(b6 > 0, "[determinism] project + FFT: B6 never launched")
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[determinism] project + FFT N={N_DETERMINISM} (B6 x{b6}) two "
          f"runs bit-identical: {same}")
    check(same, f"two project + FFT runs at N={N_DETERMINISM} differ")
    # the autopilot (with the landmark schedule) and Barnes-Hut
    for name, cfg, kw in (
            ("autopilot + landmark",
             TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                        autopilot=True), {"landmark": "on"}),
            ("Barnes-Hut theta 0.5",
             TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                        repulsion="bh", theta=0.5), {})):
        reset_launches()
        runs = [tsne_embed(x_np[:N_DETERMINISM], cfg, neighbors=K, seed=0,
                           **kw) for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"[determinism] {name} N={N_DETERMINISM} two runs "
              f"bit-identical: {same} (launches {json.dumps(launches())})")
        check(same, f"two {name} runs at N={N_DETERMINISM} differ")


#: the Barnes-Hut error bars at theta = 0.5, vdm gate (tests/test_bh.py:167
#: and :192): max |rep - exact| / max |exact| and |Z - Z_exact| / Z_exact
BH_FORCE_BAR, BH_Z_BAR = 2.5e-2, 1e-2
#: rows of the large shape on which BH's error is measured
BH_SAMPLE = 256
#: the autopilot guardrail's shape (bench.py make_data, seed 0)
N_GUARDRAIL = 10_000


@contextlib.contextmanager
def record_plan():
    """Keep the (edges, csr) the run's plan stage returns (the list
    yielded gets them); the stage itself runs unchanged."""
    from tsne_flink_tpu_torch.models import tsne as ttsne
    real = ttsne._plan_layout
    got = []

    def recorded(*a, **kw):
        out = real(*a, **kw)
        got[:] = out
        return out

    ttsne._plan_layout = recorded
    try:
        yield got
    finally:
        ttsne._plan_layout = real


def bh_errors(rep, z, rep_e, z_e):
    """(max row error / max exact row norm, relative Z error)."""
    import torch
    den = float(torch.linalg.norm(rep_e.double(), dim=1).max())
    err = float(torch.linalg.norm((rep - rep_e).double(), dim=1).max())
    return err / den, abs(float(z) - float(z_e)) / float(z_e)


def bh_hold(tag, y, theta, gate="vdm", gated=False):
    """BH at ``y`` against B2: errors, levels, frontier, two calls bit for
    bit, the median of 3 CUDA-event calls, the peak memory a call adds.
    Returns (ms, force error, Z error)."""
    import torch
    from tsne_flink_tpu_torch.ops import repulsion_bh as bh
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    n, m = y.shape
    rep_e, z_e = cuda_exact_repulsion(y)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r1, z1 = bh.bh_repulsion(y, theta=theta, gate=gate)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    r2, z2 = bh.bh_repulsion(y, theta=theta, gate=gate)
    same = torch.equal(r1, r2) and torch.equal(z1, z2)
    err, zerr = bh_errors(r1, z1, rep_e, z_e)
    ms = statistics.median(cuda_ms(lambda: bh.bh_repulsion(
        y, theta=theta, gate=gate), 1, 0) for _ in range(3))
    levels = bh.default_levels(n, m)
    front = bh.default_frontier(n, m, levels, theta)
    print(f"[bh] {tag} {n}x{m} theta={theta} gate={gate}: levels {levels}, "
          f"frontier {front}; max force error {err:.4e} of max |rep|, Z "
          f"error {zerr:.4e}; {ms:.3f} ms a call (median of 3; B2 "
          f"{cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 3):.3f} "
          f"ms); +{peak / 2**30:.3f} GiB peak; two calls bit-identical: "
          f"{same}")
    check(same, f"[bh] {tag} theta={theta} {gate}: two calls differ")
    if gated:
        check(err < BH_FORCE_BAR and zerr < BH_Z_BAR,
              f"[bh] {tag} theta={theta}: force error {err} (bar "
              f"{BH_FORCE_BAR}), Z error {zerr} (bar {BH_Z_BAR})")
    return ms, err, zerr


def phase_bh(x_np, labels, y_60k, z_latent, project):
    """Barnes-Hut on the card: held against B2 at [full]'s final y (θ =
    0.5 and 0.25, vdm; 0.5 flink) and at m = 3 on the latent blobs' 3-D
    latent (θ = 0.25), then config 2 as BASELINE names it, end to end.
    Returns the config 2 run's final y."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops import repulsion_bh as bh

    bh_hold("[full]'s final y", y_60k, 0.5, gated=True)
    bh_hold("[full]'s final y", y_60k, 0.25, gated=True)
    bh_hold("[full]'s final y", y_60k, 0.5, gate="flink")
    z3 = torch.from_numpy(z_latent.astype(np.float32)).cuda()
    bh_hold("the latent blobs' 3-D latent", z3, 0.25, gated=True)
    del z3
    # config 2 as BASELINE.json names it: theta 0.5 Barnes-Hut, project
    y_p, _, _, kl_p = project
    n, d = x_np.shape
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    cycles = pick_knn_refine(n, d)
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="bh", theta=0.5)
    with record_plan() as plan:
        y, losses, stats, counts = run_embed(
            "bh", x_np, cfg,
            lambda st: layout_launches(st["layout"], b1=0, b2=0,
                                       b6=b6_launches(n, d, K, cycles)),
            knn_method="project")
    kl = quality("bh", y, losses, labels, cfg, 0.9)
    print(f"[bh] config 2 final KL {kl:.6f} vs [project]'s {kl_p:.6f} (the "
          f"same P, exact repulsion): gap {kl - kl_p:+.6f} (bar "
          f"{KL_GUARDRAIL_TOL}); B2 launches {counts['B2']}")
    check(abs(kl - kl_p) <= KL_GUARDRAIL_TOL,
          f"[bh] config 2 final KL {kl} vs [project] {kl_p}")
    check(counts["B2"] == 0, f"[bh] B2 launched {counts['B2']} times")
    # the iteration split at the run's final y
    _, csr = plan
    check(csr is not None, "[bh] config 2 did not take the CSR layout")
    fidx, fval, rag = (csr[0], csr[1],
                       att.ragged_edges(*_unpadded(csr[2:]), n))
    order = att.visit_order(rag)
    rep, z = bh.bh_repulsion(y, theta=0.5)
    t_bh = statistics.median(cuda_ms(lambda: bh.bh_repulsion(y, theta=0.5),
                                     1, 0) for _ in range(3))
    upd, gains = torch.zeros_like(y), torch.ones_like(y)
    t_b3 = cuda_ms(lambda: att.fused_step_update(
        y, y, fidx, fval, 1.0, rep, z, None, upd, gains, 0.8, eta=1000.0,
        min_gain=0.01, ragged=rag, order=order), 20)
    t_b4 = cuda_ms(lambda: att.attraction_loss(y, y, fidx, fval, 1.0, z,
                                               ragged=rag), 20)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    rest = it_ms - t_bh - t_b3 - t_b4 / 10
    print(f"[bh] config 2 per iteration {it_ms:.4f} ms: BH {t_bh:.4f} "
          f"({100 * t_bh / it_ms:.1f}%), B3 {t_b3:.4f} x{counts['B3']}, "
          f"B4/10 {t_b4 / 10:.4f}, the rest {rest:.4f} (by difference)")
    del plan[:], fidx, fval, rag, order
    torch.cuda.empty_cache()
    return y


def _unpadded(edges):
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    return _without_padding(edges)


def phase_bh_large(y_large):
    """One BH call at [large]'s final y (θ = 0.5), timed, its error on
    ``BH_SAMPLE`` rows against B2 over those rows and the whole y (the
    rows put first, so B2's self-exclusion is by position)."""
    import torch
    from tsne_flink_tpu_torch.ops import repulsion_bh as bh
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    n, m = y_large.shape
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rep, z = bh.bh_repulsion(y_large, theta=0.5)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    ms = statistics.median(cuda_ms(lambda: bh.bh_repulsion(
        y_large, theta=0.5), 1, 0) for _ in range(3))
    rng = np.random.default_rng(0)
    pick = torch.from_numpy(rng.choice(n, BH_SAMPLE, replace=False)).cuda()
    rest = torch.ones(n, dtype=torch.bool, device=y_large.device)
    rest[pick] = False
    y_perm = torch.cat([y_large[pick], y_large[rest]]).contiguous()
    rep_e, _ = cuda_exact_repulsion(y_perm[:BH_SAMPLE], y_perm)
    err, _ = bh_errors(rep[pick], torch.ones(()), rep_e, torch.ones(()))
    levels = bh.default_levels(n, m)
    print(f"[bh] [large]'s final y {n}x{m} theta=0.5: levels {levels}, "
          f"frontier {bh.default_frontier(n, m, levels, 0.5)}; {ms:.3f} ms a "
          f"call (median of 3), +{peak / 2**30:.3f} GiB peak; max force "
          f"error on {BH_SAMPLE} rows {err:.4e} (bar {BH_FORCE_BAR})")
    check(err < BH_FORCE_BAR, f"[bh] large: force error {err}")
    return ms


def pilot_run(tag, x_np, cfg, **kw):
    """One ``tsne_embed`` under the autopilot: seconds, host reads,
    refreshes, transitions.  Returns (y, losses, stats)."""
    import torch
    from tsne_flink_tpu_torch import tsne_embed
    from tsne_flink_tpu_torch.models import autopilot as ap
    stats = {}
    torch.cuda.synchronize()
    ap.reset_host_reads()
    t0 = time.perf_counter()
    y, losses = tsne_embed(x_np, cfg, seed=0, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = ap.host_reads()
    pol = stats.get("policy", {})
    refreshes = sum(int(p[0][2]) for p in stats.get("pilots", {}).values())
    print(f"[pilot] {tag}: {wall:.3f} s end to end (optimize "
          f"{stats['optimize']:.4f} s), layout {stats['layout']}, landmark "
          f"{pol.get('landmark')} ({pol.get('n_landmark')} rows, "
          f"{pol.get('landmark_iters')} + {pol.get('polish_iters')} "
          f"iterations), repulsion refreshes {refreshes}, host reads "
          f"{reads}; transitions {json.dumps(pol.get('transitions'))}")
    check(reads <= ITERATIONS // 10,
          f"[pilot] {tag}: {reads} host reads > one a report boundary")
    return y, losses, stats


def phase_pilot(xl_np, labels_l, z_latent, rows_stats, large):
    """The autopilot on the card: the guardrail the JAX package pins (10k
    blobs, exact, off against on with the landmark schedule), the latent
    blobs as [rows] ran them, and [large]'s P and init through optimize
    (the FFT stride and grid ladder)."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.models import autopilot as ap
    from tsne_flink_tpu_torch.models.tsne import (init_working_set,
                                                  optimize)

    x10, _ = make_data(n=N_GUARDRAIL)
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS)
    stats = {}
    t0 = time.perf_counter()
    _, loss_off = tsne_embed(x10, cfg, neighbors=K, seed=0, stats=stats)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    _, loss_on, st_on = pilot_run(
        f"guardrail {N_GUARDRAIL} blobs, landmark on", x10,
        dataclasses.replace(cfg, autopilot=True), neighbors=K, landmark="on")
    gap = float(loss_on[-1]) - float(loss_off[-1])
    print(f"[pilot] guardrail: final KL autopilot {float(loss_on[-1]):.6f} "
          f"vs off {float(loss_off[-1]):.6f}: gap {gap:+.6f} (bar "
          f"{ap.KL_GUARDRAIL_TOL}); optimize {st_on['optimize']:.4f} s vs "
          f"{stats['optimize']:.4f} s off ({t_off:.3f} s end to end off)")
    check(abs(gap) <= ap.KL_GUARDRAIL_TOL,
          f"[pilot] guardrail: |KL gap| {abs(gap)} > {ap.KL_GUARDRAIL_TOL}")

    # [rows]'s latent blobs: auto engages the landmark schedule there
    # (rows layout, N >= 20k).  It loses neighbourhoods on these data (the
    # JAX package's schedule, ported as it is: 10-NN label agreement
    # ~0.82 against [rows]'s ~0.94, with the autopilot on or off;
    # scripts/landmark_quality_cuda.py), so its quality is reported; the
    # autopilot's stride alone (landmark off) is held to [rows]'s label
    # check
    y_rows, kl_rows, t_rows = rows_stats
    agree_z = label_agreement(torch.from_numpy(z_latent).cuda(), labels_l)
    y, losses, st = pilot_run("latent blobs (as [rows]), landmark auto",
                              xl_np, dataclasses.replace(cfg,
                                                         autopilot=True))
    check(st["policy"]["landmark"], "[pilot] the landmark schedule did not "
          "engage on the latent blobs")
    kl = float(losses[-1])
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(
        losses).all()), "[pilot] landmark run: non-finite y or loss")
    print(f"[pilot] latent blobs, landmark auto: optimize "
          f"{st['optimize']:.4f} s vs [rows]'s {t_rows:.4f} s; final KL "
          f"{kl:.6f} vs [rows]'s {kl_rows:.6f}: gap {kl - kl_rows:+.6f}; "
          f"10-NN label agreement {label_agreement(y, labels_l):.4f} "
          f"(reported; [rows]'s bar {agree_z - 0.05:.4f})")
    y, losses, st = pilot_run("latent blobs (as [rows]), landmark off",
                              xl_np, dataclasses.replace(cfg,
                                                         autopilot=True),
                              landmark="off")
    kl = quality("pilot", y, losses, labels_l, cfg, agree_z - 0.05)
    print(f"[pilot] latent blobs, landmark off: optimize "
          f"{st['optimize']:.4f} s vs [rows]'s {t_rows:.4f} s; final KL "
          f"{kl:.6f} vs [rows]'s {kl_rows:.6f}: gap {kl - kl_rows:+.6f}")

    # [large]'s P and init: the FFT stride and grid ladder (blocks layout,
    # so no landmark schedule)
    y_l, kl_l, t_l, jidx, jval, rev, cfg_l = large
    n = y_l.shape[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_working_set(gen, n, 2, torch.float32, "cuda")
    cfg_ap = dataclasses.replace(cfg_l, autopilot=True)
    torch.cuda.synchronize()
    ap.reset_host_reads()
    t0 = time.perf_counter()
    st_l, loss_l, pilot = optimize(state, jidx, jval, cfg_ap, edges=rev,
                                   edges_extra=True)
    torch.cuda.synchronize()
    t_ap = time.perf_counter() - t0
    reads = ap.host_reads()
    pol = ap.policy_report(cfg_ap, pilot)
    gap = float(loss_l[-1]) - kl_l
    print(f"[pilot] [large]'s P and init, FFT + autopilot: optimize "
          f"{t_ap:.4f} s vs [large]'s {t_l:.4f} s; repulsion refreshes "
          f"{pol['repulsion_refreshes']} of {ITERATIONS}, grid ladder "
          f"{pol['grid_ladder']}, host reads {reads}; final KL "
          f"{float(loss_l[-1]):.6f} vs [large]'s {kl_l:.6f}: gap "
          f"{gap:+.6f} (reported, not gated); transitions "
          f"{json.dumps(pol['transitions'])}")
    check(bool(torch.isfinite(st_l.y).all()), "[pilot] large: non-finite y")
    check(reads <= ITERATIONS // 10, f"[pilot] large: {reads} host reads")


def phase_diverging(x_np):
    """A run whose learning rate overflows f32 in its first segment: the
    sentinel rolls back three times, halving eta each time, then raises
    ``DivergenceError``."""
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.runtime.health import DivergenceError
    est = TSNE(perplexity=PERPLEXITY, learning_rate=1e30, health_check=True,
               random_state=0)
    raised = False
    try:
        est.fit(x_np[:N_DETERMINISM])
    except DivergenceError as e:
        raised = True
        print(f"[diverging] N={N_DETERMINISM} learning rate 1e30: "
              f"DivergenceError: {e}")
    events = est.runtime_events_ or []
    for ev in events:
        print(f"[diverging] event {json.dumps(ev)}")
    etas = [ev["eta_after"] for ev in events]
    check(raised and len(events) == 3
          and etas == [5e29, 2.5e29, 1.25e29]
          and all(ev["segment_start"] == 0 for ev in events),
          f"[diverging] raised {raised}, events {events}")


# ---- [mesh]: the single-controller point mesh (queue A14a) ---------------

#: the test mesh: the one card listed once a shard
def test_mesh(d):
    return ["cuda:0"] * d


def mesh_run(tag, cfg, jidx, jval, d, extra=None, state0=None, **kw):
    """One ``parallel/mesh.ShardedOptimizer`` run on the test mesh of ``d``
    shards from ``state0`` (None: ``tsne_embed``'s init, seed 0), its
    launches counted from 0 just before it.  ``kw`` goes to the call
    (checkpoints, resume).
    Returns (state, losses, launches, seconds, layout); the seconds
    include the layout's plan on the padded rows."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.models.tsne import init_working_set
    from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
    n = int(jidx.shape[0])
    if state0 is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state0 = init_working_set(gen, n, cfg.n_components, torch.float32,
                                  "cuda")
    opt = ShardedOptimizer(cfg, n, devices=test_mesh(d))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st, losses = opt(state0, jidx, jval, extra_edges=extra, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    iters = cfg.iterations - kw.get("start_iter", 0)
    print(f"[mesh] {tag}, mesh {d} ({opt.n_padded} padded rows, {opt.n_local}"
          f" a shard): layout {opt.layout}, {wall:.3f} s, "
          f"{wall / iters:.6f} s/iter, launches {json.dumps(counts)}")
    return st, losses, counts, wall, opt.layout


def mesh_same(tag, runs):
    """Every width's state and loss trace bit for bit mesh 1's."""
    st1, l1 = runs[1][:2]
    for d, (st, losses, *_) in runs.items():
        same = all(torch_equal(a, b) for a, b in zip(st, st1))
        check(same and torch_equal(losses, l1),
              f"[mesh] {tag}: mesh {d} differs from mesh 1")
    print(f"[mesh] {tag}: y, update, gains and the loss trace of mesh "
          f"{', '.join(map(str, runs))} equal bit for bit")


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def shard_launches(tag, runs, want1):
    """Each width's launches are exactly D x mesh 1's ``want1``."""
    for d, run in runs.items():
        want = {k: v * d for k, v in want1.items()}
        check(run[2] == want, f"[mesh] {tag}: mesh {d} launches {run[2]} "
              f"!= {want}")


def mesh_b2_shapes(y):
    """B2 on one shard of a D-wide mesh at 60,000 rows, with the column
    splits of the quantum-wide local size (what the sharded optimizer
    launches) beside the shard's own count (what a plain launch of that
    many rows takes): the rows' bits against the mesh-1 launch, and the
    time of each.  Returns {D: (canonical ms, own ms)}."""
    import torch
    from tsne_flink_tpu_torch.ops.repulsion_cuda import (column_splits,
                                                         cuda_exact_repulsion)
    from tsne_flink_tpu_torch.parallel.mesh import PAD_QUANTUM
    n = y.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_rows = n // PAD_QUANTUM
    whole, zw = cuda_exact_repulsion(y, row_z=True, split_rows=split_rows)
    full_ms = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20)
    print(f"[mesh] B2 at {n} rows: its own "
          f"{column_splits(n, n, sms, 2, False)} column splits "
          f"{full_ms:.4f} ms")
    out = {}
    for d in (2, 4, 8):
        nl = n // d
        ys = y[:nl].contiguous()
        rep, z = cuda_exact_repulsion(ys, y, row_z=True,
                                      split_rows=split_rows)
        check(torch.equal(rep, whole[:nl]) and torch.equal(z, zw[:nl]),
              f"[mesh] B2 at a shard of {d}: not the mesh-1 launch's bits")
        can = cuda_ms(lambda: cuda_exact_repulsion(
            ys, y, row_z=True, split_rows=split_rows), 20)
        own = cuda_ms(lambda: cuda_exact_repulsion(ys, y, row_z=True), 20)
        out[d] = (can, own)
        print(f"[mesh] B2 at a shard of mesh {d} ({nl} x {n}): canonical "
              f"{column_splits(split_rows, n, sms, 2, False)} splits "
              f"{can:.4f} ms, the shard's own "
              f"{column_splits(nl, n, sms, 2, False)} splits "
              f"{own:.4f} ms; the canonical rows equal the mesh-1 "
              "launch's bit for bit")
    return out


def mesh_blobs(x_np, labels, cfg, full, csr_kl):
    """[full]'s configuration (config 2's shape, the CSR fused path: B2,
    B3, B4) through the sharded optimizer at mesh 1, 2 and 4, stage by
    stage as ``[runtime]`` measures memory: bits equal across widths,
    launches D x mesh 1's, mesh 1 against [full]'s plain run (final KL
    within 0.05, its label gate, max |dy| printed), mesh 1's run peak
    within the memory model's [1, 2]x (allocated), and each width's
    optimize-stage peak on the one card divided by D beside the model's
    per-device charge at that width (reported, not gated: D shards share
    the card).  Returns the launches a shard makes."""
    import torch
    from tsne_flink_tpu_torch.analysis.audit.hbm import (allocated_peak,
                                                         stage_terms)
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    n, d = x_np.shape
    torch.cuda.empty_cache()
    tr = PeakTracker()
    peaks = {}
    prep = prepare(torch.as_tensor(x_np, device="cuda"), neighbors=K,
                   seed=0, perplexity=cfg.perplexity, device="cuda",
                   on_stage=lambda st, *a: peaks.__setitem__(st, tr.mark()))
    bound_w = width_bound(prep.idx)
    plan1 = dataclasses.replace(
        charged_plan(memory_plan("full", n, d, cfg, bound_w)), mesh=1)
    runs = {}
    for width in (1, 2, 4):
        tr.mark()
        runs[width] = mesh_run(f"blobs {n} x {d} CSR", cfg, prep.jidx,
                               prep.jval, width)
        a = tr.mark()[0]
        if width == 1:
            peaks["optimize"] = (a, 0)
            alloc = max(v for v, _ in peaks.values())
            pa = max(allocated_peak(t) for t in stage_terms(plan1).values())
            print(f"[mesh] memory mesh 1 ({prep.label}, the graph's bound "
                  f"{bound_w}): run peak allocated predicted "
                  f"{pa / 2**30:.3f} GiB / measured {alloc / 2**30:.3f} GiB "
                  f"= {pa / alloc:.3f} (stages "
                  + ", ".join(f"{k} {v / 2**30:.3f}" for k, (v, _)
                              in peaks.items()) + " GiB)")
            check(alloc <= pa <= 2 * alloc, f"[mesh] memory mesh 1: "
                  f"predicted {pa} outside [1, 2] x measured {alloc}")
        else:
            per = allocated_peak(stage_terms(dataclasses.replace(
                plan1, mesh=width))["optimize"])
            print(f"[mesh] memory mesh {width} on one card: optimize-stage "
                  f"peak {a / 2**30:.3f} GiB, / {width} = "
                  f"{a / width / 2**30:.3f} GiB beside the model's "
                  f"per-device charge {per / 2**30:.3f} GiB (not gated)")
    del prep
    check(runs[1][4] == "csr", f"[mesh] blobs: layout {runs[1][4]}")
    mesh_same("blobs CSR", runs)
    want = {"B1": 0, "B1_bf16": 0, **NO_F64, **NO_WIDE, **NO_UNSTAGED,
            "B2": ITERATIONS, "B3": ITERATIONS, "B4": ITERATIONS // 10,
            "B5": 0, "B6": 0}
    shard_launches("blobs CSR", runs, want)
    y1 = runs[1][0].y
    kl1 = quality("mesh", y1, runs[1][1], labels, cfg, 0.9)
    dy = float(torch.max(torch.abs(y1 - full[0])))
    print(f"[mesh] blobs CSR mesh 1 against [full]'s plain run: final KL "
          f"{kl1:.6f} vs {csr_kl:.6f} (gap {kl1 - csr_kl:+.6f}, bar "
          f"{KL_GUARDRAIL_TOL}); max |dy| {dy:.4e} (not bits: B2's column "
          f"splits are the quantum-wide local size's)")
    check(abs(kl1 - csr_kl) <= KL_GUARDRAIL_TOL,
          f"[mesh] mesh 1 KL {kl1} vs [full]'s {csr_kl}")
    del runs
    torch.cuda.empty_cache()
    return want


def mesh_checkpoint(tag, cfg, jidx, jval, uninterrupted, tmp):
    """A fat checkpoint written at iteration 150 of a mesh-1 run, read
    back and resumed on a test mesh of 2: the uninterrupted run's state
    and loss trace bit for bit."""
    import torch
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    path = os.path.join(tmp, "mesh.npz")
    payload = {"label": "sorted", "jidx": jidx, "jval": jval}
    half = cfg.iterations // 2
    mesh_run(f"{tag}, fat checkpoint at {half}", cfg, jidx, jval, 1,
             checkpoint_every=half,
             checkpoint_cb=lambda st, it, ls: ckpt.save(path, st, it, ls,
                                                        payload))
    st, it, losses, pl, _ = ckpt.load_resume(path)
    check(it == half, f"[mesh] checkpoint at {it}, not {half}")
    from tsne_flink_tpu_torch.convert import state_from_numpy
    st = state_from_numpy(st.y, st.update, st.gains, device="cuda",
                          dtype=torch.float32)
    ji = torch.as_tensor(pl["jidx"], device="cuda")
    jv = torch.as_tensor(pl["jval"], device="cuda")
    res = mesh_run(f"{tag}, resumed from {half}", cfg, ji, jv, 2, state0=st,
                   start_iter=half,
                   loss_carry=torch.as_tensor(losses, device="cuda"))
    same = (all(torch_equal(a, b) for a, b in zip(res[0], uninterrupted[0]))
            and torch_equal(res[1], uninterrupted[1]))
    check(same, f"[mesh] {tag}: the mesh-2 resume of a mesh-1 checkpoint is "
          "not the uninterrupted run's bits")
    print(f"[mesh] {tag}: the fat checkpoint written at mesh 1, iteration "
          f"{half}, resumed at mesh 2 gives the uninterrupted run's state "
          "and loss trace bit for bit")


def phase_mesh(x_np, labels, full, csr_kl, latent_rows, large, tmp):
    """[mesh]: the sharded optimizer (``parallel/mesh``) at full width on
    the test mesh.  Config 2's shape on the CSR fused path at mesh 1, 2,
    4 (bits equal across widths, launches D x mesh 1's; mesh 1 against
    [full]'s plain run within 0.05 KL with its label gate), the latent
    blobs on the rows layout and [large]'s P on blocks + FFT at mesh 1
    and 2 (bits), n = 60,001 (a padded, masked tail) at mesh 1 and 4, a
    mesh-1 fat checkpoint resumed at mesh 2, B2 at shard shapes, and the
    memory model (:func:`mesh_blobs`).  The CLI's mesh gates run in
    [cli] (:func:`mesh_cli_gates`), where config 2's COO file is.
    Returns each kernel's launches per shard and B2's shard times for the
    kernels line."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    t_phase = time.perf_counter()
    per_shard = {}

    # config 2's shape, CSR fused (B2, B3, B4), with the memory model
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact", attraction="csr")
    per_shard["csr"] = mesh_blobs(x_np, labels, cfg, full, csr_kl)
    b2_shard = mesh_b2_shapes(full[0])

    # the latent blobs on the rows layout (B2, B5, B4), and a fat
    # checkpoint across widths
    cfg_r = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS)
    ji, jv = latent_rows
    runs = {d: mesh_run("latent blobs rows", cfg_r, ji, jv, d)
            for d in (1, 2)}
    check(runs[1][4] == "rows", f"[mesh] latent blobs: layout {runs[1][4]}")
    mesh_same("latent blobs rows", runs)
    want = {"B1": 0, "B1_bf16": 0, **NO_F64, **NO_WIDE, **NO_UNSTAGED,
            "B2": ITERATIONS, "B3": 0, "B4": ITERATIONS // 10,
            "B5": ITERATIONS, "B6": 0}
    shard_launches("latent blobs rows", runs, want)
    per_shard["rows"] = want
    mesh_checkpoint("latent blobs rows", cfg_r, ji, jv, runs[1], tmp)
    del runs

    # n = 60,001: the last shard padded and masked
    x1, lab1 = make_data(n=N_FULL + 1)
    prep = prepare(torch.as_tensor(x1, device="cuda"), neighbors=K,
                   seed=0, perplexity=PERPLEXITY, device="cuda")
    runs = {d: mesh_run(f"blobs {N_FULL + 1} x 784 CSR", cfg, prep.jidx,
                        prep.jval, d) for d in (1, 4)}
    mesh_same(f"blobs {N_FULL + 1} CSR (padded tail)", runs)
    quality("mesh", runs[1][0].y, runs[1][1], lab1, cfg, 0.9)
    del runs, prep, x1

    # [large]'s P on blocks + FFT (B5, B4, the FFT gather)
    y_l, kl_l, t_l, jidx_l, jval_l, rev, cfg_l = large
    runs = {d: mesh_run(f"[large]'s P {y_l.shape[0]} x 50 blocks + FFT",
                        cfg_l, jidx_l, jval_l, d, extra=rev)
            for d in (1, 2)}
    check(runs[1][4] == "blocks", f"[mesh] large: layout {runs[1][4]}")
    mesh_same("large blocks + FFT", runs)
    want = {"B1": 0, "B1_bf16": 0, **NO_F64, **NO_WIDE, **NO_UNSTAGED, "B2": 0,
            "B3": 0, "B4": ITERATIONS // 10, "B5": ITERATIONS, "B6": 0}
    shard_launches("large blocks + FFT", runs, want)
    per_shard["blocks"] = want
    print(f"[mesh] large: s/iter mesh 1 {runs[1][3] / ITERATIONS:.6f}, mesh "
          f"2 {runs[2][3] / ITERATIONS:.6f} (one card time-slicing two "
          f"shards, each computing the FFT field: not a multi-GPU speed); "
          f"[large]'s plain optimize {t_l / ITERATIONS:.6f}; final KL mesh "
          f"1 {float(runs[1][1][-1]):.6f} vs [large]'s {kl_l:.6f}")
    del runs

    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return per_shard, b2_shard


def mesh_cli_gates(x_np, argv, run_cli_fn, config2):
    """The mesh flags through the batch job, on config 2's COO file:
    ``--mesh 1`` gives the estimator's mesh-1 bits (``TSNE(mesh=1)``);
    ``--mesh 2`` on a one-card machine raises, naming the visible count,
    before the input is read; ``--meshReduce psum`` on a test mesh of 2
    ends within 0.05 KL of the canonical mesh-1 run."""
    import torch
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.utils.cli import main as cli_main

    def final_kl(out):
        path = argv(out)[argv(out).index("--loss") + 1]
        return float(np.loadtxt(path, delimiter=",", ndmin=2)[-1, 1])

    y_m, counts_m, _, _ = run_cli_fn("config 2 --mesh 1", argv(
        "m1.csv", *config2, "--noCache", "--mesh", "1"))
    est = TSNE(mesh=1, knn_method="project", theta=0.5,
               perplexity=PERPLEXITY, n_iter=ITERATIONS, random_state=0)
    y_e = est.fit_transform(x_np)
    check(same_bits(y_m, y_e), "[mesh] --mesh 1 != TSNE(mesh=1)'s bits")
    print("[mesh] cli: config 2 --mesh 1 equals TSNE(mesh=1).fit bit for "
          "bit")
    if torch.cuda.device_count() == 1:
        out = argv("m2.csv", *config2, "--noCache", "--mesh", "2")
        t0 = time.perf_counter()
        msg = ""
        try:
            cli_main(out)
        except ValueError as e:
            msg = str(e)
        secs = time.perf_counter() - t0
        made = os.path.exists(out[out.index("--output") + 1])
        print(f"[mesh] cli: --mesh 2 on one card refused in {secs:.3f} s: "
              f"{msg}")
        check("1 is visible" in msg and not made and secs < 5.0,
              "[mesh] --mesh 2 was not refused before the input was read")
    y_p, _, _, _ = run_cli_fn("config 2 --meshReduce psum, test mesh of 2",
                              argv("p2.csv", *config2, "--noCache",
                                   "--meshReduce", "psum"),
                              mesh_devices=test_mesh(2))
    kl_c, kl_p = final_kl("m1.csv"), final_kl("p2.csv")
    print(f"[mesh] cli: --meshReduce psum at mesh 2 final KL {kl_p:.6f} vs "
          f"canonical mesh 1 {kl_c:.6f} (gap {kl_p - kl_c:+.6f}, bar "
          f"{KL_GUARDRAIL_TOL}); bits equal: {same_bits(y_p, y_m)}")
    check(abs(kl_p - kl_c) <= KL_GUARDRAIL_TOL,
          f"[mesh] psum KL {kl_p} vs canonical {kl_c}")


# ---- [runtime]: the memory model, the OOM ladder, faults, the fleet, ----
# ---- tracing (queue A15) ------------------------------------------------

#: the full-size runs whose peaks the memory model is held to: (data,
#: neighbours, kNN method, affinity assembly, TsneConfig keywords)
MEMORY_RUNS = {
    "full": ("blobs", K, "bruteforce", None,
             dict(repulsion="exact", attraction="csr")),
    "rows": ("latent", K, "bruteforce", None, dict(repulsion="exact")),
    "blocks": ("blobs", K, "bruteforce", "blocks", dict(repulsion="exact")),
    "project": ("blobs", K, "project", None, dict(repulsion="exact")),
    "large": ("cells", K_CELLS, "project", None,
              dict(repulsion="fft", fft_grid=1024, fft_interp=3)),
    # [full] at float64: B1-B5's float64 forms
    "full_f64": ("blobs64", K, "bruteforce", None,
                 dict(repulsion="exact", attraction="csr")),
}


# ---- [spmd]: the multi-controller job (queue A14b) -------------------------

#: the ring's widths on the test mesh, the job's process count, and the
#: process group's collective timeout in its jobs
SPMD_RING_WIDTHS = (2, 4)
SPMD_PROCESSES = 2
SPMD_TIMEOUT_S = 120
#: the blobs' rows the --symStrict job reads
SPMD_STRICT_ROWS = 6_000

#: one rank of a pipeline job (torch and the port only): the sharded
#: project kNN of its rows, then the alltoall job (its prepare's gathered
#: P, then the whole job), each with its launches from 0
SPMD_WORKER = r"""
import json, sys, time
import numpy as np, torch
from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.ops.knn import pick_knn_refine, pick_knn_rounds
from tsne_flink_tpu_torch.parallel.knn import project_knn_sharded
from tsne_flink_tpu_torch.parallel.mesh import (distributed_init,
                                                padded_rows_for,
                                                process_axis)
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
spec = json.loads(sys.argv[1])
r, out = spec["rank"], spec["out"]
distributed_init(spec["coordinator"], spec["world"], r,
                 timeout_s=spec["timeout_s"])
x = torch.from_numpy(np.load(spec["x"]))
n, d = x.shape
k = spec["k"]
axis = process_axis()
rec = {"rank": r, "backend": axis.backend, "staged": axis.staged}
nl = padded_rows_for(n, axis.size) // axis.size
xp = torch.nn.functional.pad(x, (0, 0, 0, nl * axis.size - n))
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
torch.cuda.synchronize()
reset_launches()
t0 = time.perf_counter()
idx, dist = project_knn_sharded(
    xp[r * nl:(r + 1) * nl].cuda(), k, n, rounds=pick_knn_rounds(n),
    generator=gen, axis=axis, refine_rounds=pick_knn_refine(n, d))
torch.cuda.synchronize()
rec["project"] = {"seconds": time.perf_counter() - t0,
                  "launches": launches()}
np.save(f"{out}/project_{r}.npy", np.concatenate(
    [idx.cpu().numpy().astype(np.float64), dist.cpu().numpy()], axis=1))
del idx, dist
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
torch.cuda.synchronize()
reset_launches()
t0 = time.perf_counter()
idx, dist = project_knn_sharded(
    xp[r * nl:(r + 1) * nl].double().cuda(), k, n,
    rounds=pick_knn_rounds(n), generator=gen, axis=axis,
    refine_rounds=pick_knn_refine(n, d))
torch.cuda.synchronize()
rec["project64"] = {"seconds": time.perf_counter() - t0,
                    "launches": launches(), "dtype": str(dist.dtype)}
np.save(f"{out}/project64_{r}.npy", np.concatenate(
    [idx.cpu().numpy().astype(np.float64), dist.cpu().numpy()], axis=1))
del idx, dist
cfg = TsneConfig(**spec["cfg"])
pipe = SpmdPipeline(cfg, n, d, k, sym_mode="alltoall")
jidx, jval, _ = pipe.prepare(x, 0)
if r == 0:
    np.save(f"{out}/a2a_jidx.npy", jidx.cpu().numpy())
    np.save(f"{out}/a2a_jval.npy", jval.cpu().numpy())
rec["a2a_width"] = pipe.sym_width
del jidx, jval
torch.cuda.synchronize()
reset_launches()
t0 = time.perf_counter()
y, losses = pipe(x, 0)
torch.cuda.synchronize()
rec["a2a"] = {"seconds": time.perf_counter() - t0, "launches": launches(),
              "layout": pipe._runner.layout,
              "kl": float(losses[-1])}
if r == 0:
    np.save(f"{out}/a2a_y.npy", y.cpu().numpy())
print("SPMD_RECORD " + json.dumps(rec))
"""


def spmd_cfg_kw():
    """The command line's defaults as ``TsneConfig`` keywords at 60k
    (``utils/cli.py``: theta 0.25, auto repulsion exact below
    EXACT_N_MAX)."""
    return dict(n_components=2, perplexity=PERPLEXITY,
                early_exaggeration=4.0, learning_rate=1000.0,
                iterations=ITERATIONS, initial_momentum=0.5,
                final_momentum=0.8, theta=0.25, metric="sqeuclidean",
                repulsion="exact", attraction="auto", bh_gate="vdm",
                autopilot=False)


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spmd_start(argvs):
    """Start one process a rank (``argvs[r]``, each a full command line;
    the string ``{coord}`` becomes the job's rendezvous) from the
    repository root, each writing into a temporary file; returns the job
    for :func:`spmd_wait`."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in argvs]
    procs = [subprocess.Popen([a.replace("{coord}", coord) for a in argv],
                              cwd=ROOT, env=env, stdout=log,
                              stderr=subprocess.STDOUT, text=True)
             for argv, log in zip(argvs, logs)]
    return procs, logs, t0


def spmd_wait(tag, job, timeout=600):
    """Wait for a job's ranks, then stop every process it started; returns
    (exit codes, seconds since the start, outputs)."""
    procs, logs, t0 = job
    rcs, outs = [], []
    try:
        for p, log in zip(procs, logs):
            rcs.append(p.wait(timeout=timeout))
            log.seek(0)
            outs.append(log.read())
    finally:
        for p, log in zip(procs, logs):
            p.kill()  # a no-op for those that ended
            p.wait()
            log.close()
    secs = time.perf_counter() - t0
    print(f"[spmd] {tag}: {len(procs)} processes, exit codes {rcs}, "
          f"{secs:.1f} s")
    return rcs, secs, outs


def spmd_job(tag, argvs, timeout=600):
    """:func:`spmd_start` then :func:`spmd_wait`: (exit codes, seconds,
    outputs)."""
    return spmd_wait(tag, spmd_start(argvs), timeout)


def spmd_ring(x, want, b1_ms):
    """The ring on the test mesh at each width in SPMD_RING_WIDTHS: the
    graph ``fused_knn``'s bit for bit, B1 launched D times a shard; the
    cross sweep's per-hop time beside the single sweep's at each hop
    shape, with its bound.  Returns the hop records' inputs at the
    2-process job's hop shape."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_cross_cuda,
                                                   knn_cross_plain,
                                                   knn_sweep_cuda,
                                                   norm_pairs)
    from tsne_flink_tpu_torch.parallel.knn import ring_knn
    from tsne_flink_tpu_torch.parallel.mesh import run_shards
    n, f = x.shape
    hops = {}
    for d in SPMD_RING_WIDTHS:
        nl = n // d
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = run_shards(test_mesh(d), lambda ax: ring_knn(
            x[ax.index * nl:(ax.index + 1) * nl], K, n, axis=ax))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        gi = torch.cat([o[0] for o in outs])
        gd = torch.cat([o[1] for o in outs])
        check(counts["B1"] == d * d and sum(counts.values()) == d * d,
              f"[spmd] ring mesh {d}: launches {counts}, want B1 {d * d}")
        check(torch.equal(gi, want[0]) and torch.equal(gd, want[1]),
              f"[spmd] ring mesh {d}: the graph differs from fused_knn's")
        rows, cols = x[:nl].contiguous(), x[nl:2 * nl].contiguous()
        nr, nc = norm_pairs(rows), norm_pairs(cols)
        t = alternated_ms(
            {"cross": lambda: knn_cross_cuda(rows, cols, K, False, 0, nl, n,
                                             nr, nc),
             "single": lambda: knn_sweep_cuda(rows, K, False)},
            ["cross", "single", "single", "cross", "cross", "single"])
        bnd = bound(3 * 2.0 * nl * nl * f, 2 * nl * f * 4 + nl * K * 8,
                    PEAK_TF32_FLOPS)
        hops[d] = (rows, cols, nr, nc, t, bnd)
        print(f"[spmd] ring mesh {d} on the test mesh ({nl} rows a shard): "
              f"{wall:.3f} s, launches {json.dumps(counts)} ({d} B1 a "
              f"shard), the graph fused_knn's bit for bit; B1 cross hop "
              f"{nl}x{nl}: {spread(t['cross'])}; single sweep over {nl} "
              f"rows {spread(t['single'])}; [full]'s sweep / {d * d} "
              f"{b1_ms / (d * d):.4f} ms; bound a hop {bnd[0]:.4f} ms by "
              f"{bnd[1]} (3xTF32 at 495 TFLOP/s)")
    # the record at the 2-process job's hop: kernel against plain
    rows, cols, nr, nc, t, bnd = hops[SPMD_PROCESSES]
    nl = rows.shape[0]
    kd, ki = knn_cross_cuda(rows, cols, K, False, 0, nl, n, nr, nc)
    ki, kd = _fused_final(kd, ki, "sqeuclidean")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pd, pi = knn_cross_plain(rows, cols, K, False, 0, nl, n)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    sets = set_agreement(ki.long(), pi.long())
    err = float(torch.max(torch.abs(kd - pd)))
    check(sets >= 0.999, f"[spmd] B1 cross: set agreement {sets}")
    check(bool(torch.allclose(kd, pd, rtol=1e-4,
                              atol=1e-4 * float(pd.max()))),
          "[spmd] B1 cross: distances off its plain version (rtol 1e-4)")

    def library():
        d2 = (torch.sum(rows * rows, 1)[:, None]
              + torch.sum(cols * cols, 1)[None, :] - 2.0 * (rows @ cols.T))
        return torch.topk(d2, K, dim=1, largest=False)

    lib = statistics.median(alternated_ms({"library": library},
                                          ["library"] * 3)["library"])
    print(f"[spmd] B1 cross hop {nl}x{nl} against its plain version: sets "
          f"{sets:.6f}, max |d| err {err:.3e}; plain {plain_ms:.1f} ms "
          f"(host clock), library (matmul + topk) {lib:.4f} ms")
    return (statistics.median(t["cross"]), plain_ms, lib), bnd, err


def spmd_ring_bf16(x):
    """The bf16 ring (``--dtype bfloat16`` on the multi-controller route)
    on the test mesh at each width in SPMD_RING_WIDTHS: the graph of
    ``fused_knn``'s bf16 form bit for bit, B1's bf16 form launched D times
    a shard and no other kernel."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn
    from tsne_flink_tpu_torch.parallel.knn import ring_knn
    from tsne_flink_tpu_torch.parallel.mesh import run_shards
    bf = torch.bfloat16
    n = x.shape[0]
    want = fused_knn(x, K, matmul_dtype=bf)
    for d in SPMD_RING_WIDTHS:
        nl = n // d
        torch.cuda.synchronize()
        reset_launches()
        outs = run_shards(test_mesh(d), lambda ax: ring_knn(
            x[ax.index * nl:(ax.index + 1) * nl], K, n, axis=ax,
            matmul_dtype=bf))
        torch.cuda.synchronize()
        counts = launches()
        gi = torch.cat([o[0] for o in outs])
        gd = torch.cat([o[1] for o in outs])
        print(f"[spmd] bf16 ring mesh {d} on the test mesh: launches "
              f"{json.dumps(counts)}; the graph the bf16 single sweep's bit "
              f"for bit: {torch.equal(gi, want[0]) and torch.equal(gd, want[1])}")
        check(counts["B1_bf16"] == d * d and sum(counts.values()) == d * d,
              f"[spmd] bf16 ring mesh {d}: launches {counts}")
        check(torch.equal(gi, want[0]) and torch.equal(gd, want[1]),
              f"[spmd] bf16 ring mesh {d}: the graph differs from the "
              "bf16 single sweep's")


def spmd_b6_n_valid(x, n_valid):
    """B6 with ``n_valid`` on the blobs' first funnel stage (the cascade
    at F = 128, the gateways' candidates built in the kernel) of a refine
    round's first chunks: against its plain version with the same
    ``n_valid``, no kept id at or past it, timed over the chunks in
    sequence.  Returns (times, bound, max err)."""
    import torch
    chunks = capture_refine_chunks(x, K, B6_TIMED_CHUNKS)
    stages = []
    for chunk in chunks:
        kind, args, kwargs = chunk[0]
        stages.append((kind, args, dict(kwargs, n_valid=n_valid)))
    kind, args, kwargs = stages[0]
    e, sets = hold_stage("n_valid first stage", kind, args, kwargs)
    got = stage_call(kind, args, kwargs)
    ids = got[0] if isinstance(got, tuple) else got
    check(not bool((ids >= n_valid).any()),
          f"[spmd] B6 kept an id at or past n_valid = {n_valid}")
    times = (chunks_ms(stages), chunks_ms(stages, plain=True), None)
    per = [stage_bound(*st, stage_call(*st)) for st in stages]
    bnd = (statistics.mean(b[0][0] for b in per), per[0][0][1])
    print(f"[spmd] B6 {kind} stage F={args[0].shape[1]} with n_valid "
          f"{n_valid} of {x.shape[0]} (ids past it dropped): max err "
          f"{e:.3e}, sets {sets:.6f}, {times[0]:.4f} ms a chunk over "
          f"{len(stages)} chunks (plain {times[1]:.4f} ms, bound "
          f"{bnd[0]:.4f} ms by {bnd[1]})")
    del chunks
    return times, bnd, e


def spmd_project_f64_mesh(x64):
    """The float64 project kNN (``parallel/knn.project_knn_sharded``, the
    auto seed rounds and refine cycles, B6_f64 with ``n_valid``) on the
    test mesh at D = 2 and at D = 1, from one set of draws: each shard
    draws the gateway scores of its local rows alike (the JAX function's
    draws), so mesh 1 takes mesh 2's with the scores stacked for its two
    halves.  The graphs equal bit for bit; B6_f64 launched on every shard
    and no float32 form.  Returns (mesh 2's B6_f64 launches, seconds a
    width)."""
    import dataclasses as dc

    import torch
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.ops.knn import (RefineDraw, pick_knn_refine,
                                              pick_knn_rounds)
    from tsne_flink_tpu_torch.parallel.knn import (project_draws,
                                                   project_knn_sharded)
    from tsne_flink_tpu_torch.parallel.mesh import padded_rows_for, run_shards
    n, d = x64.shape
    rounds, cycles = pick_knn_rounds(n), pick_knn_refine(n, d)
    npts = padded_rows_for(n, 2)
    check(npts == padded_rows_for(n, 1), "[spmd] mesh 1 and 2 pad apart")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dr2 = project_draws(gen, d, K, rounds, cycles, npts // 2, npts,
                        torch.float64, "cuda")
    dr1 = [dc.replace(dr, gate=torch.cat([dr.gate, dr.gate]))
           if isinstance(dr, RefineDraw) and dr.gate is not None else dr
           for dr in dr2]
    xp = torch.nn.functional.pad(x64, (0, 0, 0, npts - n))
    graphs, secs, b6 = {}, {}, {}
    for width, draws in ((2, dr2), (1, dr1)):
        nl = npts // width
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        outs = run_shards(test_mesh(width), lambda ax: project_knn_sharded(
            xp[ax.index * nl:(ax.index + 1) * nl], K, n, rounds=rounds,
            axis=ax, draws=draws, refine_rounds=cycles))
        torch.cuda.synchronize()
        secs[width] = time.perf_counter() - t0
        got = launches()
        b6[width] = got["B6_f64"]
        check(got["B6_f64"] > 0 and not any(
            v for kid, v in got.items() if not kid.endswith("_f64")),
            f"[spmd] float64 project mesh {width} launches {got}")
        graphs[width] = (torch.cat([o[0] for o in outs]),
                         torch.cat([o[1] for o in outs]))
    same = (torch.equal(graphs[1][0], graphs[2][0])
            and torch.equal(graphs[1][1], graphs[2][1]))
    print(f"[spmd] float64 project kNN on the test mesh ({rounds} seed "
          f"rounds + {cycles} refine cycles, one set of draws): mesh 2 "
          f"{secs[2]:.3f} s (B6_f64 x{b6[2]}), mesh 1 {secs[1]:.3f} s "
          f"(B6_f64 x{b6[1]}); graphs equal bit for bit {same}, dist "
          f"{graphs[1][1].dtype}")
    check(same, "[spmd] the float64 project kNN at mesh 2 differs from "
          "mesh 1")
    return b6[2], secs


def spmd_in_process(x_np, d):
    """``SpmdPipeline`` in this process at mesh ``d`` (the test mesh), the
    command line's configuration: (y, losses, seconds)."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    n, f = x_np.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = SpmdPipeline(TsneConfig(**spmd_cfg_kw()), n, f, K,
                        devices=test_mesh(d))
    y, losses = pipe(torch.from_numpy(x_np), 0)
    torch.cuda.synchronize()
    return y.cpu().numpy(), losses, time.perf_counter() - t0, pipe


def spmd_nccl(x_np, y1):
    """The NCCL route at world size 1: a process group this phase opens,
    the job through it (every collective an NCCL call), mesh 1's bits."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(
                                seconds=SPMD_TIMEOUT_S))
    try:
        y, _, secs, pipe = spmd_in_process(x_np, 1)
        check(pipe.axis is not None and pipe.axis.backend == "nccl",
              "[spmd] the NCCL group was not the pipeline's axis")
    finally:
        dist.destroy_process_group()
    check(same_bits(y, y1), "[spmd] NCCL world size 1 differs from mesh 1")
    print(f"[spmd] NCCL route, world size 1 (the pipeline on its process "
          f"axis): {secs:.2f} s, y equal to mesh 1 bit for bit")


def phase_spmd(x_np, labels, csr_kl, b1_ms):
    """[spmd]: the multi-controller job (queue A14b) at full width.  The
    ring on the test mesh (graph bits, launches, hop times), the command
    line's two-process job on the one card (gloo) against the in-process
    job at mesh 1 and 2, the NCCL route at world size 1, the project kNN
    and the alltoall symmetrization over two processes, and --symStrict
    ending both ranks (the three process jobs run beside each other and
    the in-process jobs, after the timed launches).  Returns the records of B1's cross sweep and B6
    with n_valid."""
    import shutil
    import tempfile

    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    t_phase = time.perf_counter()
    n, f = x_np.shape
    x = torch.from_numpy(x_np).cuda()
    want = fused_knn(x, K)
    hop_t, hop_bnd, hop_err = spmd_ring(x, want, b1_ms)
    spmd_ring_bf16(x)
    b6_t, b6_bnd, b6_err = spmd_b6_n_valid(x, n - 64)
    x64 = x.double()
    want64 = fused_knn(x64, K)[1]
    spmd_project_f64_mesh(x64)
    del x, x64
    torch.cuda.empty_cache()  # the card's room for the process jobs

    tmp = tempfile.mkdtemp(prefix="tsne_spmd_")
    jobs = []
    try:
        # the three process jobs start together here, after the phase's
        # timed launches, and run beside each other and the in-process
        # jobs; each is waited for and checked in turn below
        coo = shared_coo(x_np)
        cli = [sys.executable, "-m", "tsne_flink_tpu_torch.utils.cli",
               "--input", coo, "--dimension", str(f), "--knnMethod",
               "bruteforce", "--noCache", "--spmd", "--coordinator",
               "{coord}", "--numProcesses", str(SPMD_PROCESSES)]

        def argv(r, *extra, out="y", loss="loss"):
            return cli + ["--processId", str(r), "--output",
                          os.path.join(tmp, f"{out}{r}.csv"), "--loss",
                          os.path.join(tmp, f"{loss}{r}.txt"), *extra]

        np.save(os.path.join(tmp, "x.npy"), x_np)
        spec = dict(x=os.path.join(tmp, "x.npy"), out=tmp, k=K,
                    world=SPMD_PROCESSES, coordinator="{coord}",
                    timeout_s=SPMD_TIMEOUT_S, cfg=spmd_cfg_kw())
        # --symStrict: both ranks end non-zero, no hang (on a cut of the
        # blobs: the gate is the job's ending, not its size)
        cut = os.path.join(tmp, "cut.csv")
        write_coo(cut, x_np[:SPMD_STRICT_ROWS])
        jobs.append(spmd_start([argv(r) for r in range(SPMD_PROCESSES)]))
        jobs.append(spmd_start([
            [sys.executable, "-c", SPMD_WORKER, json.dumps(dict(spec,
                                                                rank=r))]
            for r in range(SPMD_PROCESSES)]))
        jobs.append(spmd_start([
            [a if a != coo else cut
             for a in argv(r, out="strict_y", loss="strict_loss")]
            + ["--symMode", "alltoall", "--symSlack", "1", "--symWidth", "8",
               "--symStrict"] for r in range(SPMD_PROCESSES)]))

        y1, l1, s1, _ = spmd_in_process(x_np, 1)
        y2, l2, s2, _ = spmd_in_process(x_np, 2)
        check(same_bits(y1, y2),
              "[spmd] in-process mesh 2 differs from mesh 1")
        print(f"[spmd] in-process SpmdPipeline: mesh 1 {s1:.2f} s, mesh 2 "
              f"(the test mesh) {s2:.2f} s, y equal bit for bit, final KL "
              f"{float(l1[-1]):.6f}")
        spmd_nccl(x_np, y1)

        rcs, secs, outs = spmd_wait("the command line, replicated",
                                    jobs.pop(0))
        check(rcs == [0] * SPMD_PROCESSES,
              f"[spmd] CLI job failed: {outs[0][-2000:]}")
        check(not any(os.path.exists(os.path.join(tmp, f"{name}{r}.{ext}"))
                      for r in range(1, SPMD_PROCESSES)
                      for name, ext in (("y", "csv"), ("loss", "txt"))),
              "[spmd] a rank other than 0 wrote an output")
        from tsne_flink_tpu_torch.utils import native
        y_cli = native.load_coo(os.path.join(tmp, "y0.csv"))[:, 1:].astype(
            np.float32)
        check(same_bits(y_cli, y1) and same_bits(y_cli, y2),
              "[spmd] the 2-process job differs from the in-process job")
        kl_cli = float(np.loadtxt(os.path.join(tmp, "loss0.txt"),
                                  delimiter=",")[-1, 1])
        check(abs(kl_cli - csr_kl) <= 0.01,
              f"[spmd] final KL {kl_cli} vs [full]'s {csr_kl}")
        agree = label_agreement(torch.from_numpy(y_cli).cuda(), labels)
        print(f"[spmd] the 2-process job (gloo, both ranks on the card, "
              f"tensors staged through host memory): y equal to the "
              f"in-process job at mesh 1 and 2 bit for bit, only rank 0 "
              f"wrote, final KL {kl_cli:.6f} ([full] {csr_kl:.6f}), 10-NN "
              f"label agreement {agree:.4f}; {secs:.1f} s end to end "
              f"(process start, a 1 GB COO read a rank, kernel library "
              f"load; beside the phase's other jobs)")
        for out in outs:
            for line in out.splitlines():
                if line.startswith(("embedded", "# sym_width")):
                    print(f"[spmd]   {line}")

        rcs, secs, outs = spmd_wait("project kNN + alltoall job",
                                    jobs.pop(0))
        check(rcs == [0] * SPMD_PROCESSES,
              f"[spmd] worker job failed: {outs[0][-3000:]}")
        recs = [json.loads(line.split(" ", 1)[1]) for out in outs
                for line in out.splitlines()
                if line.startswith("SPMD_RECORD ")]
        check(len(recs) == SPMD_PROCESSES, "[spmd] a rank gave no record")
        cycles = pick_knn_refine(n, f)
        nl = n // SPMD_PROCESSES
        graph = np.concatenate([np.load(os.path.join(tmp, f"project_{r}.npy"))
                                for r in range(SPMD_PROCESSES)])[:n]
        recall = recall_at_k(torch.from_numpy(graph[:, K:]).cuda(),
                             want[1])
        b6 = [rec["project"]["launches"]["B6"] for rec in recs]
        from tsne_flink_tpu_torch.ops import knn as tknn
        from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
        fd = tknn.pick_knn_filter(f)
        plan = tknn._refine_plan(f, K, filter_dims=fd,
                                 expand_k=(K + 1) // 2 if fd else None)
        stages = 1 + bool(plan.filter_dims) + bool(plan.cascade_dims)
        chunk = pick_knn_tiles(n, f, K, "cuda").refine_chunk
        want_b6 = cycles * math.ceil(nl / min(chunk, nl)) * stages
        check(all(c == want_b6 for c in b6),
              f"[spmd] project: B6 {b6} a rank, want {want_b6}")
        check(recall >= 0.93, f"[spmd] project recall {recall} < 0.93")
        print(f"[spmd] project kNN over {SPMD_PROCESSES} processes "
              f"({recs[0]['backend']}, staged {recs[0]['staged']}): "
              f"recall@{K} {recall:.4f} against B1's graph (bar 0.93), "
              f"{cycles} refine cycles, B6 {b6} a rank (n_valid {n}), "
              f"{[round(r_['project']['seconds'], 3) for r_ in recs]} s")
        graph64 = np.concatenate([np.load(os.path.join(
            tmp, f"project64_{r}.npy")) for r in range(SPMD_PROCESSES)])[:n]
        recall64 = recall_at_k(torch.from_numpy(graph64[:, K:]).cuda(),
                               want64)
        l64 = [rec["project64"]["launches"] for rec in recs]
        check(all(c["B6_f64"] == want_b6 and not any(
            v for kid, v in c.items() if not kid.endswith("_f64"))
            for c in l64), f"[spmd] float64 project launches {l64}")
        check(recall64 >= 0.93 and all(
            rec["project64"]["dtype"] == "torch.float64" for rec in recs),
            f"[spmd] float64 project recall {recall64} < 0.93")
        print(f"[spmd] float64 project kNN over {SPMD_PROCESSES} processes: "
              f"recall@{K} {recall64:.4f} against B1_f64's graph (bar "
              f"0.93), B6_f64 {[c['B6_f64'] for c in l64]} a rank, no "
              f"float32 form, "
              f"{[round(r_['project64']['seconds'], 3) for r_ in recs]} s")
        del want64
        # alltoall against replicated: P and the final KL
        pipe = SpmdPipeline(TsneConfig(**spmd_cfg_kw()), n, f, K,
                            devices=test_mesh(SPMD_PROCESSES))
        ji, jv, _ = pipe.prepare(torch.from_numpy(x_np), 0)
        ai = np.load(os.path.join(tmp, "a2a_jidx.npy"))
        av = np.load(os.path.join(tmp, "a2a_jval.npy"))
        ji, jv = ji.cpu().numpy(), jv.cpu().numpy()
        check(ai.shape == ji.shape and np.array_equal(ai, ji),
              "[spmd] alltoall P's ids differ from replicated's")
        rel = float(np.max(np.abs(av - jv) / np.maximum(np.abs(jv), 1e-30)))
        check(rel <= 1e-6, f"[spmd] alltoall P off replicated by {rel}")
        kl_a = recs[0]["a2a"]["kl"]
        check(abs(kl_a - float(l1[-1])) <= 0.01,
              f"[spmd] alltoall final KL {kl_a} vs replicated {l1[-1]}")
        print(f"[spmd] alltoall over {SPMD_PROCESSES} processes: P "
              f"(width {recs[0]['a2a_width']}) ids equal to replicated's, "
              f"values within rtol {rel:.3e}; the job: layout "
              f"{recs[0]['a2a']['layout']}, final KL {kl_a:.6f} "
              f"(replicated {float(l1[-1]):.6f}), launches a rank "
              f"{[r_['a2a']['launches'] for r_ in recs]}, "
              f"{[round(r_['a2a']['seconds'], 2) for r_ in recs]} s")
        b1_cross = sum(r_["a2a"]["launches"]["B1"] for r_ in recs)
        check(b1_cross == SPMD_PROCESSES * SPMD_PROCESSES,
              f"[spmd] the alltoall job launched B1 {b1_cross} times")

        rcs, secs, outs = spmd_wait("--symStrict", jobs.pop(0),
                                    timeout=SPMD_TIMEOUT_S + 120)
        check(all(rc != 0 for rc in rcs)
              and all("--symStrict set" in out for out in outs),
              f"[spmd] --symStrict: exit codes {rcs}")
        print(f"[spmd] --symMode alltoall --symSlack 1 --symWidth 8 "
              f"--symStrict on {SPMD_STRICT_ROWS} of the blobs: every rank "
              f"exits non-zero ({rcs}) in {secs:.1f} s (group timeout "
              f"{SPMD_TIMEOUT_S} s)")
    finally:
        for procs, logs, _ in jobs:  # jobs a failed check left running
            for p, log in zip(procs, logs):
                p.kill()
                p.wait()
                log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[spmd] phase {time.perf_counter() - t_phase:.1f} s")
    name, src, repl = KERNEL_META["B1"]
    b6_name, b6_src, b6_repl = KERNEL_META["B6"]
    return [kernel_record("B1", f"{name} cross", src, repl, b1_cross,
                          hop_err, hop_t, hop_bnd),
            kernel_record("B6", f"{b6_name} n_valid", b6_src, b6_repl,
                          sum(b6), b6_err, b6_t, b6_bnd)]



class PeakTracker:
    """Allocated and reserved peaks of the card's caching allocator over
    marked intervals: :meth:`mark` folds the peak since the last mark into
    a running maximum and resets the counters, so nested measurements
    keep the enclosing interval's peak.  Both are counted above what the
    process held at construction (after ``empty_cache``): the run's own
    allocations, and its own growth of the cache — the segments earlier
    work left pinned by a live tensor are not the run's."""

    def __init__(self):
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self.base = torch.cuda.memory_allocated()
        self.base_reserved = torch.cuda.memory_reserved()
        self.alloc = self.reserved = 0
        torch.cuda.reset_peak_memory_stats()

    def mark(self) -> tuple[int, int]:
        """(allocated, reserved) peak since the last mark, above what was
        held at construction."""
        import torch
        torch.cuda.synchronize()
        a = torch.cuda.max_memory_allocated() - self.base
        r = torch.cuda.max_memory_reserved() - self.base_reserved
        torch.cuda.reset_peak_memory_stats()
        self.alloc, self.reserved = max(self.alloc, a), max(self.reserved, r)
        return a, r


def memory_cfg(tag, n):
    from tsne_flink_tpu_torch import TsneConfig
    _, _, _, _, kw = MEMORY_RUNS[tag]
    perp = PERPLEXITY_CELLS if tag == "large" else PERPLEXITY
    lr = fitsne_learning_rate(n) if tag == "large" else 1000.0
    return TsneConfig(perplexity=perp, iterations=ITERATIONS,
                      learning_rate=lr, **kw)


def memory_plan(tag, n, d, cfg, width=None):
    """The run's plan as the fleet's admission takes it: its own assembly
    and, once the kNN graph exists, the graph's row-width bound
    (``ops/affinities.width_bound``; None before it)."""
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    data, k, method, assembly, _ = MEMORY_RUNS[tag]
    return PlanConfig(
        n=n, d=d, k=k, backend="cuda",
        dtype="float64" if data.endswith("64") else "float32",
        n_components=cfg.n_components,
        iterations=cfg.iterations, knn_method=method,
        repulsion=cfg.repulsion, theta=cfg.theta,
        assembly=assembly or "auto", attraction=cfg.attraction,
        sym_width=width, row_chunk=cfg.row_chunk, fft_grid=cfg.fft_grid,
        name=tag)


def charged_plan(plan):
    """The plan whose peak admission charges (``analysis/audit/hbm
    .charged_plans``: the widest rows the run may build)."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import (charged_plans,
                                                         plan_hbm_report)
    return max(charged_plans(plan),
               key=lambda p: plan_hbm_report(p)["peak_hbm_est"])


def stage_peaks(tag, x_np, cfg, tracker_hook=None):
    """One run of ``tag``'s configuration (prepare, plan, optimize; the
    steps ``tsne_embed`` takes), each stage's allocated peak from a mark
    at its start: ``({stage: (allocated, reserved)}, label, width, y,
    bound)`` — ``width`` the rows' width the run built, ``bound`` the kNN
    graph's row-width bound (read after the last mark).
    ``tracker_hook(tracker)`` may install finer marks (the diagnosis
    script's)."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import (_plan_layout,
                                                  init_working_set, optimize)
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    _, k, method, assembly, _ = MEMORY_RUNS[tag]
    torch.cuda.empty_cache()
    tr = PeakTracker()
    if tracker_hook is not None:
        tracker_hook(tr)
    peaks = {}
    x = torch.as_tensor(x_np, device="cuda")

    def on_stage(stage, secs, cache):
        peaks[stage] = tr.mark()

    prep = prepare(x, neighbors=k, knn_method=method, metric=cfg.metric,
                   seed=0, perplexity=cfg.perplexity,
                   assembly=assembly or "auto", device="cuda",
                   on_stage=on_stage)
    label, width = prep.label, int(prep.jidx.shape[1])
    if prep.extra_edges is not None:
        edges, csr = prep.extra_edges, None
    else:
        edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    peaks["plan"] = tr.mark()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_working_set(gen, x.shape[0], cfg.n_components, x.dtype,
                             "cuda")
    out = optimize(state, prep.jidx, prep.jval, cfg, edges=edges,
                   edges_extra=label == "blocks", csr=csr)
    peaks["optimize"] = tr.mark()
    y = out[0].y
    return peaks, label, width, y, width_bound(prep.idx)


def runtime_memory(data, context, only=None):
    """[runtime] 1: the memory model against the card at every full-size
    run of the smoke, as the fleet's admission charges it once the run's
    kNN graph exists: ``analysis/audit/hbm.stage_terms`` of the charged
    plan (:func:`charged_plan`) at the graph's row-width bound, not at the
    width the affinity stage went on to build.  Each stage's predicted and
    measured peak, and two gates on each run's peak, each measured <=
    predicted <= 2 x measured: the model's allocated terms against
    ``torch.cuda.max_memory_allocated``, and its whole peak (the
    allocator's reserve and the CUDA context included) against the run's
    footprint on the card, its ``torch.cuda.max_memory_reserved`` growth
    plus ``context`` (measured by :func:`runtime_context`).  The charge
    before the graph exists (the widest rows the plan allows) is printed
    beside it, ungated.  Returns {tag: (predicted peak, measured
    allocated, measured footprint, plan)}."""
    import torch
    from tsne_flink_tpu_torch.analysis.audit.hbm import (allocated_peak,
                                                         charged_peak_bytes,
                                                         stage_terms)
    out, misses = {}, []
    for tag in only or MEMORY_RUNS:
        x_np = data[MEMORY_RUNS[tag][0]]
        n, d = x_np.shape
        cfg = memory_cfg(tag, n)
        t0 = time.perf_counter()
        peaks, label, width, _, bound = stage_peaks(tag, x_np, cfg)
        plan = charged_plan(memory_plan(tag, n, d, cfg, bound))
        terms = stage_terms(plan)
        before = charged_peak_bytes(memory_plan(tag, n, d, cfg))
        measured = {"knn": peaks["knn"], "affinities": peaks["affinities"],
                    "optimize": (max(peaks["plan"][0], peaks["optimize"][0]),
                                 max(peaks["plan"][1],
                                     peaks["optimize"][1]))}
        for st, (a, r) in measured.items():
            pa = allocated_peak(terms[st])
            print(f"[runtime] memory {tag} {st}: allocated predicted "
                  f"{pa / 2**30:.3f} GiB, measured {a / 2**30:.3f} GiB "
                  f"(ratio {pa / max(a, 1):.3f}); with the reserve and the "
                  f"context predicted {terms[st]['peak'] / 2**30:.3f} GiB, "
                  f"footprint {(r + context) / 2**30:.3f} GiB; terms "
                  + json.dumps({t: (v if isinstance(v, str)
                                    else round(v / 2**30, 4))
                                for t, v in terms[st].items()}))
        pa = max(allocated_peak(t) for t in terms.values())
        pt = max(t["peak"] for t in terms.values())
        alloc = max(a for a, _ in measured.values())
        foot = max(r for _, r in measured.values()) + context
        out[tag] = (pt, alloc, foot, plan)
        ok = alloc <= pa <= 2 * alloc and foot <= pt <= 2 * foot
        print(f"[runtime] memory {tag} ({label}, width {width}; the "
              f"graph's bound {bound}, charged as {plan.assembly} at "
              f"{plan.sym_width}): run peak allocated predicted "
              f"{pa / 2**30:.3f} GiB / measured {alloc / 2**30:.3f} GiB = "
              f"{pa / alloc:.3f}; footprint predicted {pt / 2**30:.3f} GiB "
              f"/ measured {foot / 2**30:.3f} GiB = {pt / foot:.3f} "
              f"{'(both within [1, 2])' if ok else 'MISS'}; charged before "
              f"the graph {before / 2**30:.3f} GiB ({before / foot:.3f} x "
              f"the footprint); {time.perf_counter() - t0:.1f} s")
        # every stage's allocated peak within its prediction too: a stage
        # that misses is a term the model lacks
        short = [st for st, (a, _) in measured.items()
                 if a > allocated_peak(terms[st])]
        if not ok or short or width > bound or before < int(pt):
            misses.append((tag, short))
        torch.cuda.empty_cache()
    check(not misses, f"[runtime] the memory model misses {misses}: "
          "predicted must lie in [measured, 2 x measured] for the run and "
          "above the measured for each stage, the built width within the "
          "graph's bound, the charge before the graph above")
    return out


CONTEXT_CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn
free0, total = torch.cuda.mem_get_info()
x = torch.randn(4096, 64, device="cuda")
fused_knn(x, 16)
(x @ x.T).sum()
torch.fft.rfft2(torch.randn(256, 256, device="cuda"))
torch.cuda.synchronize()
free, total = torch.cuda.mem_get_info()
del x
print(json.dumps({"used": total - free,
                  "reserved": torch.cuda.memory_reserved(),
                  "libraries": torch.cuda.memory_allocated()}))
"""


def runtime_context():
    """The bytes one CUDA process holds on the card outside the caching
    allocator (context, modules, library handles): a fresh process runs
    B1, a matmul and an FFT, then reports the card's used bytes; less
    what was used before it started and its own reserved cache."""
    import subprocess
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    got = subprocess.run([sys.executable, "-c", CONTEXT_CHILD, ROOT],
                         capture_output=True, text=True, timeout=300)
    check(got.returncode == 0, f"[runtime] context probe failed: "
          f"{got.stderr[-2000:]}")
    rec = json.loads(got.stdout.strip().splitlines()[-1])
    ctx = rec["used"] - (total - free0) - rec["reserved"]
    from tsne_flink_tpu_torch.analysis.audit.hbm import (
        CUDA_CONTEXT_BYTES, LIBRARY_WORKSPACE_BYTES)
    print(f"[runtime] a CUDA process's context (outside the allocator, "
          f"after B1, a matmul and an FFT): {ctx / 2**20:.1f} MiB (the "
          f"model charges {CUDA_CONTEXT_BYTES / 2**20:.1f} MiB); its "
          f"libraries' workspaces (allocated, no tensor of its own alive): "
          f"{rec['libraries'] / 2**20:.1f} MiB (the model charges "
          f"{LIBRARY_WORKSPACE_BYTES / 2**20:.1f} MiB)")
    return ctx


#: [runtime] 2: the real OOM — the [full] configuration under a cap of
#: the caching allocator (torch.cuda.set_per_process_memory_fraction)
#: between the degraded plan's footprint and the default's
OOM_RUN, OOM_CAP_GIB = "full", 4.0

OOM_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
    run_plan_from_fit, supervised_embed)
cap = float(sys.argv[2])
torch.cuda.set_per_process_memory_fraction(
    cap / torch.cuda.get_device_properties(0).total_memory)
x, _ = cs.make_data()
tag = cs.OOM_RUN
_, k, method, assembly, _ = cs.MEMORY_RUNS[tag]
cfg = cs.memory_cfg(tag, x.shape[0])
sup = Supervisor(run_plan_from_fit(x.shape[0], x.shape[1], k, cfg,
                                   "auto", method), max_retries=2)
marks = []
t0 = time.perf_counter()
run = supervised_embed(x, cfg, supervisor=sup, neighbors=k,
                       knn_method=method, seed=0,
                       on_stage=lambda st, s, c: marks.append(
                           (st, time.perf_counter() - t0)))
y = run.state.y.cpu().numpy()
np.save(sys.argv[3], y)
print(json.dumps({"seconds": time.perf_counter() - t0, "marks": marks,
                  "events": sup.events, "degradations": sup.degradations,
                  "releases": sup.releases,
                  "peak_reserved": torch.cuda.max_memory_reserved()}))
"""


def runtime_real_oom_start(tmp):
    """Start :func:`runtime_real_oom`'s capped subprocess; returns it, its
    output path and its start."""
    out = os.path.join(tmp, "oom_y.npy")
    proc = subprocess.Popen([sys.executable, "-c", OOM_CHILD, ROOT,
                             str(OOM_CAP_GIB * 2**30), out],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out, time.perf_counter()


def child_result(proc, timeout=600):
    """(exit code, stdout, stderr) of a started subprocess, which is killed
    if it outlives ``timeout``."""
    try:
        so, se = proc.communicate(timeout=timeout)
    finally:
        proc.kill()  # a no-op for one that ended
        proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, so, se)


def runtime_real_oom(tmp, started=None):
    """[runtime] 2: a real CUDA OOM recovered by the ladder.  A subprocess
    caps its allocator at OOM_CAP_GIB and runs the supervised [full]
    configuration: the split rows' [N, S] planes (8.4 GiB) do not fit, the
    affinity stage runs out of memory for real, the ladder takes the
    blocks assembly (rung 2; rung 1's tile budget holds nothing of the
    stage on the card) and the relaunch completes.  Gate: the degradation
    is recorded, and the embedding equals, bit for bit, a run given the
    blocks assembly from the start.  ``started``: the subprocess
    :func:`runtime_real_oom_start` started (else it starts here)."""
    import torch
    from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
                                                         supervised_embed)
    proc, out, t0 = started or runtime_real_oom_start(tmp)
    got = child_result(proc)
    check(got.returncode == 0, f"[runtime] the capped run failed: "
          f"{got.stderr[-3000:]}")
    rec = json.loads(got.stdout.strip().splitlines()[-1])
    acts = [d["action"] for d in rec["degradations"]]
    ooms = [e for e in rec["events"] if e["type"] == "oom"]
    print(f"[runtime] real OOM: cap {OOM_CAP_GIB} GiB; events "
          f"{[e['type'] for e in rec['events']]}; degradations {acts}; "
          f"the OOM: {ooms[0]['error'][:120] if ooms else None!r}")
    print(f"[runtime] real OOM: stage marks (s from start) "
          f"{json.dumps(rec['marks'])}; the run {rec['seconds']:.3f} s "
          f"({time.perf_counter() - t0:.1f} s with the process); freed "
          f"between attempts {[r['freed_bytes'] / 2**30 for r in rec['releases']]}"
          f" GiB; peak reserved {rec['peak_reserved'] / 2**30:.3f} GiB")
    check(acts == ["assembly-blocks"] and len(ooms) == 1
          and ooms[0]["stage"] == "affinities",
          f"[runtime] real OOM: ladder steps {acts}, OOMs {ooms}")
    x, _ = make_data()
    _, k, method, _, _ = MEMORY_RUNS[OOM_RUN]
    cfg = memory_cfg(OOM_RUN, x.shape[0])
    ref = supervised_embed(x, cfg, supervisor=Supervisor(None),
                           neighbors=k, knn_method=method, seed=0,
                           affinity_assembly="blocks")
    check(same_bits(np.load(out), ref.state.y.cpu().numpy()),
          "[runtime] real OOM: the recovered run differs from blocks from "
          "the start")
    del ref
    torch.cuda.empty_cache()
    print("[runtime] real OOM: recovered bit for bit as blocks from the "
          "start")


def _cli_argv(coo, d, out, tmp, *extra):
    return ["--input", coo, "--output", os.path.join(tmp, out), "--loss",
            os.path.join(tmp, out + ".loss"), "--dimension", str(d),
            "--perplexity", str(PERPLEXITY), "--knnMethod", "bruteforce",
            "--iterations", str(REHEARSAL_ITERS), "--noCache", *extra]


def _cli_child(argv, timeout=600):
    return child_result(_cli_child_start(argv), timeout)


def _cli_child_start(argv):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tsne_flink_tpu_torch.utils.cli import main\n"
            "main(%r)\n") % (ROOT, argv)
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


REHEARSAL_N, REHEARSAL_ITERS = 20_000, 100


def runtime_children_start(x_np, tmp):
    """Start [runtime]'s subprocesses at once: the real OOM's capped run,
    and on 20,000 of the blobs (written as a COO file) the
    ``kill@optimize:seg1`` run and the ``--stageTimeout 0.01`` run.
    Returns what :func:`runtime_real_oom` and :func:`runtime_rehearsals`
    wait for."""
    coo = os.path.join(tmp, "blobs20k.csv")
    write_coo(coo, x_np[:REHEARSAL_N])
    d = x_np.shape[1]
    ck = os.path.join(tmp, "rehearsal.npz")
    t0 = time.perf_counter()
    kill = _cli_child_start(_cli_argv(
        coo, d, "killed.csv", tmp, "--checkpoint", ck, "--checkpointEvery",
        "50", "--fatCheckpoint", "--faultPlan", "kill@optimize:seg1"))
    late = _cli_child_start(_cli_argv(coo, d, "late.csv", tmp,
                                      "--stageTimeout", "0.01"))
    return runtime_real_oom_start(tmp), (coo, ck, kill, late, t0)


def runtime_rehearsals(x_np, tmp, started=None):
    """[runtime] 3: the fault plans on the card, on 20,000 of the blobs:
    ``oom@knn`` completes through the ladder with the clean run's bits;
    ``kill@optimize:seg1`` in a subprocess, then ``--resume``, gives the
    uninterrupted run's bits; ``nan@optimize`` is rolled back by the
    sentinel; ``corrupt@checkpoint`` is caught with its path and hash; a
    ``--stageTimeout`` too small exits 124.  ``started``: the two
    subprocesses :func:`runtime_children_start` started (else they start
    here, one after the other)."""
    import torch
    from tsne_flink_tpu_torch.runtime import faults
    from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
                                                         supervised_embed)
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    from tsne_flink_tpu_torch.utils.cli import main as cli_main
    from tsne_flink_tpu_torch import TsneConfig
    x = x_np[:REHEARSAL_N]
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=REHEARSAL_ITERS)
    t0 = time.perf_counter()
    clean = supervised_embed(x, cfg, supervisor=Supervisor(None),
                             neighbors=K, seed=0).state.y.cpu().numpy()
    faults.activate("oom@knn")
    try:
        sup = Supervisor(run_plan_20k(x, cfg), retry_backoff=0.0)
        y = supervised_embed(x, cfg, supervisor=sup, neighbors=K,
                             seed=0).state.y.cpu().numpy()
    finally:
        faults.activate(None)
    acts = [d["action"] for d in sup.degradations]
    print(f"[runtime] oom@knn: {acts}, events "
          f"{[e['type'] for e in sup.events]}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(acts == ["shrink-knn-tiles"] and same_bits(y, clean),
          "[runtime] oom@knn: not recovered with the clean run's bits")
    faults.activate("nan@optimize:seg2")
    try:
        sup = Supervisor(None, health_check=True)
        run = supervised_embed(x, cfg, supervisor=sup, neighbors=K, seed=0)
    finally:
        faults.activate(None)
    rb = [e for e in sup.events if e["type"] == "sentinel-rollback"]
    print(f"[runtime] nan@optimize:seg2: rollbacks {json.dumps(rb)}")
    check(len(rb) == 1 and bool(torch.isfinite(run.state.y).all()),
          "[runtime] nan@optimize: not rolled back")
    path = os.path.join(tmp, "corrupt.npz")
    faults.activate("corrupt@checkpoint")
    try:
        ckpt.save(path, run.state, REHEARSAL_ITERS, run.losses)
    finally:
        faults.activate(None)
    try:
        ckpt.load(path)
        caught = None
    except ckpt.CheckpointCorrupt as e:
        caught = str(e)
    print(f"[runtime] corrupt@checkpoint: {caught}")
    check(caught is not None and path in caught and "hash" in caught,
          "[runtime] corrupt@checkpoint: not caught with path and hash")
    d = x.shape[1]
    if started is None:
        coo = os.path.join(tmp, "blobs20k.csv")
        write_coo(coo, x)
        ck = os.path.join(tmp, "rehearsal.npz")
        t1 = time.perf_counter()
        got = _cli_child(_cli_argv(coo, d, "killed.csv", tmp,
                                   "--checkpoint", ck, "--checkpointEvery",
                                   "50", "--fatCheckpoint", "--faultPlan",
                                   "kill@optimize:seg1"))
    else:
        coo, ck, kill, late, t1 = started
        got = child_result(kill)
    print(f"[runtime] kill@optimize:seg1: exit {got.returncode} "
          f"{time.perf_counter() - t1:.1f} s after its start")
    check(got.returncode == -9 and os.path.exists(ck),
          f"[runtime] kill@optimize:seg1: exit {got.returncode} "
          f"{got.stderr[-1500:]}")
    with contextlib.redirect_stderr(io.StringIO()):
        cli_main(_cli_argv(coo, d, "resumed.csv", tmp, "--resume", ck))
        cli_main(_cli_argv(coo, d, "whole.csv", tmp))
    same = all(open(os.path.join(tmp, a), "rb").read()
               == open(os.path.join(tmp, b), "rb").read()
               for a, b in (("resumed.csv", "whole.csv"),
                            ("resumed.csv.loss", "whole.csv.loss")))
    print(f"[runtime] --resume after the kill equals the uninterrupted "
          f"run: {same}")
    check(same, "[runtime] the resumed run differs from the uninterrupted")
    if started is None:
        t1 = time.perf_counter()
        got = _cli_child(_cli_argv(coo, d, "late.csv", tmp,
                                   "--stageTimeout", "0.01"))
    else:
        got = child_result(late)
    print(f"[runtime] --stageTimeout 0.01: exit {got.returncode} "
          f"{time.perf_counter() - t1:.1f} s after its start")
    check(got.returncode == 124 and "watchdog" in got.stderr,
          f"[runtime] --stageTimeout: exit {got.returncode}")
    print(f"[runtime] rehearsals {time.perf_counter() - t0:.1f} s")


def run_plan_20k(x, cfg):
    from tsne_flink_tpu_torch.runtime.supervisor import run_plan_from_fit
    return run_plan_from_fit(x.shape[0], x.shape[1], K, cfg, "auto",
                             "bruteforce")


FLEET_ITERS = 300


def runtime_fleet(x_np, data, tmp, context, serial=False):
    """[runtime] 4: three config-2-sized jobs (60,000 x 784 ``data`` blobs,
    bruteforce, 300 iterations, seeds 0-2) as fleet children on the one
    card; job 1 carries ``kill@job:1`` and retries.  Each job is admitted
    at the widest rows its plan allows (its kNN graph does not exist yet)
    and re-admitted at its graph's row-width bound once the child reports
    it.  The budget admits two jobs at the first charge and neither the
    third nor its blocks degrade, so the third queues until a charge falls
    or a job ends.  Gates: every job completes; the third queued; the sum
    of the charges fits the budget at every admission and re-admission,
    and no re-admission raises a charge; every job's embedding equals its
    solo run bit for bit; every job's measured footprint (its peak
    reserved bytes plus the measured context) is at most its charge.
    With ``serial``, the same three jobs one at a time."""
    import torch
    from dataclasses import replace
    from tsne_flink_tpu_torch.analysis.audit.hbm import ALLOCATOR_RESERVE_FRACTION
    from tsne_flink_tpu_torch.runtime.admission import predicted_peak_bytes
    from tsne_flink_tpu_torch.runtime.fleet import Fleet, JobSpec, job_plan
    inp = os.path.join(tmp, f"{data}60k.npy")
    np.save(inp, x_np)
    jobs = [JobSpec(name=f"{data}{i}", input=inp, iterations=FLEET_ITERS,
                    perplexity=PERPLEXITY, seed=i) for i in range(3)]
    plan = job_plan(jobs[0])
    peak = predicted_peak_bytes(plan)
    blocks = predicted_peak_bytes(replace(plan, assembly="blocks"))
    budget = 2 * peak + blocks // 2
    print(f"[runtime] fleet {data}: each job charged {peak / 2**30:.3f} GiB "
          f"before its graph exists ({blocks / 2**30:.3f} GiB as blocks); "
          f"budget {budget / 2**30:.3f} GiB (admits two)")
    rec = Fleet(jobs, os.path.join(tmp, f"fleet_{data}"), budget_bytes=budget,
                fault_plan="kill@job:1", retries=1, backoff_base=0.0).run()
    fl = rec["fleet"]
    print(f"[runtime] fleet {data}: {json.dumps(fl)}; admissions (job, in "
          f"use, charge) {json.dumps(rec['admissions'])}; re-admissions "
          f"{json.dumps(rec['readmissions'])}")
    check(fl["completed"] == 3 and fl["queue_depth_max"] >= 1
          and fl["retries"] == 1 and fl["max_running"] >= 2,
          f"[runtime] fleet {data}: {fl}")
    check(all(u + p <= budget for _, u, p in rec["admissions"]),
          f"[runtime] fleet {data}: an admission over the budget")
    check(all(r["after"] <= r["before"] and r["in_use"] <= budget
              for r in rec["readmissions"])
          and {r["job"] for r in rec["readmissions"]} == {
              j.name for j in jobs},
          f"[runtime] fleet {data}: re-admissions {rec['readmissions']}")
    for job in rec["jobs"]:
        r = job["record"]
        mem = r["memory"]
        foot = mem["peak_reserved"] + context
        print(f"[runtime] fleet {job['name']}: attempts {job['attempts']}, "
              f"{job['seconds']:.2f} s, width bound {r['width_bound']}, "
              f"stages {json.dumps(r['stages'])}; peak allocated "
              f"{mem['peak_allocated'] / 2**30:.3f} GiB, reserved "
              f"{mem['peak_reserved'] / 2**30:.3f} GiB (the allocator's "
              f"reserve {mem['peak_reserved'] / mem['peak_allocated'] - 1:.3f}"
              f" of the allocated peak; the model charges "
              f"{ALLOCATOR_RESERVE_FRACTION}), footprint with the context "
              f"{foot / 2**30:.3f} GiB <= charged "
              f"{job['predicted_peak'] / 2**30:.3f} GiB "
              f"({foot / job['predicted_peak']:.3f})")
        check(foot <= job["predicted_peak"],
              f"[runtime] fleet {job['name']}: footprint over its charge")
    for spec, job in zip(jobs, rec["jobs"]):
        solo = JobSpec.from_dict({**spec.as_dict(), "name": "solo",
                                  "out": "", "record": ""})
        y = np.load(job["out"])
        check(same_bits(y, _solo_y(solo)),
              f"[runtime] fleet {job['name']} differs from its solo run")
    torch.cuda.empty_cache()
    print(f"[runtime] fleet {data}: every job equals its solo run bit for "
          "bit")
    if not serial:
        return
    one = Fleet([JobSpec.from_dict({**s.as_dict(), "name": s.name + "s",
                                    "out": "", "record": ""})
                 for s in jobs], os.path.join(tmp, f"serial_{data}"),
                budget_bytes=budget, max_concurrent=1).run()["fleet"]
    print(f"[runtime] fleet {data} wall {fl['seconds']:.3f} s (3 jobs, up to "
          f"{fl['max_running']} at once, one killed and retried) against "
          f"{one['seconds']:.3f} s for the three one at a time "
          f"({fl['seconds'] / one['seconds']:.3f})")


def _solo_y(spec):
    from tsne_flink_tpu_torch.runtime.fleet import JobSpec, run_job
    import tempfile
    fd, out = tempfile.mkstemp(suffix=".npy")
    os.close(fd)
    try:
        run_job(JobSpec.from_dict({**spec.as_dict(), "out": out}))
        return np.load(out)
    finally:
        os.remove(out)


class HostReads:
    """Counts, over a ``with`` block, the port's reads of device state: a
    synchronize, a scalar read, a truth test, a copy to the host — all of
    them, and those made while the segment runner runs the optimize loop
    (``loop``: the reads at report boundaries).  The profiler's own
    synchronize when it stops (``--profile``) is not the port's and is
    not counted."""

    NAMES = (("cuda", "synchronize"), ("Tensor", "item"),
             ("Tensor", "__bool__"), ("Tensor", "tolist"),
             ("Tensor", "cpu"))

    def __enter__(self):
        import torch
        from tsne_flink_tpu_torch.runtime import segments
        self.count = self.loop = 0
        self._in_loop = False
        self._saved = []
        for owner, name in self.NAMES:
            obj = torch.cuda if owner == "cuda" else torch.Tensor
            real = getattr(obj, name)
            self._saved.append((obj, name, real))

            def counted(*a, _real=real, **kw):
                caller = sys._getframe(1).f_globals.get("__name__", "")
                if not caller.startswith(("torch.profiler",
                                          "torch.autograd")):
                    self.count += 1
                    self.loop += self._in_loop
                return _real(*a, **kw)
            setattr(obj, name, counted)
        real_run = segments.run_segments
        self._saved.append((segments, "run_segments", real_run))

        def run(*a, **kw):
            self._in_loop = True
            try:
                return real_run(*a, **kw)
            finally:
                self._in_loop = False
        segments.run_segments = run
        return self

    def __exit__(self, *exc):
        for obj, name, real in self._saved:
            setattr(obj, name, real)
        return False


def runtime_tracing(x_np, tmp):
    """[runtime] 5: config 2's command line (``--knnMethod project --theta
    0.5``; REHEARSAL_N of the 60,000 x 784 blobs from a COO CSV, cut for
    time: the ingest dominates each run) plain, with ``--trace
    --metricsOut``, with ``--profile`` as well, and plain again: the same
    output bytes, the same launches and the same host reads (all, and in
    the optimize loop); the trace holds the JAX package's span names for
    the stages the port runs, the profile directory is not empty; each
    one's wall time against the plain runs'; then the profiler's wall
    cost in a CLI process of its own, as a user pays it (two processes,
    the same output bytes)."""
    from tsne_flink_tpu_torch.models import autopilot as ap
    coo = os.path.join(tmp, f"blobs{REHEARSAL_N}.csv")
    write_coo(coo, x_np[:REHEARSAL_N])
    f = x_np.shape[1]

    def argv(out, *extra):
        return ["--input", coo, "--output", os.path.join(tmp, out),
                "--loss", os.path.join(tmp, out + ".loss"), "--dimension",
                str(f), "--perplexity", str(PERPLEXITY), "--iterations",
                str(ITERATIONS), "--knnMethod", "project", "--theta", "0.5",
                "--noCache", *extra]
    trace, metrics = os.path.join(tmp, "t.json"), os.path.join(tmp, "m.json")
    prof = os.path.join(tmp, "prof")
    runs = {}
    for tag, extra in (("plain", ()),
                       ("traced", ("--trace", trace, "--metricsOut",
                                   metrics)),
                       ("profiled", ("--trace", trace, "--metricsOut",
                                     metrics, "--profile", prof)),
                       ("plain2", ())):
        ap.reset_host_reads()
        t0 = time.perf_counter()
        with HostReads() as reads:
            y, counts, stages, _ = run_cli(f"runtime {tag}", argv(
                tag + ".csv", *extra))
        runs[tag] = (y, counts, (reads.count, reads.loop, ap.host_reads()),
                     time.perf_counter() - t0)
        print(f"[runtime] tracing {tag}: {runs[tag][3]:.3f} s, host reads "
              f"{reads.count} ({reads.loop} in the optimize loop, "
              f"{ap.host_reads()} by the autopilot)")
    plain = runs["plain"]
    for tag in ("traced", "profiled", "plain2"):
        y, counts, reads, _ = runs[tag]
        check(same_bits(plain[0], y) and plain[1] == counts
              and plain[2] == reads,
              f"[runtime] tracing: {tag} changed the bits, launches or "
              "host reads")
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    want = {"cli.run", "prepare.knn", "prepare.affinities",
            "knn.zorder_seed", "knn.zorder_cycles", "knn.merge",
            "knn.refine", "optimize.segment"}
    snap = json.load(open(metrics))
    base = (plain[3] + runs["plain2"][3]) / 2
    print(f"[runtime] tracing: span names {sorted(names)}; metrics keys "
          f"{sorted(snap)}; profile files {os.listdir(prof)}; wall against "
          f"the plain runs' mean {base:.3f} s: --trace --metricsOut "
          f"{runs['traced'][3] - base:+.3f} s, with --profile "
          f"{runs['profiled'][3] - base:+.3f} s")
    check(want <= names and os.listdir(prof),
          f"[runtime] tracing: missing spans {want - names} or profile")
    # the profiler's wall cost in a process of its own, as a user pays it:
    # the in-process runs above share a profiler that [serve] started
    fresh = {}
    for tag, extra in (("fresh", ()),
                       ("fresh_profiled", ("--profile",
                                           os.path.join(tmp, "prof2")))):
        t0 = time.perf_counter()
        got = _cli_child(argv(tag + ".csv", *extra))
        fresh[tag] = time.perf_counter() - t0
        check(got.returncode == 0, f"[runtime] tracing {tag}: exit "
              f"{got.returncode} {got.stderr[-1500:]}")
        stages = [ln for ln in got.stderr.splitlines()
                  if ln.startswith("# stages s:")]
        print(f"[runtime] tracing {tag} (a process of its own): "
              f"{fresh[tag]:.3f} s with the process's start; "
              f"{stages[-1] if stages else 'no stage line'}")
    same = (open(os.path.join(tmp, "fresh.csv"), "rb").read()
            == open(os.path.join(tmp, "fresh_profiled.csv"), "rb").read())
    print(f"[runtime] tracing: --profile in a process of its own "
          f"{fresh['fresh_profiled'] - fresh['fresh']:+.3f} s; the same "
          f"output bytes: {same}")
    check(same, "[runtime] tracing: --profile changed the output")


def phase_runtime(x_np, xl_np, xc_np, tmp, serve_memory, context=None,
                  serial=False):
    """[runtime]: the memory model, a real OOM, the fault rehearsals, the
    fleet and tracing, on the card (queue A15).  ``context`` is the CUDA
    context [quorum] measured, else measured here.  The real OOM's and
    two rehearsals' subprocesses start first and run beside the memory
    runs (their gates are per process: a capped allocator, exit codes,
    bits).  ``serial`` also runs the latent fleet's jobs one at a time
    for its wall-clock ratio, and the fleet of the 60,000 x 784 blobs
    beside the latent blobs' (``scripts/runtime_phase_cuda.py``; the
    smoke leaves both out for time)."""
    t0 = time.perf_counter()
    if context is None:
        context = runtime_context()
    for tag, pred, meas in serve_memory:
        print(f"[runtime] memory serve {tag}: transform_peak "
              f"{pred / 2**20:.1f} MiB, measured {meas / 2**20:.1f} MiB "
              f"(resident model included), ratio {pred / meas:.3f}")
    oom, rehearsal = runtime_children_start(x_np, tmp)
    try:
        runtime_memory({"blobs": x_np, "latent": xl_np, "cells": xc_np,
                        "blobs64": x_np.astype(np.float64)}, context)
        runtime_real_oom(tmp, oom)
        runtime_rehearsals(x_np, tmp, rehearsal)
    finally:
        for proc in (oom[0], *rehearsal[2:4]):  # those a failed check left
            proc.kill()
            proc.wait()
    runtime_fleet(xl_np, "latent", tmp, context, serial=serial)
    if serial:
        runtime_fleet(x_np, "blobs", tmp, context)
    runtime_tracing(x_np, tmp)
    print(f"[runtime] phase {time.perf_counter() - t0:.1f} s")


class Laps:
    """Each phase's seconds, for the line before ``[done]``: a call closes
    the interval since the last one under ``name``."""

    def __init__(self):
        self.t = time.perf_counter()
        self.rows = []

    def __call__(self, name):
        now = time.perf_counter()
        self.rows.append((name, now - self.t))
        self.t = now

    def line(self):
        return "[phases] s: " + ", ".join(f"{name}={secs:.1f}"
                                          for name, secs in self.rows)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import tsne_flink_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tsne_smoke_")
    f64_cpu = None
    lap = Laps()
    try:
        name, count = phase_device()
        sass_lines = phase_build(sass_later=True)
        lap("device + build")
        # [f64]'s CPU reference runs beside the phases up to [f64]'s check
        f64_cpu = f64_cpu_start(tmp)
        x_np, labels = make_data()
        xl_np, labels_l, z_latent = make_latent_blobs()
        xc_np, labels_c, z_cells = make_cells()
        sass_lines()  # cuobjdump ran beside the data's making
        lap("data")
        errs, csr, rows, blocks = phase_kernels(x_np, xl_np, xc_np)
        errs["B6"], b6_shapes = phase_b6(x_np, xc_np)
        lap("kernels")
        for kid, e in phase_widths(x_np, xc_np).items():
            errs[kid] = max(errs.get(kid, 0.0), e)
        lap("widths")
        bf16_times, bf16_bnd, bf16_err = phase_bf16(x_np, xc_np)
        f64_errs, b1f_times, b1f_bnd, _, b1f_rows = phase_f64(x_np, xc_np)
        f64_errs["B6_f64"], b6f_shapes = phase_b6_f64(x_np, xc_np)
        lap("bf16 + f64 kernels")
        kernels, csr_kl, full, b1_ms, b2_ms = phase_full(x_np, labels,
                                                         errs, csr)
        bf16_counts = bf16_embed_gate(x_np, labels, csr_kl)
        kernels.insert(1, kernel_record(
            "B1_bf16", *KERNEL_META["B1_bf16"], bf16_counts["B1_bf16"],
            bf16_err, bf16_times, bf16_bnd))
        t_f64 = time.perf_counter()
        f64_counts, y64, _ = f64_embed_gate(x_np, labels, csr_kl)
        f64_t, f64_b, e_full64 = f64_full_kernels(y64, csr)
        del y64
        f64_rows = f64_routes(x_np, xl_np, labels, labels_l, csr_kl)
        print(f"[f64] the fits and routes {time.perf_counter() - t_f64:.1f} "
              "s")
        y_60k = full[0]
        rows_run = phase_rows(xl_np, labels_l, z_latent, rows, errs)
        phase_blocks(x_np, labels, blocks, csr_kl)
        project = phase_project(x_np, labels, b1_ms, b6_shapes,
                                os.path.join(tmp, "project.npz"))
        f64_project_gate(x_np, labels, project[3])
        lap("full .. project")
        y_bh = phase_bh(x_np, labels, y_60k, z_latent, project)
        lap("bh")
        phase_cli(x_np, xl_np, full, rows_run[:2], project, y_bh)
        lap("cli")
        bigk = phase_bigk(x_np, labels, xc_np)
        lap("bigk")
        wide = phase_wide(x_np, labels, csr)
        lap("wide")
        feats = phase_features(x_np)
        lap("features")
        (times, bnd, _), = [v for key, v in b6_shapes.items()
                            if key[0] == "cells"]
        counts, pass_t, pass_b, (e5, e4), large = phase_large(
            xc_np, labels_c, z_cells, y_60k, b2_ms, times[0])
        errs["B5"], errs["B4"] = max(errs["B5"], e5), max(errs["B4"], e4)
        for kid in ("B4", "B5"):
            kernels.append(kernel_record(kid, *KERNEL_META[kid], counts[kid],
                                         errs[kid], pass_t[kid],
                                         pass_b[kid]))
        kernels.append(kernel_record("B6", *KERNEL_META["B6"], counts["B6"],
                                     errs["B6"], times, bnd))
        t_l64, b_l64, e_l64 = f64_large_pass(large)
        f64_t.update(t_l64)
        f64_b.update(b_l64)
        f64_t["B1_f64"], f64_b["B1_f64"] = b1f_times, b1f_bnd
        (f64_t["B6_f64"], f64_b["B6_f64"], _), = [
            v for key, v in b6f_shapes.items() if key[0] == "cells"]
        large64, _ = f64_large_run(xc_np, labels_c, z_cells, large, b1f_rows)
        lap("large")
        f64_n = {**f64_counts, "B5_f64": f64_rows["B5_f64"],
                 "B6_f64": large64["B6_f64"]}
        for kid in ("B1_f64", "B2_f64", "B3_f64", "B4_f64", "B5_f64",
                    "B6_f64"):
            err = max(f64_errs.get(kid, 0.0), e_full64.get(kid, 0.0),
                      e_l64.get(kid, 0.0))
            kernels.append(kernel_record(kid, *KERNEL_META[kid], f64_n[kid],
                                         err, f64_t[kid], f64_b[kid]))
        w_errs, w_times, w_bnds, w_launch, w_run, w_64, _ = wide
        for kid in WIDE_FORMS:
            rec = kernel_record(kid, *KERNEL_META[kid], w_launch[kid],
                                w_errs[kid], w_times[kid], w_bnds[kid])
            rec["m"] = M_WIDE
            rec["max_abs_err_at_run"] = w_run[kid]
            if kid in w_64:
                rec["against_f64_at_run"] = {"kernel": w_64[kid][0],
                                             "plain_f32": w_64[kid][1]}
            kernels.append(rec)
        f_errs, f_times, f_bnds, f_launch, _ = feats
        for kid in ("B6u", "B6u_f64"):
            kernels.append(kernel_record(kid, *KERNEL_META[kid],
                                         f_launch[kid], f_errs[kid],
                                         f_times[kid], f_bnds[kid]))
        f64_card_vs_cpu(f64_cpu)
        phase_bh_large(large[0])
        phase_pilot(xl_np, labels_l, z_latent, (rows_run[0], rows_run[2],
                                                rows_run[3]), large)
        lap("f64 vs cpu, bh-large, pilot")
        serve, serve_counts = phase_serve(x_np, os.path.join(
            tmp, "project.npz"), large, xc_np, tmp)
        lap("serve")
        mesh_counts, b2_shard = phase_mesh(x_np, labels, full, csr_kl, rows,
                                           large, tmp)
        lap("mesh")
        del large
        for rec in kernels:
            kid = rec["name"].split()[0]
            rec["mesh_launches_per_shard"] = {
                cfg_: c[kid] for cfg_, c in mesh_counts.items()}
        kernels[[r["name"].split()[0] for r in kernels].index("B2")][
            "mesh_shard_ms"] = {f"mesh {d}": {"canonical_splits": c,
                                              "own_splits": o}
                                for d, (c, o) in b2_shard.items()}
        for rec in kernels:
            kid = rec["name"].split()[0]
            rec["serve_launches"] = serve_counts[kid]
            rec["serve"] = serve.get(kid)
        kernels[[r["name"].split()[0] for r in kernels].index("B5")][
            "serve_large"] = serve["B5_large"]
        for rec in kernels:
            if rec["name"].split()[0] in bigk:
                rec["bigk"] = bigk[rec["name"].split()[0]]
        kernels += phase_spmd(x_np, labels, csr_kl, b1_ms)
        lap("spmd")
        context = phase_quorum(x_np, os.path.join(tmp, "project.npz"),
                               tmp, serve["daemon"])
        lap("quorum")
        phase_diverging(x_np)
        phase_determinism(x_np, xl_np)
        lap("diverging + determinism")
        phase_runtime(x_np, xl_np, xc_np, tmp, serve["memory"],
                      context=context)
        lap("runtime")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if f64_cpu is not None:
            f64_cpu[0].kill()
            f64_cpu[0].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(lap.line())
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
