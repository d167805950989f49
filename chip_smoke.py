#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geobignn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # the phases below
    python3 chip_smoke.py --large       # the 1,310,720-face mesh (see the end)
    python3 chip_smoke.py --large-halo  # its 8-part halo step and serving (the end)
    python3 chip_smoke.py --campaign    # train to the JAX package's accuracy (the end)
    python3 chip_smoke.py --halo-conv   # halo convergence over seeds 7-11 (the end)
    python3 chip_smoke.py --probes      # the measuring scripts of examples/ (the end)

Phases, each printing its lines; any failure raises and the script exits
non-zero without the final result line:

  1. the card (nvidia-smi name and power limit); no CUDA device -> exit 2;
  2. build: the banded and the block-sparse kernels (csrc/banded_fwd.cu,
     banded_bwd.cu, blocksparse_fwd.cu, blocksparse_bwd.cu: one nvcc each
     for sm_90a, started together) and the native mesh library, timed;
  3. the serving path on a mesh whose levels all band: Predictor with
     Config() defaults and seeded random weights denoises
     add_noise(icosphere(5), 0.2, seed=0) — 20,480 faces in 2 patches —
     through predict_dir's body (60 update iterations, `{name}-60.obj`
     written to a temp dir).  A warm-up mesh runs eagerly
     (testing.eager_steps()) and records the kernels' inputs; then the
     main path on a fresh plan: its first patch runs eagerly and is
     captured, the second replays the CUDA graph.  Launch counts are zeroed
     just before and read just after, and the run is profiled: the device
     must run the banded aggregate-first kernel 18 times and the
     transform-first kernel 20 times, and nothing else (counted by kernel
     name, replays included); the wrappers count the eager patch and the
     capture, and the graph replayed once.  Wall time of a mesh whose plan
     is captured; the host build, one patch's forward and the update loop
     timed apart; then a patch's forward as a graph replay against the
     eager forward: outputs equal, time over 20 calls (median, min, max;
     CUDA events) and kernels per forward both ways;
  4. the same predict_mesh with device="cpu" (plain PyTorch versions)
     against the GPU run; then the dense-table convs on the card (plain
     torch, no kernel launched): predict_mesh under Config(reorder=False),
     and patch 0 with its band structures taken away against the same patch
     through the banded kernels in float32 compute;
  5. the serving path on a mesh whose patches disagree on a band (noise
     seed 1: TableWidths.merge drops the finest facet level's band and both
     patches run it block-sparse, 79 row blocks of 256 over K column
     blocks): the same body, counted the same way — the
     block-sparse forward 2 + 4 times (aggregate-first / transform-first),
     the banded forward 14 + 12 times, no backward; wall time after a
     warm-up; patch 0's forward on the card against device="cpu";
  6. every forward kernel, banded and block-sparse, against its plain
     version on the card, on the inputs the serving paths gave it (recorded
     during the warm-ups), timed with CUDA events, with its bound and the
     time of each kernel of its launch sequence (`parts_ms`: the operand or
     operand product, the window kernel, the output product; CUDA events
     inside the library, a mean over 5 calls); then the edge cases of
     geobignn_tpu_torch.testing (rows without a set slot, set slots on
     absent neighbours at both ends of the band, mask values 2 and 3, D
     under the clamp, a row and a node with more set slots than one batch
     of 32) through every aggregate kernel, forward and backward,
     banded and block-sparse, both compute dtypes, at 9 heads and at 6
     (FeaStGNNPrePool's), both schedules each, against the plain
     versions (`[edge]` lines), at tile 64, and #1-#4 at tile 384 (the
     halo parts' band at 1,310,720 faces) at the widths of its convs;
  7. the training path at the default model's full width, twice: an
     InMemoryDataset of two (noisy, clean) icosphere(5) pairs split into 4
     patches of 20,000 faces, first with noise seeds (0, 6), whose levels
     all band, then with seeds (1, 2), whose finest facet level is
     block-sparse (merged K = 9).  One recorded step on one patch must
     launch 9 / 10 banded kernels each way, or 7 / 6 banded and 1 / 2
     block-sparse each way; the gradient of every parameter on the card
     against the CPU's plain backward on the same weights, in bf16 and in
     float32, and in float32 both against the same step on the CPU in
     float64 (the plain versions with params, sample and aggregates in
     float64); float32 gradients with rematerialization on and off
     (bit-equal); per step with it on and off, the kernels launched and
     their summed durations (the profiler), the checkpointed calls and the
     step between CUDA events; with seeds (0, 6), 20 steps on one patch
     must lower its loss;
     then the main path, Trainer(Config(seed=0, max_epoch=2)).fit() —
     the first step eager and captured, the others replays of its CUDA
     graph — counts zeroed just before, read just after, and profiled: the
     device runs the step's kernels 8 times (by kernel name), the wrappers
     count the eager step and the capture; per-epoch loss, s/step and
     edges/s; then the graphed
     step against the eager one: 3 epochs of Trainer.fit with rotation on
     and the learning rate halved each epoch, parameters and Adam's moments
     bit-equal; per step, both ways, the time over 20 steps (median, min,
     max; CUDA events), the kernels launched, the device busy share
     (profile_train_step's profiler) and mfu_pct (train/roofline.py), the
     copy of the cached sample into the graph's inputs, and the index
     backward with autograd's scatter-add (before the gathers' custom
     backwards) and with the gathers' own; and each backward kernel against
     its plain backward on the
     inputs the path gave it (with a seeded gout), timed, with its bound
     and its parts (the operand product, the row operand, the row pass, the
     column pass, the x̄ and W̄ products; the banded ones from seeds (0, 6),
     the block-sparse ones from (1, 2)); then the fc heads' memory: the bf16
     facet head alone at N = 2^20 rows, forward and backward, in its row
     chunks rematerialized against one piece with every intermediate kept
     (peaks of torch.cuda.max_memory_allocated, at least 4 GiB apart);
 7b. the bench's shape: union_batch of 8 add_noise(icosphere(5), 0.2, seed=0)
     samples under Config(granularity=256), bf16 heads (N = 165,888 facet
     slots): one graphed training step through Trainer.fused_step, timed
     over 20 replays, its edges/s (branch_messages x 8) and mfu_pct; 3 more
     replays profiled, the device running 3 times the launches the graph
     recorded and the wrappers counting none; kernels #1-#4 at that N
     against their plain versions on the step's inputs;
 7c. [large], bench.py's `large` field: add_noise(icosphere(7), 0.2,
     seed=0), 327,680 faces, built whole as bench.py builds it (in a
     worker process, beside phases 15-17) into one
     batch-1 union sample (164,096 vertex and 327,936 facet rows; five of
     six levels a 256-row band with a boundary sub-band beside it, the
     coarsest vertex level a 384-row band), Config(seed=0,
     granularity=256), float32 activations, bf16 heads (2 facet-head row
     chunks, 1 vertex-head chunk), Adam at 1e-3, through Trainer.fused_step:
     3 steps run eagerly (recorded) against 3 graphed from the same start,
     parameters, Adam's moments and metric sums bit-equal; the eager
     step's peak memory and the graph pool's bytes; 20 graphed steps timed
     (median, min, max), edges/s, mfu_pct; 3 replays counted by kernel
     name (the capture's launches a step equal one a conv plus one for
     each conv of a level with a sub-band) and profiled (busy share); the
     step graphed and eager (_graph_and_eager); every distinct #1-#4 call
     of the step against its plain version (`[large-kernel]` lines); the
     forward against device="cpu" and, in float32, against every conv the
     table conv (POS_TOL_MEL / NORMAL_TOL);
  8. the run-directory path, through the entry points a user calls, at the
     default model's full width (Config() defaults, sub_size 20000), in a
     temp directory: a reference-layout corpus (Synthetic/{train,test}/
     {noisy,original} + train_list.txt / test_list.txt) of icosphere(5)
     meshes (train: noise seeds 1 and 2, test: seed 3);
     train(Config(max_epoch=2)) writes the run directory (params.json,
     ckpt_best.pkl, ckpt_last.pkl, metrics.jsonl, training_info.txt and the
     code snapshot with csrc/ and the native sources) and puts stdout back;
     Predictor.from_run loads it version-pinned — the snapshot builds its
     own kernels — with the checkpoint's weights bit for bit, and its
     prediction of the test mesh equals the live package's exactly;
     predict_dir writes `{name}-60.obj` (forward launches counted as in the
     serving phases; the launches of train() are 8 training steps plus two
     evaluation passes of the same mesh); eval_denoising_result scores it —
     the nearest-distance kernel once per result mesh — against the same
     call with device="cpu" (angle and normal_mse equal to 1e-6, the vertex
     distance within 1e-5 of the mean edge length), and writes
     ErrorInfo_h.txt; then resume: Trainer.restore(ckpt_last.pkl) and one
     more epoch against a fresh 3-epoch fit (same epoch loss to 1e-6
     relative: no kernel uses atomics, autograd's index backward may), whose
     best weights Predictor.from_run returns bit for bit;
  9. the nearest-distance kernel against its plain version (squared
     distances within 1e-5 * max(|a|^2 + |b|^2), also against a float64
     brute force where its matrix fits; two calls bit-equal) at 10,242 x
     10,242 x 3 (the path's own inputs), 40,000^2 x 3, 500,000^2 x 3 and
     8,192^2 x 64, timed per call and on the device (its two launches, the
     slices and the combine, CUDA events inside the library), with its
     bound (2 n m k float32 operations, k FMAs a pair, at 67 TFLOP/s) and
     the time of torch.cdist(a, b).min(dim=1), which materialises the
     matrix;
 11. [bf16], on both training sets after their phase 7:
     Trainer(Config(precision="bfloat16")) — 20 graphed steps (5 epochs of
     the 4 patches, counted and profiled as phase 7's fit) against the same
     steps under eager_steps(), parameters and Adam's moments bit-equal;
     one step on the card against the CPU's bf16 step (trained weights);
     phase 7's tolerances; the graphed step on one patch (median, min,
     max of 20) beside the
     float32 one of the same call, busy share, mfu_pct, and the device time
     of the dtype-converting copies (`direct_copy_kernel`, by name) in
     both, whose difference holds the aggregates' upcasts;
 12. [fusion], seeds (0, 6): Config(fusion_features=16): serving noise
     seed 0 as phase 3 (counted), against device="cpu"; a forward and
     backward captured as a CUDA graph bit-equal to the eager one, that
     against the CPU's in float32 compute (F32_GRAD_TOL, the CPU held to the
     card's branches); the graphed training step's time;
 13. [bucket]: a corpus written here (icosphere 3, 4 and 5, noise seed 1
     (BUCKET_SEEDS), 20,000-face patches) trained with preload=False,
     buckets_growth=1.5, prefetch_depth=2, augment off, for 2 epochs
     (counted): the buckets and their padded slots against one merged plan,
     one CUDA graph per bucket plan with its static inputs' bytes, the
     bytes of the memory pool they share, s/step and edges/s; the epoch
     losses against the same run
     preloaded on one merged plan, on the card and, its first epoch, on
     the CPU (BUCKET_TOL);
     the busy share of an epoch streamed against the same epoch preloaded;
 14. [dynamic], seeds (0, 6): Config(edge_weight_type=4): one step's
     launches (level 1 only), Trainer.fit for 2 epochs (graphed, counted),
     the graphed step beside the static model's and its device time by
     kernel group (profile_train_step's groups), the 8 matchings' and
     coalesces' time on the path's inputs, and one step against the CPU's:
     the CPU's matchings held to the card's picks (testing.same_matchings:
     at most MAX_REP_FLIPS, each differing call reproduced from the card's
     weights, which lie within MATCH_WEIGHT_TOL of the CPU's, and every
     pair of candidate edges the two rank apart a near-tie within it),
     then the bf16-compute
     tolerances of phase 7; the learned pooling parameters' gradients zero;
 15. [halo], after phase 7: the halo-sharded serving path at the default
     model's full width — Predictor(Config()) with phase 3's weights runs
     predict_mesh_halo on add_noise(icosphere(5), 0.2, seed=0) over
     HALO_PARTS (4) parts, devices=[cuda:0] * 4, in table mode and with
     banded=True: each level's mode per branch; an eager, recorded forward,
     then the forward as one CUDA graph (a call that warms up and
     captures, then the counted replay), bit-equal to the eager one; the
     launches of #1/#2 the capture recorded and the replay's by kernel name
     (profiled), each equal to parts x banded level-1 convs; host build,
     the 4 parts' forward graphed and eager (CUDA events around each of 20
     calls, median and spread; kernels, device time and busy share from a
     profile) and the 60 updates timed apart; each mode against the same
     call with
     device="cpu" (POS_TOL_MEL / NORMAL_TOL); table mode against the
     single-device DualGNN on the same owner-constrained hierarchies
     (F32_TOL of max); banded with float32 aggregates against table mode
     (POS_TOL_MEL / NORMAL_TOL), and with the default's bf16 operands
     (POS_TOL_MEL / HALO_BF16_NORMAL_TOL, a multiple of the JAX package's
     own bf16 distance on this mesh, see the constant); every
     recorded banded call against its plain version (`[kernel]` lines);
 16. [halo-train]: HaloTrainer(Config(halo_parts=4, halo_banded=True,
     max_epoch=2)) on two icosphere(5) pairs (noise seeds 0 and 6) over
     [cuda:0] * 4: one step's gradients on the card against the CPU's,
     bf16 (phase 7's bounds) and float32 (F32_GRAD_TOL; the CPU's step held
     to the card's LeakyReLU branches, as phase 7); the float64 halo step on
     the CPU against the single-device full-batch float64 step on the same
     hierarchies (F32_GRAD_TOL); Trainer.fit, one CUDA graph per mesh:
     #1-#4 by kernel name (4 steps x 24 each way) and by the wrappers (each
     mesh's eager warm-up and its capture), then one more step, a replay,
     by kernel name against the capture's record; loss per epoch, s/step,
     edges/s; 3 steps of one mesh with rotation on, graphed against eager:
     parameters, Adam's moments and metric sums bit-equal; one step graphed
     and eager (CUDA events, 20 steps; profile); the comm report's
     bytes per conv against the single-device step's time; each recorded
     backward call against its plain backward (`[kernel-bwd]` lines);
 17. [dp] / [gp] / [dcn]: Trainer(Config(dp=2)), Config(gp=2) and
     Config(dcn=2, dp=1) (one process holding the (2, 1, 1) grid) on
     [cuda:0] * 2 over phase 7's seeds-(0, 6) patches, float32 heads: one
     eager sharded step's gradient against the single-device step of the
     same model (F32_GRAD_TOL); 3 steps with rotation on as one CUDA graph
     against eager (parameters, Adam's moments and metric sums bit-equal);
     a replay counted (no aggregate launch, as the capture recorded); one
     step graphed and eager (CUDA events, 20 steps; profile); then
     Trainer.fit (1 epoch, graphed); no aggregate wrapper launches (the
     sharded model's convs are the COO conv, as the JAX model's with
     gp_axis).  Several parts or grid entries on one card run one after
     another on one stream: no time of phases 15-17 is a multi-card time;
 18. [legacy], after each training set's phase 7: the four legacy models
     (models/legacy.py: FacetAttentionGNN, FGCNet at 9 heads, 9 x 128 =
     1,152 wide, FeaStGNNPrePool at 6, GATGNN) with seeded weights on the
     facet branch of that set's patch 0 (20,000 faces; seeds (0, 6) all
     banded, (1, 2) its finest level block-sparse), on the input slices of
     tests/test_legacy_models.py: the forward and backward of the summed
     squared error counted (#1-#6 by kernel name and by the wrappers, each
     equal to the FeaStConvs' schedules on their levels; GCN and GAT launch
     none) and recorded, each recorded call against its plain version
     (`[kernel]` / `[kernel-bwd]` lines at 6 and 9 heads); the forward on
     the card against device="cpu" (NORMAL_TOL); the float32 gradients
     (aggregates in float32) against the CPU's, held to the card's
     branches, within F32_GRAD_TOL — a tensor whose float32 sum cancels
     (FacetAttentionGNN's a2.bias, one scalar summed over every row) within
     three times the CPU's own distance from the float64 step, as
     tests/test_torch_legacy.py; forward and forward+backward times (CUDA
     events, median of 20);
 19. [icp]: utils.icp_align on the card against device="cpu" on the
     icosphere(5) vertex set and a rotated, shifted copy (every nearest
     point unique): R and t within 1e-5; its time;
 20. [viz]: viz.hausdorff_heatmap of phase 3's served result through #7
     (counted) against device="cpu": the squared distances within
     NEAREST_TOL, the .off files written; then `[profile]`: what each
     counted run's profile recorded of its launch calls (see _counted);
 21. [campaign-short], after phase 7's training sets and the heads:
     geobignn_tpu_torch/examples/train_synthetic_campaign.py on its short
     corpus (the first two train shapes of each class and the first two
     held-out shapes, 3 noise levels each: 24 + 6 samples), built
     (`[campaign-short-build]`: each level's mode in the merged plan) and
     trained for 10 epochs from a fresh run directory, each step and each
     eval sample one replay of its CUDA graph: epoch 0's eval pass graphed,
     replayed and eager, bit-equal; eval error_f at epoch 9 under half of
     epoch 0's; one step graph and one eval graph in one pool; the eval
     pass graphed against eager; one more epoch and eval pass counted by
     kernel name; the first epoch's recorded #1-#6 calls against their
     plain versions; final_eval with the best checkpoint on 2 held-out
     meshes, #7 held against its plain version; the best checkpoint's
     predict_mesh against device="cpu" and against the table convs;
 22. two of the probes (geobignn_tpu_torch/examples/, see --probes):
     kernel_probe at its default shape (N 165,888, tile 384, 64 -> 32, 9
     heads; `[kernel-probe]` lines), its calls held against their plain
     versions (`[probe-kernel]` lines), and halo_scaling_report's host half
     at subdiv 5 (4, 8, 16 parts; `[halo-scaling]` lines) beside phase 7's
     graphed 20,000-face step;
 10. one JSON line of the nine kernels, then the result line.  An
     aggregate's `launches` is what the device ran in the main path's runs
     (a profile, by kernel name: each launch runs one row_walk_kernel,
     whose template arguments name the aggregate): the forward ones from the
     two served meshes and the halo mesh, the backward ones from
     Trainer.fit, and both from the counted runs of phases 7c, 11-14, 16,
     18 and 21 (an aggregate's times sum the 20,480-face paths' calls: the
     large shapes have their `[large-kernel]` lines); nearest's is its wrapper's count in the evaluation, in [viz]
     and in [campaign-short]'s final_eval, which no graph holds.

--large runs, after the build, `[large-witness]`: the witness of the bf16
logits' deviation (ops/banded.factorized_softmax forms x @ u in float32),
the forward of add_noise(icosphere(6), 0.2, seed=0) whole under the seed-0
weights with bf16 against float32 activations on the card, positions and
normals each no larger than the JAX package's own distance on its CPU
(JAX_WHOLE_BF16); then the same [large] step on the 1,310,720-face
add_noise(icosphere(8), 0.2, seed=0) of examples/run_1m.py (every level a
band with a sub-band; 4 vertex-head and 8 facet-head row chunks) under
Config(precision="bfloat16"), as the JAX package runs it, then under
float32 activations (each what [large] does: 3 steps eager against 3
graphed, bit-equal; timed, counted, peak memory; graphed against eager;
every #1-#4 call against its plain version; the forward against the CPU,
and each conv's output card against CPU in the forward's order;
`[large-8-bf16]`, `[large-8]` lines), then serves the 327,680-face and the 1,310,720-face meshes through
predict_dir_body (patches of sub_size faces, one graph of the merged plan,
60 updates, the .obj written) and scores each with eval_denoising_result
on the card (#7 at the mesh's vertex count, held on those points against
its plain version, a `[kernel]` line): seconds a mesh, its host
build and its device kernels apart (`[large-serve-7]`, `[large-serve-8]`);
it ends with the same result line.  A forward that misses its bounds
against device="cpu" fails the run after the serving phases.

--large-halo runs examples/run_1m.py's halo phase on the card: the 8-part
halo training step of the 1,310,720-face add_noise(icosphere(8), 0.2,
seed=0) and its halo serving, every part on cuda:0.  Four host builds run
in worker processes from the start, beside the kernels' build: run_1m.py's
build_halo_train_sample call in table mode (as run_1m runs it) and banded
(vertex level 1 a band at tile 384, the facet branch on tables by the tile
gate), the single-device sample over the same hierarchies, and the
patches of the witness below.  Then: `[large-halo-build]`, each sample's
level modes, per level n_loc, h_total and rounds, messages, seconds and
peak RSS beside docs/results_1m.json's halo8_virtual row (read only),
n_loc, h_total and rounds at vertex level 1 held to it (the partition's
topology fixes them); `[large-halo-memory]`, one eager table step with
rematerialization off (testing.without_remat()), its peak or the card's
refusal; `[large-halo-train]` / `[large-halo-train-banded]`,
make_halo_train_step under Adam at 1e-3 on seeded parameters: 3 eager
steps against 3 graphed, bit-equal; the eager peak and the graph's pool;
graphed and eager steps timed, edges/s, busy share, 3 replays counted by
kernel name (24 + 24 #1-#4 launches a banded step, none in table mode);
`[large-halo-kernel]`, every distinct #1-#4 call of the banded step at
tile 384 against its plain version; `[large-halo-vs-single]`, the table
halo forward and loss against the single-device DualGNN on the same
hierarchies (float32: positions F32_TOL of max, loss 1e-5; float64:
positions and normals F32_TOL of max; the float32 normals printed with
the conditioning of the facet branch's input normals, which magnifies the
positions' rounding at near-degenerate predicted triangles), the
gradients' agreement printed,
the banded forward against the table one (float32 aggregates, [halo]'s
bounds; bf16 operands on vertex level 1, positions POS_TOL_MEL, normals
LARGE_HALO_BF16_NORMAL_TOL, a multiple of the JAX package's own distance
at 81,920 faces), and the
single-device step timed for `[large-halo-comm]`'s halo_comm_report;
`[large-halo-serve]`, Predictor(Config()).predict_mesh_halo(mesh, 8,
banded=True, devices=[cuda:0] * 8), its forward graph bit-equal to eager
and counted, 60 updates, the .obj written, eval_denoising_result (#7 held
against its plain version), seconds by stage, and the distance to the
mesh served patch by patch as a witness.  It prints its own kernels line
(#1-#4 and #7) and the same result line.

--campaign trains to the JAX package's accuracy: `[campaign-build]`, the
66 train and 24 held-out samples of examples/train_synthetic_campaign.py
built and each level's mode printed; `[campaign]`, the whole campaign
(Config(seed=11, 500 epochs, lmd, augmentation), the model at its full
default width) through the port's module from a fresh run directory in a
temporary one, as [campaign-short] does it, every 50th epoch printed and
the curve beside the JAX run r5's (docs/campaign_r5/metrics.jsonl);
`[campaign-eval]`, final_eval with the best checkpoint on the 24 held-out
meshes, each shape, class and the corpus beside the JAX runs r5 and r2,
held to CAMPAIGN_BOUNDS and CAMPAIGN_CLASS_GAIN, #7 against its plain
version, the best checkpoint served against device="cpu" and against the
table convs.  A missed accuracy bound fails the run after every phase has
printed.  The modules' own output, the run's metrics.jsonl and
campaign_results.json go to log/campaign/.  It prints its own kernels line
(the aggregates the counted epoch ran, and #7) and the same result line.

--halo-conv holds halo convergence to the JAX trainer's own spread over
seeds: `[halo-conv]`, geobignn_tpu_torch/examples/halo_convergence.py
single-device and over 8 parts on cuda:0 for 60 epochs, compare()'s
rel_gap of the two curves' final means, in ten pairs: (a_s) from the
port's initial weights and (b_s) from the JAX trainers'
(halo_convergence.jax_init(s), committed), for s = 7..11, one line a pair
and each side's min, median and max; (a_7)'s curves every 5 epochs beside
docs/halo_conv/, and its single-device run again with its aggregates in
float32 against the same halo curve.  Held: HALO_CONV_OF_JAX on (a_7) and
(b_7), HALO_CONV_REL_GAP on (b_7), and halo_convergence.gate's rule on the
port's own weights (HALO_CONV_REL_GAP on (a_7) while every b_s meets it;
else the median of the a_s within the larger of HALO_CONV_REL_GAP and the
median of the b_s); a miss fails the run after every pair has printed.
Every #1-#4 call of (a_7)'s single-device run (its first steps' and eval
passes' warm-ups and captures), held against its plain version; each
pair's curves and summary go to log/halo_conv_seeds/.  It prints its own
kernels line (launches: the wrappers' counts over the ten pairs, eager
calls and captures) and the same result line.

--probes runs the measuring scripts of geobignn_tpu_torch/examples/ (the
twins of the JAX repo's examples/ probes) on cuda:0 at the JAX scripts'
default shapes (PROBE_RUNS): kernel_probe (banded and block-sparse at K
9, each at 64 -> 32 and 32 -> 64: all six aggregates), trace_step
([large]'s 327,680-face step, and run_1m.py's 8-part halo step of
1,310,720 faces), profile_step, profile_large, probe_serial,
probe_f1_327k, bench_dynamic, probe_dynamic and halo_scaling_report, each
printing its rows; every aggregate call each made, held against its plain
version right after it (`[probes-kernel]`, `[probes-kernel-bwd]` lines),
which frees its recorded inputs before the next; its own kernels
line (launches: the wrappers' counts, eager calls and captures) and the
same result line.

Tolerances: kernel vs plain on identical inputs, bf16 compute: 2e-2 of
max|out| (both round the same operands to bf16, but a D summed in another
order can round an operand to the neighbouring bf16 value, 2^-8 relative);
float32 compute: 1e-4 of max|out| (summation order only); for the backward,
per cotangent.  GPU vs CPU prediction: positions within 2e-2 of the mean
edge length, unit normals within 5e-2 (bf16 differences carried through 16
convs and the bf16 heads; the JAX package's own banded-vs-table model test
uses 2e-2 / 5e-2).  GPU vs CPU parameter gradients, Config defaults (bf16
aggregate operands and heads): every tensor but the convs' `u` within 5e-2
of its max|g| and at a cosine of at least 0.99 — `u`'s gradient is a small
difference of large terms, so bf16 rounding, which differs between the two
runs, dominates it (tests/test_torch_grads.py finds the same against JAX);
so the same comparison in float32 compute holds every tensor, `u`
included, GPU against CPU and each against the float64 step, within
F32_GRAD_TOL of its max|g| on both training sets: float32 sums in another
order, about 5x the worst reading; the losses within 1e-5 of the float64
one.  The CPU's steps take the max-pooling member and the LeakyReLU
branch the card's step took wherever they round the point apart
(testing.same_branches; the count is printed): the gradient of a max
jumps at a tie and that of a LeakyReLU at 0, and two branches differ by
the jump, not by rounding (one Adam step's rounding, at most 3e-8 of a
weight, put such points apart and moved the worst reading from 2e-5 to
3.4e-3).  Only near-ties are held: each flipped value's two branches lie
within testing.TIE_TOL (1e-5) of its row's scale, else the step fails, and
at most MAX_HELD (16) values a step flip.  The block-sparse kernels are also held in place, float32 compute,
against their own plain versions on the card: every parameter gradient
within 1e-4.
Phases 11 and 14 hold GPU against CPU with phase 7's bf16-compute bounds
(the same operations on both devices, rounded at the same points; only
the kernels' sums run in another order).  Phase 13's epoch losses, streamed
over size buckets against one merged plan preloaded, on the card and on
the CPU: within BUCKET_TOL (1e-3) relative — each bucket's plan pads its
samples to other sizes and band tiles, which reorders the float sums of
the aggregates and of the masked losses, and Adam carries the differences
through the epoch (on the CPU the bf16 aggregate operands also round
apart from the card's); the readings are 7.8e-5 on the card and 1.6e-5
to 5.7e-5 on the CPU (PERF.md).  Phase 14's matchings: the card's and
the CPU's edge weights come from activations whose bf16 aggregate
operands round apart by up to one bf16 ulp, so MATCH_WEIGHT_TOL is 2^-8
of the weights' scale, for the weights and for each pair of one node's
candidate edges that the two devices rank apart (8.9e-4 read for the
weights, PERF.md); a pick that differs through such a pair changes the
partners along the proposals it sits in, and MAX_REP_FLIPS (48) is about
three times the 17 read.
The nearest-distance kernel's error is that of the expansion
|a|^2 - 2 a.b + |b|^2, a few float32 ulps of the terms that cancel: squared
distances within 1e-5 * max(|a|^2 + |b|^2); the root magnifies it for the
closest pairs, so the error of the distances is printed beside it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM at 700 W
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, SXM at 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3
NEAREST_TOL = 1e-5  # of max(|a|^2 + |b|^2), on squared distances
BF16_TOL, F32_TOL = 2e-2, 1e-4
HALO_PARTS = 4  # parts of the halo phases, all on cuda:0
POS_TOL_MEL, NORMAL_TOL = 2e-2, 5e-2
# [halo], banded with bf16 aggregate operands against table mode: the JAX
# package's own normal distance on that mesh with phase 3's weights (its
# CPU run: python tests/test_torch_halo_model.py 5), times the multiple the
# witness test holds the port's distance to there (icosphere(4))
JAX_HALO_BF16_NORMALS, HALO_WITNESS = 6.176e-2, 1.25
HALO_BF16_NORMAL_TOL = 7.7e-2  # HALO_WITNESS * JAX_HALO_BF16_NORMALS
# --large-halo's: the JAX package's own distance at the largest mesh its CPU
# run reaches, 81,920 faces (python tests/test_torch_halo_model.py 6:
# 1.689e-1), times HALO_WITNESS; its distance grows with the mesh (3.8e-2,
# 4.4e-2, 6.2e-2, 1.689e-1 at icosphere(3)-(6)), so at 1,310,720 faces this
# is the tighter bound
LARGE_HALO_BF16_NORMAL_TOL = 2.11e-1
# --large's witness of the bf16 logits' deviation (ops/banded.factorized_softmax
# forms x @ u in float32): the JAX package's own bf16-vs-float32 forward
# distance on add_noise(icosphere(6), 0.2, seed=0) whole, the largest whole
# mesh its CPU runs in a few minutes, under the seed-0 weights (its CPU run:
# python tests/test_torch_bf16_coords.py 6); the card's must be no larger
WITNESS_SUBDIV = 6
JAX_WHOLE_BF16 = {"positions_mel": 3.9062e-3, "normals": 3.9429e-1}
FWD = ("aggregate_first", "transform_first")
AGGREGATES = tuple(pre + k + suf for suf in ("", "_bwd") for pre in ("", "bs_") for k in FWD)
KERNELS = AGGREGATES + ("nearest",)


def _lap(t_start, what):
    print(f"[time] {what} done {time.perf_counter() - t_start:.1f} s after the card was found")


def _counts(**launched):
    """Launch counts of every kernel, zero but for those named."""
    return {**dict.fromkeys(KERNELS, 0), **launched}


# launches of one served mesh (2 patches), by its noise seed: with seed 0
# every level bands (8 convs of each schedule per branch, plus the finest
# facet level's boundary sub-band: one aggregate-first conv, two
# transform-first); with seed 1 the finest facet level is block-sparse
# (l_conv1 aggregate-first, r_conv3 and r_conv4 transform-first) and has no
# boundary sub-band
SERVE_LAUNCHES = {
    0: _counts(aggregate_first=18, transform_first=20),
    1: _counts(aggregate_first=14, transform_first=12,
               bs_aggregate_first=2, bs_transform_first=4),
}
# noise seeds of the two training sets and the launches of one training
# step on one patch: (0, 6) is the first pair whose patches all keep the
# seed-0 serving mesh's levels and tiles; with (1, 2) one patch bands the
# finest facet level at tile 384 while another needs the hybrid, so
# TableWidths.merge sends that level to the block-sparse path for every
# sample
TRAIN_SETS = {
    (0, 6): _counts(aggregate_first=9, transform_first=10,
                    aggregate_first_bwd=9, transform_first_bwd=10),
    (1, 2): _counts(aggregate_first=7, transform_first=6,
                    aggregate_first_bwd=7, transform_first_bwd=6,
                    bs_aggregate_first=1, bs_transform_first=2,
                    bs_aggregate_first_bwd=1, bs_transform_first_bwd=2),
}
_PALLAS = "geobignn_tpu/ops/banded_pallas.py"
_BS = "geobignn_tpu/ops/blocksparse.py"
# float32 bound on parameter gradients, of max|g|: GPU vs CPU and each against
# a float64 step (see the docstring)
F32_GRAD_TOL = 2e-4
MAX_HELD = 16  # values a step may hold to the card's branch (testing.same_branches)
# [legacy]: the same, for one legacy model's step; GATGNN's ReLU heads alone
# take 20,000 x 640 activation inputs (it held 35-99 a step on an NVIDIA
# H100 80GB HBM3): at most about 2e-5 of a model's activation inputs, each
# a near-tie within TIE_TOL
LEGACY_MAX_HELD = 256
# epoch losses, streamed over size buckets against one merged plan preloaded,
# on the card and on the CPU, relative (see the docstring)
BUCKET_TOL = 1e-3
# noise seeds of [bucket]'s corpus (icosphere 3, 4 and 5 each): one seed
# keeps the whole run near 600 s (its CPU epoch is the phase's cost)
BUCKET_SEEDS = (1,)
# dynamic pooling, GPU vs CPU (testing.same_matchings; see the docstring):
# the edge weights' distance and each pair of candidate edges ranked apart,
# over the weights' scale: one bf16 ulp; and the representatives a step
# may hold to the card's picks
MATCH_WEIGHT_TOL = 2.0 ** -8
MAX_REP_FLIPS = 48
TPU_KERNEL = {  # file:line of the TPU kernel each CUDA kernel replaces
    "aggregate_first": f"{_PALLAS}:220", "transform_first": f"{_PALLAS}:104",
    "aggregate_first_bwd": f"{_PALLAS}:241", "transform_first_bwd": f"{_PALLAS}:141",
    "bs_aggregate_first": f"{_BS}:164", "bs_transform_first": f"{_BS}:150",
    "bs_aggregate_first_bwd": f"{_BS}:182", "bs_transform_first_bwd": f"{_BS}:156",
}


def _source(name):
    return ("geobignn_tpu_torch/csrc/"
            + ("blocksparse" if name.startswith("bs_") else "banded")
            + ("_bwd.cu" if name.endswith("_bwd") else "_fwd.cu"))


def _resources(build_log):
    """One line per kernel of ptxas's report (-Xptxas -v): the source, the
    kernel with its template arguments, registers, shared memory, spills."""
    import re

    out, source, kernel, spills = [], "", None, ""
    for ln in build_log.splitlines():
        if ln.startswith("== "):
            source = os.path.basename(ln[3:])
        elif "Function properties for" in ln:
            mangled = ln.split()[-1]
            m = re.search(r"\d+([a-z_]+kernel|nearest_[a-z_]+)(I(?:L[bi]\d+E)+E)?", mangled)
            kernel = mangled if m is None else m.group(1) + (
                "<" + ", ".join(re.findall(r"L[bi](\d+)E", m.group(2))) + ">"
                if m.group(2) else "")
        elif "spill stores" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and kernel is not None:
            out.append(f"{source} {kernel}: {ln.split(':', 1)[1].strip()}; {spills}")
            kernel = None
    return out


def _cuda_ms(fn, reps, warmup=2):
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


def _kernel_entry(name, rows, launches):
    """One entry of the kernels JSON line: times and bound summed over the
    launches of one mesh (forward) or one training step (backward)."""
    per = lambda f: sum(r["calls"] * r[f] for r in rows)
    t_bytes = per("bytes") / H100_BYTES_PER_S
    t_ops = per("ops") / H100_BF16_FLOPS
    return {
        "name": ("bs_aggregate_" + name[3:]) if name.startswith("bs_")
                else f"banded_aggregate_{name}",
        "route": "cuda",
        "source": _source(name),
        "replaces": TPU_KERNEL[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per("ms"),
        "plain_ms": per("plain_ms"),
        "bound_ms": per("bound_ms"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


@contextlib.contextmanager
def _recording(captured, backward=False):
    """While open, the banded and block-sparse aggregate wrappers (forward,
    or backward) record the inputs of their first call at each shape and
    count the calls, under (kernel name, N, T, C_in, C_out, window)."""
    import torch

    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    sites = ((banded_cuda, "banded_aggregate", ""), (blocksparse, "bs_aggregate", "bs_"))
    saved = []

    def wrap(fn, prefix):
        def recording(r, p, x, w, m, *rest, **kw):
            # rest: [blk_idx,] [gout,] [compute_dtype]
            tf = banded_cuda.use_transform_first(x.shape[1], w.shape[2])
            name = prefix + FWD[tf] + ("_bwd" if backward else "")
            key = (name, x.shape[0], m.shape[1], x.shape[1], w.shape[2], m.shape[2])
            if key not in captured:  # cloned once: a call being captured into
                # a CUDA graph comes after its warm-up's and clones nothing;
                # r, p, x and w as the kernel takes them, in float32 (bf16
                # activations are upcast inside the wrapper)
                captured[key] = {
                    "args": [t.detach().float().clone() for t in (r, p, x, w)]
                            + [t.detach().clone() for t in (m,) + ((rest[0],) if prefix else ())],
                    "cd": kw.get("compute_dtype", rest[-1] if rest and not
                                 torch.is_tensor(rest[-1]) else torch.bfloat16),
                    "calls": 0}
            ent = captured[key]
            if backward:
                ent["gout_shape"] = tuple(rest[1 if prefix else 0].shape)
            ent["calls"] += 1
            return fn(r, p, x, w, m, *rest, **kw)
        return recording

    for mod, attr, prefix in sites:
        attr += "_bwd" if backward else ""
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr), prefix))
    try:
        yield captured
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# Each counted run's profile (PERF.md §7, profile_windows.py): the profiler
# keeps a device record only where its time, converted to the host's clock,
# lies inside the window it opened, and that conversion wanders by
# milliseconds, so the run starts PROFILE_SETTLE_S after the window opens
# and ends as long before it closes; and a window loses more of its first
# kernel records the more profiles the process has opened before it (about
# one more a profile: 25 by the 60th), so PROFILE_PRIMER tiny launches open
# the window and take those losses in place of the run's
PROFILE_SETTLE_S = 0.05
PROFILE_PRIMER = 256
PROFILE_WINDOWS: list = []  # one _launch_records() summary per counted run


def _launch_records(prof) -> dict:
    """What one profile recorded of the launches made inside it, from the
    profiler's raw records (before any grouping by name): the CUDA runtime's
    launch calls; the device kernels; the launch calls with no kernel
    record, those of the primer apart, the others by the innermost operation
    around each and the runtime call before it (a launch recorded into a
    CUDA graph has none); the least time from a launch call to its kernel's
    start (negative where the device's clock, converted to the host's, runs
    behind it); and the aggregate kernels among the raw records by name."""
    import profile_train_step as pts

    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if str(e.device_type()).endswith("CPU")]
    calls = {e.correlation_id(): e for e in cpu if e.name().startswith("cudaLaunchKernel")}
    kernels = {e.correlation_id(): e.start_ns() for e in events
               if str(e.device_type()).endswith("CUDA")
               and not e.name().startswith(("Memcpy", "Memset"))}
    raw = {}
    for e in events:
        key = pts.aggregate_of(e.name()) if str(e.device_type()).endswith("CUDA") else None
        if key is not None:
            raw[key] = raw.get(key, 0) + 1
    ops: dict = {}  # by thread, in start order: operations, and runtime calls
    runtime: dict = {}
    for e in sorted(cpu, key=lambda e: e.start_ns()):
        side = runtime if e.name().startswith("cu") else ops
        side.setdefault(e.start_thread_id(), []).append(e)
    starts = {t: [r.start_ns() for r in rs] for t, rs in runtime.items()}
    around: dict = {}
    in_primer = 0
    open_ops: dict = {}  # by thread: [next operation, stack of the open ones]
    for e in sorted((e for c, e in calls.items() if c not in kernels), key=lambda e: e.start_ns()):
        t, tid = e.start_ns(), e.start_thread_id()
        seq, state = ops.get(tid, []), open_ops.setdefault(tid, [0, []])
        while state[0] < len(seq) and seq[state[0]].start_ns() <= t:
            state[1].append(seq[state[0]])
            state[0] += 1
        stack = [o for o in state[1] if o.end_ns() >= t]  # operations nest on a thread
        state[1] = stack
        if any(o.name() == "primer" for o in stack):
            in_primer += 1
            continue
        k = bisect.bisect_left(starts.get(tid, []), t)
        name = (stack[-1].name() if stack else "(none)") + " after " + (
            runtime[tid][k - 1].name() if k else "(none)")
        around[name] = around.get(name, 0) + 1
    missing = sum(around.values()) + in_primer
    gaps = [kernels[c] - e.start_ns() for c, e in calls.items() if c in kernels]
    return {"launch_calls": len(calls), "kernels": len(kernels), "unrecorded": missing,
            "unrecorded_in_primer": in_primer, "unrecorded_in": around,
            "min_launch_to_start_us": min(gaps) / 1e3 if gaps else None,
            "aggregates_raw": raw}


@contextlib.contextmanager
def _counted():
    """Counts of one run of the main path.  Yields a dict filled on exit:
    "wrappers", the wrappers' counts (banded_cuda.LAUNCHES, zeroed on
    entry: eager launches and those recorded into a capture), and "device",
    the aggregate kernels the device ran (a profile of the run, by kernel
    name: eager launches and those of every replay).  Nothing runs on the
    card when the profile opens; the run starts PROFILE_SETTLE_S after it
    opens, behind PROFILE_PRIMER launches of a tiny kernel, and ends
    PROFILE_SETTLE_S before it closes (profile_windows.py measures what a
    window opened without these loses)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import profile_train_step as pts

    from geobignn_tpu_torch.ops import banded_cuda

    out: dict = {}
    torch.cuda.synchronize()
    banded_cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SETTLE_S)
        with record_function("primer"):
            one = torch.zeros(1, device="cuda")
            for _ in range(PROFILE_PRIMER):
                one.add_(1.0)
            torch.cuda.synchronize()
        yield out
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
    out["wrappers"] = dict(banded_cuda.LAUNCHES)
    out["device"] = {**dict.fromkeys(AGGREGATES, 0),
                     **pts.aggregate_launches(pts.device_kernels(prof))}
    out["records"] = _launch_records(prof)
    out["records"]["raw_equals_grouped"] = out["records"]["aggregates_raw"] == _nonzero(
        out["device"])
    PROFILE_WINDOWS.append(out["records"])


def _aggregates(counts):
    """The aggregate kernels' entries of a launch count."""
    return {k: counts[k] for k in AGGREGATES}


def _replayed(cnt, graph, replays, captures):
    """Whether a counted run's device launches are its wrappers' counts
    less those recorded into its `captures` (0 or 1) of the graph, plus
    graph.launches for each of its replays."""
    return cnt["device"] == {
        k: cnt["wrappers"][k] + (replays - captures) * graph.launches[k] for k in AGGREGATES}


def _functions(name):
    """(kernel wrapper, plain version) of a kernel name, forward or backward."""
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    mod, stem = ((blocksparse, "bs_aggregate") if name.startswith("bs_")
                 else (banded_cuda, "banded_aggregate"))
    stem += "_bwd" if name.endswith("_bwd") else ""
    return getattr(mod, stem), getattr(mod, stem + "_plain")


def _launcher(name):
    """The function that launches a kernel name's sequence and takes `parts`."""
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    mod = blocksparse if name.startswith("bs_") else banded_cuda
    return mod._launch_bwd if name.endswith("_bwd") else mod._launch


def _parts_ms(name, args, cd, reps=5):
    """Mean milliseconds of each kernel of one launch sequence (CUDA events
    between the launches, inside the library)."""
    launch = _launcher(name)
    total: dict = {}
    for i in range(reps + 1):  # the first call warms up
        parts: dict = {}
        launch(*args, cd, parts=parts)
        if i:
            for k, v in parts.items():
                total[k] = total.get(k, 0.0) + v / reps
    return total


def _grad_step(state, sample, label, cfg):
    """One forward and backward of the loss on `sample`'s device: the model
    with `state`, in "bfloat16" (the Config defaults: bf16 aggregate
    operands and heads), "float32" (aggregates and heads in float32) or
    "float64" (params, sample, aggregates and heads in float64: the CPU's
    plain versions only).  Returns (model with .grad, loss, seconds)."""
    import torch

    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.testing import aggregates_in, float64_sample
    from geobignn_tpu_torch.train.trainer import _metrics_of

    dev = sample.v.x.device
    if label == "bfloat16":
        mdl = DualGNN(fc_dtype=torch.bfloat16, device=dev)
    else:
        dt = getattr(torch, label)
        mdl = DualGNN(compute_dtype=dt, fc_dtype=dt, device=dev).to(dt)
        sample = float64_sample(sample) if dt == torch.float64 else sample
    mdl.load_state_dict(state)
    t0 = time.perf_counter()
    with contextlib.nullcontext() if label == "bfloat16" else aggregates_in(mdl.fc_v1.dtype):
        loss = _metrics_of(*mdl(sample), sample, cfg)[0]
        loss.backward()
    return mdl, float(loss.detach()), time.perf_counter() - t0


def _step_counts(torch, step):
    """(kernels launched, their device milliseconds, checkpointed calls) of
    one call of step(): the profiler's device kernels (copies and sets
    aside), the sum of their durations, and the model's calls of
    torch.utils.checkpoint."""
    from torch.profiler import ProfilerActivity, profile

    from geobignn_tpu_torch.models import dual_gnn

    calls = []
    ckpt = dual_gnn.checkpoint
    dual_gnn.checkpoint = lambda *args, **kw: calls.append(1) or ckpt(*args, **kw)
    try:
        step()
        torch.cuda.synchronize()
        calls.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        dual_gnn.checkpoint = ckpt
    kernels = [ev for ev in prof.events() if str(ev.device_type).endswith("CUDA")
               and not ev.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3, len(calls)


def check_edge_cases():
    """Every aggregate kernel, forward and backward, on the seeded edge
    cases, against its plain version: both compute dtypes, r̄ of the rows
    under the clamp apart from the other rows'."""
    import torch

    from geobignn_tpu_torch.testing import edge_case_inputs

    # 9 heads (DualGNN, FGCNet: 9 x 128 = 1,152, the kernels' widest), and 6
    # (FeaStGNNPrePool), both schedules, banded and block-sparse at tile 64;
    # then #1-#4 at tile 384 (a 1,152-byte mask row, 12 KB column panels) at
    # the widths of the halo parts' banded level-0 convs (--large-halo)
    cases = [(c_in, c_out, heads, 64, bs)
             for c_in, c_out, heads in ((64, 32, 9), (128, 64, 9), (12, 32, 9), (6, 32, 9),
                                        (128, 128, 9), (6, 32, 6), (64, 32, 6),
                                        (128, 128, 6), (128, 64, 6))
             for bs in (False, True)]
    cases += [(6, 32, 9, 384, False), (64, 32, 9, 384, False)]
    for c_in, c_out, heads, tile, bs in cases:
        tf = c_out < c_in
        case = edge_case_inputs(c_in, c_out, tile=tile, n_blk=3, heads=heads, seed=c_in,
                                blocksparse=bs)
        names = ("r", "p", "x", "w", "m") + (("blk_idx",) if bs else ())
        args = [torch.from_numpy(case[k]).cuda() for k in names]
        gout = torch.from_numpy(case["gout"]).cuda()
        clamped = torch.from_numpy(case["clamped"]).cuda()
        rest = torch.ones(gout.shape[0], dtype=torch.bool, device="cuda")
        rest[clamped] = False
        name = ("bs_" if bs else "") + FWD[tf]
        kernel, plain = _functions(name)
        kernel_bwd, plain_bwd = _functions(name + "_bwd")
        worst = {}
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            out = kernel(*args, compute_dtype=dt)
            got = kernel_bwd(*args, gout, compute_dtype=dt)
            torch.cuda.synchronize()
            ref = plain(*args, compute_dtype=dt)
            want = plain_bwd(*args, gout, compute_dtype=dt)
            pairs = [("out", out, ref), ("r clamped", got[0][clamped], want[0][clamped]),
                     ("r", got[0][rest], want[0][rest])]
            pairs += list(zip("pxw", got[1:], want[1:]))
            errs = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for k, a, b in pairs}
            assert all(bool(torch.isfinite(a).all()) for _, a, _ in pairs), name
            assert max(errs.values()) <= tol, (name, c_in, c_out, dt, errs)
            empty = (args[4].reshape(out.shape[0], -1) == 0).all(dim=1)
            assert bool(empty.any()) and bool((out[empty] == 0).all())
            worst[str(dt)] = max(errs.values())
        print(f"[edge] {name} and its backward, {heads} heads, {c_in}->{c_out}, mask "
              f"{tuple(args[4].shape)}: worst relative error "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
              + f" (tol {BF16_TOL} / {F32_TOL})")


def check_forward(key, ent, reps=20, tag="kernel"):
    """One forward kernel against its plain version on the recorded inputs:
    compute dtype of the path and float32; timed; with its bound; printed
    as a `[tag]` line."""
    import torch

    from geobignn_tpu_torch.train.roofline import aggregate_work, bound_ms

    name, args, cd = key[0], ent["args"], ent["cd"]
    kernel, plain = _functions(name)
    tf = name.endswith("transform_first")
    got = kernel(*args, compute_dtype=cd)
    torch.cuda.synchronize()
    ref = plain(*args, compute_dtype=cd)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    got32 = kernel(*args, compute_dtype=torch.float32)
    ref32 = plain(*args, compute_dtype=torch.float32)
    err32 = float((got32 - ref32).abs().max()) / float(ref32.abs().max())
    del got, ref, got32, ref32
    ms = _cuda_ms(lambda: kernel(*args, compute_dtype=cd), reps)
    plain_ms = _cuda_ms(lambda: plain(*args, compute_dtype=cd), 3)
    parts = _parts_ms(name, args, cd)
    byts, ops, dense = aggregate_work(*args[:5], tf, *args[5:])
    bound, by = bound_ms(byts, ops)
    dense_bound, _ = bound_ms(byts, dense)
    n, c_in = args[2].shape
    row = dict(kernel=name, n=n, tile=args[4].shape[1], window=args[4].shape[2],
               heads=args[0].shape[1], c_in=c_in, c_out=args[3].shape[2], calls=ent["calls"],
               max_abs_err=err,
               rel_err=err / scale, rel_err_f32=err32, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, dense_bound_ms=dense_bound,
               bytes=byts, ops=ops, dense_ops=dense, parts_ms=parts)
    print(f"[{tag}] " + json.dumps(row))
    assert err <= BF16_TOL * scale, row
    assert err32 <= F32_TOL, row
    return row


def check_backward(key, ent, gen, reps=10, tag="kernel-bwd"):
    """One backward kernel against its plain backward, per cotangent,
    timed over `reps` calls; printed as a `[tag]` line."""
    import torch

    from geobignn_tpu_torch.train.roofline import aggregate_work_bwd, bound_ms

    name, cd = key[0], ent["cd"]
    kernel, plain = _functions(name)
    tf = name.endswith("transform_first_bwd")
    gout = torch.randn(ent["gout_shape"], device="cuda", generator=gen)
    args = [*ent["args"], gout]
    res = {}
    for dt in (cd, torch.float32):
        got = kernel(*args, compute_dtype=dt)
        torch.cuda.synchronize()
        ref = plain(*args, compute_dtype=dt)
        abs_err = [float((g - r_).abs().max()) for g, r_ in zip(got, ref)]
        rel = [a / max(float(r_.abs().max()), 1e-30) for a, r_ in zip(abs_err, ref)]
        res[dt] = (max(abs_err), max(rel))
        del got, ref
    ms = _cuda_ms(lambda: kernel(*args, compute_dtype=cd), reps)
    plain_ms = _cuda_ms(lambda: plain(*args, compute_dtype=cd), 3)
    parts = _parts_ms(name, args, cd)
    byts, ops, dense = aggregate_work_bwd(*args[:5], tf, *args[5:-1])
    bound, by = bound_ms(byts, ops)
    dense_bound, _ = bound_ms(byts, dense)
    n, c_in = args[2].shape
    row = dict(kernel=name, n=n, tile=args[4].shape[1], window=args[4].shape[2],
               heads=args[0].shape[1], c_in=c_in, c_out=args[3].shape[2], calls=ent["calls"],
               max_abs_err=res[cd][0], rel_err=res[cd][1],
               rel_err_f32=res[torch.float32][1], ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, dense_bound_ms=dense_bound,
               bytes=byts, ops=ops, dense_ops=dense, parts_ms=parts)
    print(f"[{tag}] " + json.dumps(row))
    assert res[cd][1] <= BF16_TOL and res[torch.float32][1] <= F32_TOL, row
    return row


def serve_phase(pred, seed, tag):
    """The serving path on add_noise(icosphere(5), 0.2, seed): an eager,
    recorded warm-up mesh, the counted mesh on a fresh plan, then the timed
    mesh.  Returns the mesh, the recorded forward calls, the device's
    launches and the wall seconds."""
    import numpy as np
    import torch

    from geobignn_tpu_torch import meshio
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.testing import eager_steps

    mesh = synth.add_noise(synth.icosphere(5), 0.2, seed=seed)
    assert mesh.n_faces == 20480, mesh.n_faces
    captured: dict = {}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, pred.cfg.data_type, "test")
        os.makedirs(os.path.join(data, "noisy"))
        os.makedirs(os.path.join(data, "original"))
        clean = synth.icosphere(5)
        meshio.write_obj(os.path.join(data, "noisy", "ball_n1.obj"),
                         mesh.points, mesh.fv_indices)
        meshio.write_obj(os.path.join(data, "original", "ball.obj"),
                         clean.points, clean.fv_indices)

        with _recording(captured), eager_steps():  # warm-up mesh, one call a launch
            predict.predict_dir_body(pred, dataset_root=root)
        torch.cuda.synchronize()

        pred._program = None  # a fresh plan: the first patch runs eagerly and captures
        with _counted() as cnt:
            res = predict.predict_dir_body(pred, dataset_root=root)
        (graph,), launches = pred._program.graphs.values(), cnt["device"]
        print(f"[{tag}] one mesh (noise seed {seed}, {mesh.n_faces} faces, 2 patches, "
              f"60 update iterations), profiled: the device ran {_nonzero(launches)}; "
              f"the wrappers counted {_nonzero(cnt['wrappers'])} (the eager patch and "
              f"the capture); the graph replayed {graph.replays} time(s)")
        assert launches == {k: SERVE_LAUNCHES[seed][k] for k in AGGREGATES}, launches
        assert graph.replays == 1 and _replayed(cnt, graph, 1, 1), cnt
        assert cnt["wrappers"] == {k: 2 * v for k, v in graph.launches.items()}

        t0 = time.perf_counter()
        predict.predict_dir_body(pred, dataset_root=root)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[{tag}] one mesh, its plan captured: {wall:.3f} s wall")
        out = meshio.read_obj(os.path.join(res["result_dir"], "ball_n1-60.obj"))
        assert out.n_faces == mesh.n_faces and out.n_vertices == mesh.n_vertices
        assert np.isfinite(out.points).all()
        assert np.isfinite([res["angle_mean1"], res["angle_mean2"]]).all()
        print(f"[{tag}] wrote {out.n_vertices} vertices; angle1 "
              f"{res['angle_mean1']:.4f} angle2 {res['angle_mean2']:.4f} "
              f"(random weights)")
    assert {k: sum(e["calls"] for kk, e in captured.items() if kk[0] == k)
            for k in FWD + tuple("bs_" + k for k in FWD)} \
        == _fwd_only(SERVE_LAUNCHES[seed])
    return mesh, captured, launches, wall


def train_phase(torch, np, seeds, overfit, kind):
    """Phase 7, for one training set: the training path on the card, then
    its step as a CUDA graph against the eager step (graph_train_phase).
    Returns the recorded backward calls, the ms per step and the launch
    counts of the main path (Trainer.fit)."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse
    from geobignn_tpu_torch.testing import (TIE_TOL, grad_agreement, same_branches,
                                            without_remat)
    from geobignn_tpu_torch.train.trainer import Trainer

    tag = f"train{seeds}"
    step_launches = TRAIN_SETS[seeds]
    cfg = Config(seed=0, max_epoch=2)
    clean = synth.icosphere(5)
    t0 = time.perf_counter()
    train_ds = dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=s), clean) for s in seeds],
        cfg.build_config(), submesh_size=cfg.sub_size)
    host_s = time.perf_counter() - t0
    n_faces = [int(e[1].n_nodes) for e in train_ds.entries]
    print(f"[{tag}] {len(train_ds)} patches of {n_faces} faces from noise seeds "
          f"{seeds}; host build {host_s:.3f} s; real edge messages per "
          f"step {train_ds.messages_per_sample().tolist()}")
    assert len(train_ds) == 4 and max(n_faces) <= cfg.sub_size

    # one recorded step on one patch: launches per step, inputs of the
    # backward kernels at the path's shapes
    probe = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
    s0 = probe._get(train_ds, "t", 0)
    f1 = s0.f.levels[0]
    print(f"[{tag}] finest facet level: mask {tuple(f1.band.shape)}, blk_idx "
          f"{None if f1.blk_idx is None else tuple(f1.blk_idx.shape)}, boundary "
          f"sub-band {None if f1.jband is None else tuple(f1.jband.shape)}")
    captured: dict = {}
    banded_cuda.reset_launches()
    with _recording(captured, backward=True):
        probe._step(s0, 0)
        probe._apply(1)
    torch.cuda.synchronize()
    got = dict(banded_cuda.LAUNCHES)
    print(f"[{tag}] one step on one patch: launches {got}")
    assert got == step_launches, got

    # the gradient of every parameter on the card against the CPU's plain
    # backward, on the same weights and sample: with the Config defaults
    # (bf16 aggregate operands and heads), then in float32 beside a float64
    # step on the CPU
    s0_cpu = train_ds.get(0, probe.plan).to("cpu")
    state = probe.model.state_dict()
    (g16, l_g16, _), (c16, l_c16, secs16) = (
        _grad_step(state, smp, "bfloat16", cfg) for smp in (s0, s0_cpu))
    stats = grad_agreement(g16, c16)
    not_u = {k: v for k, v in stats.items() if not k.endswith(".u")}
    worst = max(not_u, key=lambda k: not_u[k][0])
    worst_all = max(stats, key=lambda k: stats[k][0])
    min_cos = min(not_u, key=lambda k: not_u[k][1])
    min_cos_u = min(v[1] for k, v in stats.items() if k.endswith(".u"))
    print(f"[{tag}] gradients GPU vs CPU plain backward, bfloat16 compute, one "
          f"patch: loss {l_g16:.6f} vs {l_c16:.6f}; worst tensor "
          f"{worst_all} {stats[worst_all][0]:.3e} of its max|g|, u aside "
          f"{worst} {not_u[worst][0]:.3e}; smallest cosine u aside {min_cos} "
          f"{not_u[min_cos][1]:.6f}, of the u {min_cos_u:.6f}; CPU forward+"
          f"backward {secs16:.2f} s")
    # u's gradient is noise-dominated in bf16 (see the docstring)
    assert abs(l_g16 - l_c16) <= 1e-2 * abs(l_c16)
    assert not_u[worst][0] <= 5e-2 and not_u[min_cos][1] >= 0.99
    del g16, c16

    # the CPU steps differentiate the branches of the max-pooling and the
    # LeakyReLU that the card's step took (same_branches): a point that
    # float32 and float64, or the two devices, round apart would otherwise
    # compare two branches of a function whose gradient jumps there
    picks: list = []
    with same_branches(picks, replay=False):
        g32, l_g32, _ = _grad_step(state, s0, "float32", cfg)
    with same_branches(picks, replay=True) as flips32:
        c32, l_c32, secs32 = _grad_step(state, s0_cpu, "float32", cfg)
    with same_branches(picks, replay=True) as flips64:
        c64, l_c64, secs64 = _grad_step(state, s0_cpu, "float64", cfg)
    print(f"[{tag}] max-pooling picks and LeakyReLU signs the CPU steps round apart "
          f"from the card's, held to the card's: float32 {flips32[0]}, float64 "
          f"{flips64[0]} (at most {MAX_HELD}); the widest of them "
          f"{max(flips32[1], flips64[1]):.3e} of its row's scale (near-ties: at most "
          f"{TIE_TOL})")
    assert flips32[0] <= MAX_HELD and flips64[0] <= MAX_HELD
    worst_f32 = 0.0
    for label, mdl, ref in (("GPU vs CPU", g32, c32), ("GPU vs CPU float64", g32, c64),
                            ("CPU vs CPU float64", c32, c64)):
        st = grad_agreement(mdl, ref)
        w = max(st, key=lambda k: st[k][0])
        worst_f32 = max(worst_f32, st[w][0])
        print(f"[{tag}] gradients {label}, float32 compute, one patch: worst tensor "
              f"{w} {st[w][0]:.3e} of its max|g|; fc_v1.kernel "
              f"{st['fc_v1.kernel'][0]:.3e}")
    print(f"[{tag}] float32 losses: GPU {l_g32:.9f}, CPU {l_c32:.9f}, CPU float64 "
          f"{l_c64:.9f}; CPU float32 / float64 forward+backward {secs32:.2f} / "
          f"{secs64:.2f} s; worst {worst_f32:.3e} (tol {F32_GRAD_TOL})")
    assert all(abs(x - l_c64) <= 1e-5 * abs(l_c64) for x in (l_g32, l_c32))
    assert worst_f32 <= F32_GRAD_TOL
    del c32, c64
    if step_launches["bs_aggregate_first"]:  # the block-sparse kernels in place
        launchers = blocksparse._launch, blocksparse._launch_bwd
        blocksparse._launch = blocksparse.bs_aggregate_plain
        blocksparse._launch_bwd = blocksparse.bs_aggregate_bwd_plain
        try:
            g_plain = _grad_step(state, s0, "float32", cfg)[0]
        finally:
            blocksparse._launch, blocksparse._launch_bwd = launchers
        in_place = grad_agreement(g32, g_plain)
        k_w = max(in_place, key=lambda k: in_place[k][0])
        print(f"[{tag}] gradients on the card, float32 compute: block-sparse "
              f"kernels vs their plain versions in place: worst tensor {k_w} "
              f"{in_place[k_w][0]:.3e} of its max|g| (tol 1e-4)")
        assert in_place[k_w][0] <= 1e-4
        del g_plain

    # what rematerialization costs a training step, and what it changes:
    # float32 gradients with it on and off; then per step (forward, backward,
    # Adam), the kernels launched and their summed durations (the profiler's
    # device events), the checkpointed calls, and the step between CUDA
    # events (mean of 5 steps; bound by the host)
    with without_remat():
        g32_all = _grad_step(state, s0, "float32", cfg)[0]
    same = all(torch.equal(a.grad, b.grad)
               for a, b in zip(g32.parameters(), g32_all.parameters()))
    print(f"[{tag}] float32 gradients on the card, rematerialization on vs off: "
          f"bit-equal {same}")
    assert same
    del g32, g32_all

    def one_step():
        probe._step(s0, 0)
        probe._apply(1)

    cost = {}
    for mode in ("on", "off"):
        with contextlib.nullcontext() if mode == "on" else without_remat():
            cost[mode] = (*_step_counts(torch, one_step), _cuda_ms(one_step, reps=5))
    print(f"[{tag}] one training step, rematerialization on / off: "
          f"{cost['on'][0]} / {cost['off'][0]} kernels launched, of "
          f"{cost['on'][1]:.3f} / {cost['off'][1]:.3f} ms (profiler), "
          f"{cost['on'][2]} / {cost['off'][2]} checkpointed calls; the step "
          f"{cost['on'][3]:.3f} / {cost['off'][3]:.3f} ms between CUDA events")
    assert cost["on"][2] > 0 and cost["off"][2] == 0 and cost["off"][0] > 0
    step_ms = cost["on"][3]
    print(f"[{tag}] one training step (forward, backward, Adam) on one "
          f"20,000-face patch: {step_ms:.3f} ms (CUDA events, after warm-up)")

    if overfit:  # 20 steps on one patch lower its loss
        over = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
        o0 = over._get(train_ds, "t", 0)
        hist = []
        for _ in range(20):
            hist.append(float(over._step(o0, 0)["loss"].detach()))
            over._apply(1)
        print(f"[{tag}] overfit one patch, 20 steps: loss {hist[0]:.5f} -> "
              f"{hist[-1]:.5f} (min {min(hist):.5f})")
        assert np.isfinite(hist).all() and hist[-1] < hist[0]
        del over, o0

    # the main path: Trainer(Config(seed=0, max_epoch=2)).fit()
    tr = Trainer(cfg, train_ds, None, device="cuda")
    epochs = []

    def report(t, m, _):
        epochs.append(m)
        print(f"[{tag}] epoch {t.epoch}: loss {m['loss']:.5f} (v {m['loss_v']:.5f}, "
              f"f {m['loss_f']:.5f}) error_f {m['error_f']:.4f} deg; "
              f"{1.0 / m['samples_per_s']:.4f} s/step; edges/s {m['edges_per_s']:.4e}")

    t0 = time.perf_counter()
    with _counted() as cnt:
        best = tr.fit(on_epoch=report)
    fit_s = time.perf_counter() - t0
    launches = cnt["device"]
    n_steps = cfg.max_epoch * len(train_ds)
    (graph,) = tr._program.graphs.values()
    print(f"[{tag}] fit: {cfg.max_epoch} epochs x {len(train_ds)} steps in "
          f"{fit_s:.3f} s under the profiler; best error_f {best:.4f}; the device ran "
          f"{_nonzero(launches)}; the wrappers counted {_nonzero(cnt['wrappers'])} "
          f"(the eager first step and the capture); the graph replayed "
          f"{graph.replays} times")
    assert launches == {k: n_steps * step_launches[k] for k in AGGREGATES}, launches
    assert graph.replays == n_steps - 1 and _replayed(cnt, graph, n_steps - 1, 1), cnt
    assert cnt["wrappers"] == {k: 2 * v for k, v in step_launches.items()}
    assert len(epochs) == cfg.max_epoch
    assert all(np.isfinite([m[k] for k in ("loss", "loss_v", "loss_f", "error_v",
                                            "error_f")]).all() for m in epochs)
    assert {k: sum(e["calls"] for kk, e in captured.items() if kk[0] == k)
            for k in KERNELS if k.endswith("_bwd")} \
        == {k: v for k, v in step_launches.items() if k.endswith("_bwd")}
    del tr, probe, graph
    torch.cuda.empty_cache()
    graphs = graph_train_phase(torch, np, train_ds, seeds, kind)
    return {"captured": captured, "launches": launches, "step_ms": step_ms,
            "graph": graphs, "train_ds": train_ds}


def _profiled(step, steps=5):
    """(host ms per step without the profiler, device ms per step, kernels
    per step, {group: [ms, launches]}, {kernel: (ms, launches)} per step) of
    step(i), by profile_train_step's profiler and kernel groups."""
    import profile_train_step as pts

    step_ms, kernels = pts.profile_steps(step, steps)
    total = sum(ms for ms, _ in kernels.values())
    launches = sum(cnt for _, cnt in kernels.values())
    return step_ms, total, launches, pts.groups_of(kernels), kernels


def _busy(prof):
    step_ms, dev_ms, launches = prof[:3]
    return (f"{launches:.0f} kernels, device {dev_ms:.3f} ms, busy share "
            f"{dev_ms / step_ms:.3f} (host clock {step_ms:.3f} ms)" if dev_ms else
            f"device time not measured (the profiler recorded no kernel); host "
            f"clock {step_ms:.3f} ms")


def _spread(t):
    return (f"median {t['median_ms']:.3f}, min {t['min_ms']:.3f}, max "
            f"{t['max_ms']:.3f} ms over {t['n']}")


def _graph_and_eager(step):
    """step(i) replayed as its graph and run eagerly (testing.eager_steps):
    per call, the time (CUDA events around each of 20 calls) and the
    profile (_profiled: kernels, device time, busy share, the kernel
    groups; over three graphed calls, whose host clock a single short call
    would overstate, and one eager call), both ways, and the wall seconds
    all this took."""
    import itertools

    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import profiling

    t0 = time.perf_counter()
    it = itertools.count(1000)
    out = {"graphed": profiling.time_steps(lambda: step(next(it)), steps=20)}
    out["graphed_prof"] = _profiled(step, steps=3)
    with eager_steps():
        out["eager"] = profiling.time_steps(lambda: step(next(it)), steps=20)
        out["eager_prof"] = _profiled(step, steps=1)
    for mode in ("graphed", "eager"):
        prof = out[mode + "_prof"]
        out[mode]["busy"] = prof[1] / prof[0] if prof[1] else None
    out["wall_s"] = time.perf_counter() - t0
    return out


def _both(times):
    prof = times["graphed_prof"]
    groups = sorted(prof[3].items(), key=lambda kv: -kv[1][0])
    top = sorted(prof[4].items(), key=lambda kv: -kv[1][0])[:4]
    return (f"graphed {_spread(times['graphed'])}, {_busy(prof)}; eager "
            f"{_spread(times['eager'])}, {_busy(times['eager_prof'])}; the graph's device "
            f"time by kernel group: "
            + ", ".join(f"{g} {ms:.3f} ms in {n:.0f}" for g, (ms, n) in groups)
            + "; its largest kernels: "
            + ", ".join(f"{name[:60]} {ms:.3f} ms in {n:.0f}" for name, (ms, n) in top)
            + f" (timed and profiled in {times['wall_s']:.1f} s)")


def graph_train_phase(torch, np, train_ds, seeds, kind):
    """The training step as one CUDA graph against the eager step, on one
    training set: parameters and Adam's moments after 3 epochs of 4 steps
    (rotation on, the learning rate halved each epoch) bit-equal; per step,
    the time (CUDA events, >= 20 steps), the kernels launched, the device
    busy share and mfu_pct, both ways; autograd's index backward before and
    after the gathers' custom backwards."""
    import itertools

    import profile_train_step as pts

    from geobignn_tpu_torch import capture
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import optim, profiling, roofline
    from geobignn_tpu_torch.train.trainer import Trainer

    tag = f"graph{seeds}"
    cfg = Config(seed=0, max_epoch=3, lr_sch="exp", lr_decay=0.5)
    runs = {}
    for mode in ("graphed", "eager"):
        tr = Trainer(cfg, train_ds, None, device="cuda")
        lrs = []
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            tr.fit(on_epoch=lambda t, m, e: lrs.append((optim.get_lr(t.optimizer),
                                                         m["loss"])))
        runs[mode] = (tr, lrs)
    (g, g_hist), (e, e_hist) = runs["graphed"], runs["eager"]
    assert len(g._program.graphs) == 1 and not e._program.graphs
    pairs = [(a, b) for a, b in zip(g.model.parameters(), e.model.parameters())]
    pairs += [(g.optimizer.state[a][k], e.optimizer.state[b][k])
              for a, b in zip(g.model.parameters(), e.model.parameters())
              for k in ("exp_avg", "exp_avg_sq", "step")]
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    same = all(torch.equal(a, b) for a, b in pairs)
    print(f"[{tag}] Trainer.fit, 3 epochs x {len(train_ds)} steps, rotation on, lr "
          f"per epoch {[round(lr, 8) for lr, _ in g_hist]}: epoch losses graphed "
          f"{[round(x, 7) for _, x in g_hist]}, eager {[round(x, 7) for _, x in e_hist]}; "
          f"parameters and Adam's moments bit-equal {same} (max difference {diff:.3e})")
    assert [lr for lr, _ in g_hist] == [lr for lr, _ in e_hist] and g_hist[0][0] > g_hist[1][0]
    assert same
    del runs, g, e, pairs

    # per step, graphed and eager, on one patch
    tr = Trainer(Config(seed=0), train_ds, None, device="cuda")
    sample = tr._get(train_ds, "t", 0)
    it = itertools.count()
    graphed = profiling.time_steps(lambda: tr.fused_step(sample, next(it)), steps=20)
    graph = next(iter(tr._program.graphs.values()))
    dst, src = capture.tensors(graph.inputs), capture.tensors((sample, None))
    copy_bytes = sum(t.numel() * t.element_size() for t in src)
    copy_ms = _cuda_ms(lambda: torch._foreach_copy_(dst[:len(src)], src), reps=20)
    prof_g = _profiled(lambda i: tr.fused_step(sample, i))
    kernels_g = pts.profile_steps(lambda i: tr.fused_step(sample, i), 5)[1]

    def eager(i):
        tr._step(sample, i)
        tr._apply(1)

    with eager_steps():
        eager_t = profiling.time_steps(lambda: eager(next(it)), steps=20)
        prof_e = _profiled(eager)
        with pts.plain_gathers():
            prof_p = _profiled(eager)
    mfu = {k: roofline.roofline(sample, t["median_ms"] / 1e3)
           for k, t in (("graphed", graphed), ("eager", eager_t))}
    print(f"[{tag}] one training step on one 20,000-face patch, CUDA events: graphed "
          f"{_spread(graphed)}; eager {_spread(eager_t)}; card {kind}")
    print(f"[{tag}] per step, profiler: graphed {_busy(prof_g)}; eager {_busy(prof_e)}; "
          f"the graph holds {sum(graph.launches.values())} aggregate launches "
          f"{ {k: v for k, v in graph.launches.items() if v} }")
    print(f"[{tag}] roofline at the median step: graphed {mfu['graphed']}; eager "
          f"{mfu['eager']}")
    print(f"[{tag}] the step's copy of the cached sample into the graph's inputs: "
          f"{copy_bytes / 1e6:.1f} MB in {len(src)} tensors, {copy_ms:.3f} ms "
          f"(CUDA events)")
    idx = "index backward (autograd)"
    for label, prof in (("autograd's scatter-add (before)", prof_p),
                        ("custom gather backwards (after)", prof_e)):
        ms, n = prof[3].get(idx, [0.0, 0.0])
        print(f"[{tag}] eager step with {label}: index backward {ms:.3f} ms, "
              f"{n:.0f} launches; device total {prof[1]:.3f} ms, {prof[2]:.0f} kernels")
    assert np.isfinite([graphed["median_ms"], eager_t["median_ms"]]).all()
    return {"graphed": graphed, "eager": eager_t, "mfu": mfu, "kernels": kernels_g,
            "busy": prof_g[1] / prof_g[0]}


def union_phase(torch, np, kind):
    """One graphed training step (Trainer.fused_step) on union_batch of 8
    add_noise(icosphere(5), 0.2, seed=0) samples under Config(granularity=256)
    and bf16 fc heads — the shape of bench.py's workload — timed over 20
    replays, with its edges/s; kernels #1-#4 at that N against their plain
    versions, on the inputs the step gave them."""
    import itertools

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import batching, builder, dataset, synth
    from geobignn_tpu_torch.train import profiling, roofline
    from geobignn_tpu_torch.train.trainer import Trainer

    tag = "union"
    cfg = Config(seed=0, granularity=256)
    bc = cfg.build_config()
    clean = synth.icosphere(5)
    noisy = synth.add_noise(clean, 0.2, seed=0)
    t0 = time.perf_counter()
    bv, bf, meta = builder.build_raw(noisy, clean, bc)
    single, _ = builder.build_dual_sample(noisy, clean, bc)
    widths = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    union = builder.attach_tables(batching.union_batch([single] * 8), widths)
    host_s = time.perf_counter() - t0
    msgs = (dataset.branch_messages(bv) + dataset.branch_messages(bf)) * 8
    masks = [(side, i, lvl.band.shape, lvl.blk_idx is not None, lvl.jband is not None)
             for side in ("v", "f") for i, lvl in enumerate(getattr(union, side).levels)
             if lvl.band is not None]
    n_v, n_f = union.v.x.shape[0], union.f.x.shape[0]
    print(f"[{tag}] union_batch of 8 x {bf.n_nodes} faces: N vertex {n_v}, facet {n_f}; "
          f"masks (side, level, shape, block-sparse, sub-band) {masks}; host build "
          f"{host_s:.2f} s; real edge messages per step {msgs}")
    # the kernels index rows, mask bytes and scratch elements in 64 bits
    # (long long in window_walk.cuh, window_bwd.cuh, node_product.cuh); ints
    # hold N, tiles and widths, far below 2^31 here
    assert max(int(np.prod(sh)) for _, _, sh, _, _ in masks) < 2**31 and n_f < 2**31 // 1152

    ds = dataset.InMemoryDataset([(noisy, clean)], bc, submesh_size=cfg.sub_size)
    tr = Trainer(cfg, ds, None, device="cuda")
    sample = union.to("cuda")
    fwd, bwd = {}, {}
    with _recording(fwd), _recording(bwd, backward=True):
        tr.fused_step(sample, 0)  # the eager warm-up, then the capture
    it = itertools.count(1)
    stats = profiling.time_steps(lambda: tr.fused_step(sample, next(it)), steps=20,
                                 warmup=2)
    (graph,) = tr._program.graphs.values()
    with _counted() as cnt:  # replays: the wrappers count none
        for _ in range(3):
            tr.fused_step(sample, next(it))
    print(f"[{tag}] 3 replays, profiled: the device ran {_nonzero(cnt['device'])}; the "
          f"wrappers counted {sum(cnt['wrappers'].values())}")
    assert sum(cnt["wrappers"].values()) == 0 and _replayed(cnt, graph, 3, 0), cnt
    loss = float(tr._sums["loss"])
    edges = msgs / (stats["median_ms"] / 1e3)
    mfu = roofline.roofline(sample, stats["median_ms"] / 1e3)
    print(f"[{tag}] one graphed training step (forward, backward, Adam at 1e-3, bf16 "
          f"heads): {_spread(stats)} (CUDA events); {edges:.4e} edges/s at the median "
          f"({msgs} messages); {mfu}; launches per step "
          f"{ {k: v for k, v in graph.launches.items() if v} }; loss sum {loss:.4f}; "
          f"card {kind}")
    assert np.isfinite(loss) and all(graph.launches[k] for k in AGGREGATES[:2] + AGGREGATES[4:6])
    del tr, graph, sample
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(1)
    for captured, check in ((fwd, check_forward), (bwd, check_backward)):
        for name in sorted({k[0] for k in captured}):
            key = max((k for k in captured if k[0] == name), key=lambda k: k[1])
            if check is check_forward:
                check(key, captured[key], reps=5)
            else:
                check(key, captured[key], gen)
            torch.cuda.empty_cache()
    del fwd, bwd
    torch.cuda.empty_cache()
    return {"edges_per_s": edges, "step": stats}


def _large_host(subdiv):
    """bench.py's host build of one whole add_noise(icosphere(subdiv), 0.2,
    seed=0) mesh as a batch-1 union sample under Config(granularity=256)
    (examples/_sample.whole_sample: build_raw, build_dual_sample,
    widths_for with bands, attach_tables).  Returns the meshes, the sample
    (numpy), its real vertex and facet rows, the real edge messages of one
    step and the build's seconds."""
    from geobignn_tpu_torch.examples import _sample

    return _sample.whole_sample.__wrapped__(subdiv)  # uncached: the caller frees it


def _large_host_started(subdiv):
    """_large_host(subdiv) in a worker process of its own, started now
    (spawned: this process holds a CUDA context), so that [large]'s host
    build runs beside the phases before it.  Returns the executor, to shut
    down, and the future of the build."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(_large_host, subdiv)


def _levels(sample):
    """Per level (side, index): its band's, blk_idx's and sub-band's shapes."""
    shape = lambda a: None if a is None else tuple(a.shape)
    return {(side, i): (shape(lvl.band), shape(lvl.blk_idx), shape(lvl.jband))
            for side in ("v", "f") for i, lvl in enumerate(getattr(sample, side).levels)}


def _step_launches(sample):
    """Aggregate launches of one DualGNN forward (and as many backward) on a
    sample whose levels all band: one a conv, and one more a conv of a level
    with a boundary sub-band (feast_conv_hybrid_band's second call)."""
    from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE
    from geobignn_tpu_torch.ops import banded_cuda

    want = _counts()
    for side, c0 in (("v", 6), ("f", 12)):
        levels = getattr(sample, side).levels
        for _, lvl, c_in, c_out in CONV_SCHEDULE:
            name = FWD[banded_cuda.use_transform_first(c_in or c0, c_out)]
            n = 1 + (levels[lvl].jband is not None)
            want[name] += n
            want[name + "_bwd"] += n
    return want


def _without_bands(sample):
    """The sample with every level's band structures taken away: each conv
    the dense-table conv."""
    no_band = dict.fromkeys(("band", "blk_idx", "jnodes", "jband", "jpos", "rows_b",
                             "nbr_b", "kmask_b", "src_b", "rev_b"))
    return sample.replace(**{
        side: getattr(sample, side).replace(levels=tuple(
            lvl.replace(**no_band) for lvl in getattr(sample, side).levels))
        for side in ("v", "f")})


def _gib(n):
    return f"{n / 2**30:.3f} GiB"


def _free(torch):
    """Return freed device memory to the card: a trainer and its graphs form
    a reference cycle (Program.fn is a bound method of the trainer), so
    they go at a collection, not at `del`."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


# [large]'s sample, bench.py's `large` field (add_noise(icosphere(7), 0.2,
# seed=0) whole): its vertex and facet rows, the row chunks of its vertex
# and facet fc heads, and per level (side, index) its band's shape and
# whether it has a boundary sub-band (none is block-sparse).  The
# sub-bands' row blocks are printed, not held: the coarser levels' pooling
# follows floating-point ties of the host build, which round apart with
# numpy's version (PERF.md §6)
LARGE_ROWS, LARGE_CHUNKS = (164096, 327936), (1, 2)
LARGE_LEVELS = {
    ("v", 0): ((641, 256, 768), True), ("v", 1): ((185, 256, 768), True),
    ("v", 2): ((36, 384, 1152), False), ("f", 0): ((1281, 256, 768), True),
    ("f", 1): ((352, 256, 768), True), ("f", 2): ((100, 256, 768), True),
}


@contextlib.contextmanager
def _conv_outputs(model):
    """While open, every FeaStConv of the model's two U-Nets keeps its last
    output, in float32 on the host, under "v.l_conv1" and so on, in the
    order the forward runs them."""
    from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE

    outs: dict = {}
    hooks = [getattr(getattr(model, "gnn_" + side), name).register_forward_hook(
        lambda mod, args, out, key=f"{side}.{name}": outs.__setitem__(
            key, out.detach().float().cpu()))
        for side in ("v", "f") for name, *_ in CONV_SCHEDULE]
    try:
        yield outs
    finally:
        for h in hooks:
            h.remove()


def _per_conv(card, cpu) -> str:
    """Each conv's card-vs-CPU output distance over the CPU output's max,
    in the order the forward ran them."""
    rel = {k: float((card[k] - cpu[k]).abs().max()) / max(float(cpu[k].abs().max()), 1e-30)
           for k in cpu}
    return ", ".join(f"{k} {v:.2e}" for k, v in rel.items())


def large_phase(torch, np, host, kind, precision="float32", failures=None):
    """[large] (and --large's [large-8]): Trainer.fused_step on the
    whole-mesh sample of _large_host under Config(seed=0, granularity=256,
    precision), bf16 fc heads, Adam at 1e-3.  Prints the levels and the
    heads' row chunks; 3 steps run eagerly (the function the step's graph
    holds, Trainer._captured_step, kernel by kernel) against 3 graphed from
    the same start: parameters, Adam's moments (_same_state) and metric
    sums bit-equal; the eager step's peak memory and the graph pool's
    bytes; 20 graphed steps timed (CUDA events), edges/s, mfu_pct, and 3
    replays counted (by kernel name) and profiled (busy share); the step
    graphed against eager (_graph_and_eager); every distinct aggregate
    call of the step, forward and backward, against its plain version on
    the card; the forward on the card against device="cpu"; and, in
    float32, the banded forward against every conv the table conv.  Returns
    the device's launches of the counted replays."""
    import itertools

    from geobignn_tpu_torch import geometry
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.models.dual_gnn import DualGNN, head_chunks
    from geobignn_tpu_torch.testing import aggregates_in
    from geobignn_tpu_torch.train import profiling, roofline
    from geobignn_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    sub = host["subdiv"]
    tag = ("large" if sub == 7 else f"large-{sub}") + ("" if precision == "float32" else "-bf16")
    union, n_v, n_f = host["sample"], host["n_v"], host["n_f"]
    rows_v, rows_f = union.v.x.shape[0], union.f.x.shape[0]
    levels = _levels(union)
    cfg = Config(seed=0, granularity=256, precision=precision)
    print(f"[{tag}] add_noise(icosphere({sub}), 0.2, seed=0) whole, one batch-1 union "
          f"sample: {host['noisy'].n_faces} faces, {n_v} vertices; rows vertex {rows_v}, "
          f"facet {rows_f}; host build (build_raw, build_dual_sample, widths_for, "
          f"attach_tables) {host['host_s']:.2f} s; levels (band, blk_idx, sub-band) "
          f"{ {f'{s}{i}': v for (s, i), v in levels.items()} }; real edge messages per "
          f"step {host['msgs']}; {precision} activations, bf16 heads")
    if sub == 7:
        assert (rows_v, rows_f) == LARGE_ROWS, (rows_v, rows_f)
        assert {k: (band, jband is not None) for k, (band, _, jband) in levels.items()} \
            == LARGE_LEVELS, levels
    # the kernels index rows, mask bytes and scratch elements in 64 bits; ints
    # hold N, tiles and widths (at most 1,152 floats a row)
    assert rows_f < 2**31 // 1152 and all(
        int(np.prod(sh)) < 2**31 for band, _, jband in levels.values()
        for sh in (band, jband) if sh is not None)
    assert all(blk is None for _, blk, _ in levels.values())

    # the trainer's own dataset, a small mesh, is never read: fused_step and
    # _captured_step take the sample they are given
    stand_in = dataset.InMemoryDataset(
        [(synth.add_noise(synth.icosphere(1), 0.2, seed=0), synth.icosphere(1))],
        cfg.build_config())
    _free(torch)  # the earlier phases' trainers and graphs
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    sample = union.to("cuda")
    seeds = (1, 2, 3)
    fwd, bwd = {}, {}
    eager = Trainer(cfg, stand_in, None, device="cuda")
    chunks = tuple(head_chunks(n, eager.model.fc_chunk_rows) for n in (rows_v, rows_f))
    print(f"[{tag}] fc head row chunks (fc_chunk_rows {eager.model.fc_chunk_rows}): vertex "
          f"{chunks[0]}, facet {chunks[1]}")
    assert sub != 7 or chunks == LARGE_CHUNKS, chunks
    with _recording(fwd), _recording(bwd, backward=True):
        eager._captured_step(sample, eager._rotation(seeds[0]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for seed in seeds[1:]:
        eager._captured_step(sample, eager._rotation(seed))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    tr = Trainer(cfg, stand_in, None, device="cuda")
    for seed in seeds:  # the first warms up and captures
        tr.fused_step(sample, seed)
    (graph,) = tr._program.graphs.values()
    same = _same_state(torch, tr.model, tr.optimizer, eager.model, eager.optimizer) and all(
        torch.equal(tr._sums[k], eager._sums[k]) for k in tr._sums)
    del eager
    _free(torch)
    in_bytes, pool_bytes = _graph_bytes(torch, graph)
    print(f"[{tag}] 3 steps eager against 3 graphed from the same start (rotation on): "
          f"parameters, Adam's moments and metric sums bit-equal {same}; the eager step's "
          f"peak {_gib(peak)} (torch.cuda.max_memory_allocated; {_gib(before)} held before "
          f"the step: the sample, the trainer's state, the recorded kernel inputs and the "
          f"earlier phases' {_gib(held)}); the graph's pool {_gib(pool_bytes)}, its static "
          f"inputs {_gib(in_bytes)}; reserved {_gib(torch.cuda.memory_reserved())}; "
          f"{time.perf_counter() - t0:.1f} s into the phase")
    assert same and graph.replays == 2, (same, graph.replays)

    it = itertools.count(100)
    loss0 = float(tr._sums["loss"])
    stats = profiling.time_steps(lambda: tr.fused_step(sample, next(it)), steps=20)
    loss = float(tr._sums["loss"]) - loss0
    with _counted() as cnt:  # replays: the wrappers count none
        for _ in range(3):
            tr.fused_step(sample, next(it))
    prof = _profiled(lambda i: tr.fused_step(sample, i), steps=3)
    want = _step_launches(union)
    edges = host["msgs"] / (stats["median_ms"] / 1e3)
    mfu = roofline.roofline(sample, stats["median_ms"] / 1e3)
    print(f"[{tag}] one graphed training step (Trainer.fused_step: forward, backward, "
          f"Adam at 1e-3): {_spread(stats)} (CUDA events); {edges:.4e} edges/s at the "
          f"median ({host['msgs']} messages); {mfu}; per step {_busy(prof)}; loss summed "
          f"over the 23 timed steps {loss:.4f}; card {kind}")
    print(f"[{tag}] 3 replays, profiled: the device ran {_nonzero(cnt['device'])}, the "
          f"wrappers counted {sum(cnt['wrappers'].values())}; the capture recorded "
          f"{_nonzero(graph.launches)} a step, the sample's levels want "
          f"{_nonzero(_aggregates(want))} (a conv, and one more at each level with a "
          f"boundary sub-band)")
    assert np.isfinite(loss) and np.isfinite(stats["median_ms"])
    assert {k: graph.launches[k] for k in AGGREGATES} == _aggregates(want), graph.launches
    assert sum(cnt["wrappers"].values()) == 0 and _replayed(cnt, graph, 3, 0), cnt

    times = _graph_and_eager(lambda i: tr.fused_step(sample, i) if tr.one_dispatch()
                             else tr._captured_step(sample, tr._rotation(i)))
    print(f"[{tag}] one step, CUDA events: {_both(times)}")
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    with torch.no_grad(), _conv_outputs(tr.model) as convs_g:
        vp_g, n_g = (t.float().cpu().numpy() for t in tr.model(sample))
    del tr, graph, sample
    _free(torch)
    print(f"[time] [{tag}] the steps done {time.perf_counter() - t0:.1f} s into the phase")

    # each call's plain version whole, on the card: the largest, #4's
    # backward at f0 of 1.31M faces, needs ~9 MiB a row block in float32
    # (47 GiB at 5,121 blocks); the cache is emptied between calls
    gen = torch.Generator(device="cuda").manual_seed(13)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for key in sorted(fwd):
        rows.append(check_forward(key, fwd[key], reps=5, tag=f"{tag}-kernel"))
        torch.cuda.empty_cache()
    for key in sorted(bwd):
        rows.append(check_backward(key, bwd[key], gen, reps=5, tag=f"{tag}-kernel-bwd"))
        torch.cuda.empty_cache()
    del fwd, bwd
    torch.cuda.empty_cache()
    for name in AGGREGATES[:2] + AGGREGATES[4:6]:
        mine = [r for r in rows if r["kernel"] == name]
        assert sum(r["calls"] for r in mine) == want[name], (name, mine)
        per = lambda f: sum(r["calls"] * r[f] for r in mine)
        print(f"[{tag}] {name} per step: {want[name]} calls at {len(mine)} shapes, kernel "
              f"{per('ms'):.3f} ms, plain {per('plain_ms'):.3f} ms, bound "
              f"{per('bound_ms'):.4f} ms; card {kind}")
    print(f"[time] [{tag}] the kernel checks done {time.perf_counter() - t0:.1f} s into "
          f"the phase; their peak {_gib(torch.cuda.max_memory_allocated())}")

    model = DualGNN(compute_dtype=getattr(torch, precision), fc_dtype=torch.bfloat16,
                    device="cpu")
    model.load_state_dict(state)
    t1 = time.perf_counter()
    with torch.no_grad(), _conv_outputs(model) as convs_c:
        vp_c, n_c = (t.float().numpy() for t in model(union.to("cpu")))
    cpu_s = time.perf_counter() - t1
    noisy = host["noisy"]  # the sample's coordinates are normalized
    mel = (geometry.mean_edge_length_np(noisy.points, noisy.ev_indices)
           * float(np.asarray(union.scale).reshape(-1)[0]))
    e_pos = float(np.abs(vp_g[:n_v] - vp_c[:n_v]).max()) / mel
    e_n = float(np.abs(n_g[:n_f] - n_c[:n_f]).max())
    print(f"[{tag}] the forward (trained weights) with device=\"cpu\" (plain versions) "
          f"in {cpu_s:.1f} s; card vs CPU: positions {e_pos:.3e} mean edge lengths (tol "
          f"{POS_TOL_MEL}), normals {e_n:.3e} (tol {NORMAL_TOL})")
    print(f"[{tag}] per conv, card vs CPU over the CPU output's max: "
          + _per_conv(convs_g, convs_c))
    del convs_g, convs_c
    assert np.isfinite(vp_g).all() and np.isfinite(n_g).all()
    if failures is None:
        assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL
    elif not (e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL):
        failures.append(f"[{tag}] card vs CPU: positions {e_pos:.3e}, normals {e_n:.3e}")

    # the banded convs against the table convs of the same sample on the
    # card, activations, aggregates and heads in float32 (phase 4's check
    # at this size, where u.x spans past banded.WIDE_SPAN at level 0)
    model = DualGNN(device="cuda")
    model.load_state_dict(state)
    with torch.no_grad():
        with aggregates_in(torch.float32):
            vp_b, n_b = (t.float().cpu().numpy() for t in model(union.to("cuda")))
        vp_t, n_t = (t.float().cpu().numpy() for t in model(_without_bands(union).to("cuda")))
    del model
    _free(torch)
    e_pos = float(np.abs(vp_b[:n_v] - vp_t[:n_v]).max()) / mel
    e_n = float(np.abs(n_b[:n_f] - n_t[:n_f]).max())
    print(f"[{tag}] the forward (trained weights, float32 heads) through the banded kernels "
          f"in float32 against every conv the table conv: positions {e_pos:.3e} mean edge lengths "
          f"(tol {POS_TOL_MEL}), normals {e_n:.3e} (tol {NORMAL_TOL})")
    assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL
    return cnt["device"]


def large_serve_phase(torch, np, pred, subdiv, kind):
    """--large's serving: add_noise(icosphere(subdiv), 0.2, seed=0) through
    predict_dir_body (patches of sub_size faces, one CUDA graph of the
    merged plan's forward, stitching, 60 updates, the .obj written), then
    eval_denoising_result on the card (#7 at the mesh's vertex count, then
    on the points it was given against its plain version).  The mesh's seconds split into the host build (Predictor.patch_dataset and
    the patches' padding, InMemoryDataset.get) and the device (a profile's
    kernel time)."""
    from torch.profiler import ProfilerActivity, profile

    import profile_train_step as pts

    from geobignn_tpu_torch import meshio
    from geobignn_tpu_torch.data import dataset, synth
    from geobignn_tpu_torch.infer import evaluate, predict
    from geobignn_tpu_torch.ops import banded_cuda

    tag = f"large-serve-{subdiv}"
    clean = synth.icosphere(subdiv)
    mesh = synth.add_noise(clean, 0.2, seed=0)
    host = {"s": 0.0}

    def timed(fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                host["s"] += time.perf_counter() - t
        return call

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, pred.cfg.data_type, "test")
        for sub, m in (("noisy", mesh), ("original", clean)):
            os.makedirs(os.path.join(data, sub))
            meshio.write_obj(os.path.join(data, sub, "ball_n1.obj" if sub == "noisy"
                                          else "ball.obj"), m.points, m.fv_indices)
        pred._program = None  # the mesh's plan is captured anew
        get = dataset.InMemoryDataset.get
        pred.patch_dataset = timed(pred.patch_dataset)
        dataset.InMemoryDataset.get = timed(get)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                res = predict.predict_dir_body(pred, dataset_root=root)
                torch.cuda.synchronize()
        finally:
            del pred.patch_dataset
            dataset.InMemoryDataset.get = get
        kernels = pts.device_kernels(prof)
        device_s = sum(ms for ms, _ in kernels.values()) / 1e3
        (row,), (graph,) = res["rows"], pred._program.graphs.values()
        n_patches = graph.replays + 1  # the first patch warms up and captures
        seen, nearest = [], evaluate.nearest_distance

        def keep(a, b):  # the points #7 is given
            seen.append((a.clone(), b.clone()))
            return nearest(a, b)

        banded_cuda.reset_launches()
        evaluate.nearest_distance = keep
        try:
            t0 = time.perf_counter()
            ev = evaluate.eval_denoising_result(res["result_dir"],
                                                os.path.join(data, "original"), device="cuda")
            eval_s = time.perf_counter() - t0
        finally:
            evaluate.nearest_distance = nearest
        nn = banded_cuda.LAUNCHES["nearest"]
    corpus = ev["corpus"]
    print(f"[{tag}] one {mesh.n_faces}-face mesh ({mesh.n_vertices} vertices) through "
          f"predict_dir_body, {n_patches} patches of at most {pred.sub_size} faces: "
          f"{row['seconds']:.3f} s (read, predict, stitch, 60 updates, write, angles), "
          f"of which the host build {host['s']:.3f} s and device kernels {device_s:.3f} s "
          f"(profiled); aggregates {_nonzero(pts.aggregate_launches(kernels))}; angle1 "
          f"{row['angle1']:.4f} angle2 {row['angle2']:.4f} (random weights); "
          f"eval_denoising_result {eval_s:.3f} s, #7 launched {nn} time(s), angle "
          f"{corpus['angle']:.4f}, vertex distance {corpus['vertex_dist']:.4e}; card {kind}")
    assert np.isfinite([row["angle1"], row["angle2"], corpus["angle"],
                        corpus["vertex_dist"]]).all()
    assert nn == 1 and corpus["n_verts"] == mesh.n_vertices, (nn, corpus)
    ((a, b),) = seen
    check_nearest(torch, f"serve-{subdiv}", a, b, calls=nn, reps=3, plain_reps=1,
                  brute=False, library=False)
    return {"nearest": nn}


def large_witness_phase(torch, np, state, kind, failures):
    """[large-witness]: the witness of the bf16 logits' deviation.  The
    forward of add_noise(icosphere(WITNESS_SUBDIV), 0.2, seed=0) whole under
    `state` (the seed-0 weights) on the card with bf16 activations against
    float32 activations (bf16 heads in both): the positions' largest
    distance in mean edge lengths and the normals', each no larger than the
    JAX package's own (JAX_WHOLE_BF16, its CPU run)."""
    from geobignn_tpu_torch import geometry
    from geobignn_tpu_torch.models.dual_gnn import DualGNN

    tag = "large-witness"
    host = _large_host(WITNESS_SUBDIV)
    sample, noisy = host["sample"].to("cuda"), host["noisy"]
    mel = (geometry.mean_edge_length_np(noisy.points, noisy.ev_indices)
           * float(np.asarray(host["sample"].scale).reshape(-1)[0]))
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        model = DualGNN(compute_dtype=dt, fc_dtype=torch.bfloat16, device="cuda")
        model.load_state_dict(state)
        with torch.no_grad():
            outs[dt] = [t.float().cpu().numpy() for t in model(sample)]
        del model
    (vb, nb), (vf, nf) = outs[torch.bfloat16], outs[torch.float32]
    got = {"positions_mel": float(np.abs(vb[:host["n_v"]] - vf[:host["n_v"]]).max()) / mel,
           "normals": float(np.abs(nb[:host["n_f"]] - nf[:host["n_f"]]).max())}
    ok = all(got[k] <= JAX_WHOLE_BF16[k] for k in got)
    print(f"[{tag}] add_noise(icosphere({WITNESS_SUBDIV}), 0.2, seed=0) whole "
          f"({noisy.n_faces} faces), the seed-0 weights: bf16 against float32 activations "
          f"on the card {json.dumps(got)}; the JAX package's own on the CPU "
          f"{json.dumps(JAX_WHOLE_BF16)}: " + ("no larger (met)" if ok else "MISSED")
          + f"; card {kind}")
    if not ok:
        failures.append(f"[{tag}] {got} against the JAX package's {JAX_WHOLE_BF16}")
    del sample, outs
    _free(torch)


def large_main(torch, np, kind, t_start, state):
    """python3 chip_smoke.py --large: the 1,310,720-face icosphere(8) sample
    of examples/run_1m.py through large_phase under
    Config(precision="bfloat16"), as the JAX package runs it, and under
    float32 activations; then the serving of the 327,680-face and
    1,310,720-face meshes."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer import predict

    failures: list = []  # the card-vs-CPU forward checks fail the run at its end
    large_witness_phase(torch, np, state, kind, failures)
    _lap(t_start, "[large-witness]")
    host = _large_host(8)
    _lap(t_start, "the icosphere(8) host build")
    for precision in ("bfloat16", "float32"):
        large_phase(torch, np, host, kind, precision=precision, failures=failures)
        _lap(t_start, f"[large-8{'-bf16' if precision == 'bfloat16' else ''}]")
    del host
    pred = predict.Predictor(Config(), state, device="cuda")
    for subdiv in (7, 8):
        large_serve_phase(torch, np, pred, subdiv, kind)
        _lap(t_start, f"[large-serve-{subdiv}]")
    if failures:
        raise AssertionError("; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def serve_graph_phase(torch, pred, mesh, kind):
    """A patch's forward as one replay of the predictor's CUDA graph against
    the eager forward: outputs equal, time (CUDA events, 20 calls) and
    kernels per forward both ways."""
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import profiling

    mem = pred.patch_dataset(mesh)
    s0 = mem.get(0).to("cuda")
    vg, ng = (t.clone() for t in pred.forward(s0))
    graphed = profiling.time_steps(lambda: pred.forward(s0), steps=20)
    prof_g = _profiled(lambda i: pred.forward(s0))
    with eager_steps():
        ve, ne = pred.forward(s0)
        eager = profiling.time_steps(lambda: pred.forward(s0), steps=20)
        prof_e = _profiled(lambda i: pred.forward(s0))
    same = torch.equal(vg, ve) and torch.equal(ng, ne)
    print(f"[serve-graph] one patch's forward (noise seed 0, patch 0): graphed "
          f"{_spread(graphed)}; eager {_spread(eager)} (CUDA events); per forward, "
          f"graphed {_busy(prof_g)}; eager {_busy(prof_e)}; positions and normals "
          f"equal {same} (max |dv| {float((vg - ve).abs().max()):.3e}); card {kind}")
    assert same
    return {"graphed": graphed, "eager": eager}


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _fwd_only(counts):
    return {k: v for k, v in counts.items() if k in FWD or k[3:] in FWD}


def rundir_phase(torch, np):
    """Phase 8: train(cfg) -> Predictor.from_run / predict_dir ->
    eval_denoising_result -> resume, in a temp directory.  Returns the
    launches of the `nearest` kernel on the path and the result mesh's and
    the original's points (the kernel's inputs on this path)."""
    from geobignn_tpu_torch import geometry, meshio
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.dataset import DualDataset
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.infer.evaluate import eval_denoising_result
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.train import checkpoint as ckpt
    from geobignn_tpu_torch.train.trainer import Trainer, train

    tag = "rundir"
    train_seeds, test_seed = (1, 2), 3
    step = TRAIN_SETS[train_seeds]
    tmp = tempfile.mkdtemp(prefix="gbn_smoke_")
    try:
        # a reference-layout corpus
        root = os.path.join(tmp, "dataset")
        clean = synth.icosphere(5)
        for split, seeds in (("train", train_seeds), ("test", (test_seed,))):
            for sub in ("noisy", "original"):
                os.makedirs(os.path.join(root, "Synthetic", split, sub))
            meshio.write_obj(os.path.join(root, "Synthetic", split, "original", "ball.obj"),
                             clean.points, clean.fv_indices)
            for sd in seeds:
                noisy = synth.add_noise(clean, 0.2, seed=sd)
                meshio.write_obj(
                    os.path.join(root, "Synthetic", split, "noisy", f"ball_n{sd}.obj"),
                    noisy.points, noisy.fv_indices)
            with open(os.path.join(root, "Synthetic", f"{split}_list.txt"), "w") as f:
                f.write("ball\n")
        test_dir = os.path.join(root, "Synthetic", "test")
        cfg = Config(seed=0, max_epoch=2, flag="smoke", dataset_dir=root,
                     log_dir=os.path.join(tmp, "log"))

        # 8.1 train(cfg): the run directory
        stdout = sys.stdout
        t0 = time.perf_counter()
        with _counted() as train_cnt:
            run_dir = train(cfg)
        train_s = time.perf_counter() - t0
        train_launches = train_cnt["device"]
        assert sys.stdout is stdout, "train() left its tee on sys.stdout"
        for name in ("params.json", "ckpt_best.pkl", "ckpt_last.pkl", "metrics.jsonl",
                     "training_info.txt", "code_bak/geobignn_tpu_torch/csrc/nearest.cu",
                     "code_bak/geobignn_tpu_torch/csrc/window_fwd.cuh",
                     "code_bak/native/meshkernel.cpp"):
            assert os.path.exists(os.path.join(run_dir, name)), name
        recs = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
        epochs = [r for r in recs if r["split"] == "train"]
        assert [r["epoch"] for r in epochs] == [0, 1]
        assert [r["epoch"] for r in recs if r["split"] == "test"] == [0, 1]
        for r in epochs:
            print(f"[{tag}] train() epoch {r['epoch']}: loss {r['loss']:.5f} error_f "
                  f"{r['error_f']:.4f} deg; {1.0 / r['samples_per_s']:.4f} s/step; "
                  f"edges/s {r['edges_per_s']:.4e}")
            assert np.isfinite([r["loss"], r["error_f"], r["edges_per_s"]]).all()
        print(f"[{tag}] train(Config(seed=0, max_epoch=2)) on 2 meshes (4 patches) + 1 "
              f"test mesh (2 patches): {train_s:.3f} s wall under the profiler, with the "
              f"host builds and the snapshot; the device ran {_nonzero(train_launches)}; "
              f"the wrappers counted {_nonzero(train_cnt['wrappers'])}")
        n_steps = 2 * 4
        bwd = [k for k in AGGREGATES if k.endswith("_bwd")]
        # the device: 8 steps; the wrappers: the eager first step and the capture
        assert {k: train_launches[k] for k in bwd} == {k: n_steps * step[k] for k in bwd}
        assert {k: train_cnt["wrappers"][k] for k in bwd} == {k: 2 * step[k] for k in bwd}
        assert train_cnt["wrappers"]["nearest"] == 0

        # 8.2 Predictor.from_run: version-pinned, the checkpoint's weights
        best, _, scalars = ckpt.load_checkpoint(os.path.join(run_dir, "ckpt_best.pkl"))
        mesh_t = meshio.read_obj(os.path.join(test_dir, "noisy", f"ball_n{test_seed}.obj"))
        t0 = time.perf_counter()
        pinned = predict.Predictor.from_run(run_dir)
        try:
            snap_file = sys.modules[type(pinned).__module__].__file__
            assert snap_file.startswith(os.path.join(run_dir, "code_bak")), snap_file
            v_pin, n_pin = pinned.denoise(mesh_t)
            torch.cuda.synchronize()
            snap_cuda = sys.modules["geobignn_tpu_torch.ops.banded_cuda"]
            assert snap_cuda.BUILD_DIR.startswith(os.path.join(run_dir, "code_bak"))
            assert all(os.path.exists(lib) for lib in snap_cuda.LIBRARIES.values())
        finally:
            predict.unpin_live_package()
        pin_s = time.perf_counter() - t0
        live = predict.Predictor.from_run(run_dir, pinned=False)
        assert type(live) is predict.Predictor and type(pinned) is not predict.Predictor
        for name, t in best.items():
            for sd in (pinned.model.state_dict(), live.model.state_dict()):
                assert torch.equal(sd[name].cpu(), t), name
        v_live, n_live = live.denoise(mesh_t)
        same = np.array_equal(v_pin, v_live) and np.array_equal(n_pin, n_live)
        print(f"[{tag}] Predictor.from_run: pinned to the run's snapshot (its own nvcc "
              f"build and first mesh {pin_s:.2f} s), weights of epoch "
              f"{int(scalars['epoch'])} bit-equal to ckpt_best.pkl; pinned vs live "
              f"prediction of the test mesh identical: {same} (max |dv| "
              f"{float(np.abs(v_pin - v_live).max()):.3e})")
        assert same
        del pinned, live

        # 8.3 predict_dir
        t0 = time.perf_counter()
        with _counted() as serve_cnt:
            rep = predict.predict_dir(run_dir, dataset_root=root)
        serve_s = time.perf_counter() - t0
        serve_launches = serve_cnt["device"]
        out_path = os.path.join(rep["result_dir"], f"ball_n{test_seed}-60.obj")
        out = meshio.read_obj(out_path)
        print(f"[{tag}] predict_dir: {serve_s:.3f} s wall under the profiler (pinned "
              f"import, one mesh); angle1 {rep['angle_mean1']:.4f} angle2 "
              f"{rep['angle_mean2']:.4f}; the device ran {_nonzero(serve_launches)}")
        assert rep["result_dir"] == os.path.join(test_dir, "result_smoke")
        assert out.n_vertices == mesh_t.n_vertices and np.isfinite(out.points).all()
        assert np.isfinite([rep["angle_mean1"], rep["angle_mean2"]]).all()
        assert sum(_fwd_only(serve_launches).values()) >= 32, serve_launches  # 2 x 16 convs
        assert serve_launches == {k: _fwd_only(serve_launches).get(k, 0) for k in AGGREGATES}
        # the first patch eager and captured, the second replayed
        assert serve_cnt["wrappers"] == {**serve_launches, "nearest": 0}
        assert serve_launches["aggregate_first"] and serve_launches["transform_first"]
        # train() = 8 steps + 2 evaluation passes over the same two patches
        assert _fwd_only(train_launches) == {
            k: n_steps * step[k] + 2 * v for k, v in _fwd_only(serve_launches).items()}

        # 8.4 eval_denoising_result: the nearest-distance kernel, once per mesh
        orig_dir = os.path.join(test_dir, "original")
        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        ev = eval_denoising_result(rep["result_dir"], orig_dir)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_launches = dict(banded_cuda.LAUNCHES)
        info = os.path.join(rep["result_dir"], "ErrorInfo_h.txt")
        assert os.path.exists(info) and "ball_n3-60.obj" in open(info).read()
        os.remove(info)
        ev_cpu = eval_denoising_result(rep["result_dir"], orig_dir, device="cpu")
        assert os.path.exists(info)
        mel = geometry.mean_edge_length_np(clean.points, clean.ev_indices)
        c_g, c_c = ev["corpus"], ev_cpu["corpus"]
        launched = {k: v for k, v in eval_launches.items() if v}
        print(f"[{tag}] eval_denoising_result: {eval_s:.3f} s wall; launches "
              f"{launched}; angle {c_g['angle']:.6f}, "
              f"normal_mse {c_g['normal_mse']:.6f}, vertex_dist {c_g['vertex_dist']:.8f} "
              f"(device=\"cpu\": {c_c['vertex_dist']:.8f}; difference "
              f"{abs(c_g['vertex_dist'] - c_c['vertex_dist']) / mel:.3e} mean edge lengths, "
              f"tol 1e-5)")
        assert eval_launches == _counts(nearest=len(ev["rows"])) and len(ev["rows"]) == 1
        for k in ("angle", "normal_mse"):
            assert abs(c_g[k] - c_c[k]) <= 1e-6, (k, c_g[k], c_c[k])
        assert abs(c_g["vertex_dist"] - c_c["vertex_dist"]) <= 1e-5 * mel
        assert np.isfinite(list(c_g.values())).all()

        # 8.5 resume: restore ckpt_last.pkl (epoch 1), one more epoch, against
        # a fresh 3-epoch fit whose best weights from_run must return
        bc = cfg.build_config()
        t0 = time.perf_counter()
        sets = [DualDataset(root, "Synthetic", split, f"{split}_list.txt",
                            cfg.filter_patch_count if split == "train" else 0,
                            cfg.sub_size, bc) for split in ("train", "test")]
        cache_s = time.perf_counter() - t0
        cfg3 = cfg.with_updates(max_epoch=3)
        fresh_dir = os.path.join(tmp, "fresh")
        os.makedirs(fresh_dir)
        cfg3.to_json(os.path.join(fresh_dir, "params.json"))
        hist, kept = {}, {}

        def keep(name):
            def on_epoch(t, m, e):
                hist.setdefault(name, {})[t.epoch] = (m["loss"], e["error_f"])
                if e["error_f"] <= t.best_error:
                    kept[name] = {k: v.detach().clone()
                                  for k, v in t.model.state_dict().items()}
            return on_epoch

        fresh = Trainer(cfg3, *sets, run_dir=fresh_dir)
        fresh.fit(on_epoch=keep("fresh"))
        resumed = Trainer(cfg3, *sets)
        resumed.restore(os.path.join(run_dir, "ckpt_last.pkl"))
        assert resumed.epoch == 2
        resumed.fit(on_epoch=keep("resumed"))
        torch.cuda.synchronize()
        (l_f, e_f), (l_r, e_r) = hist["fresh"][2], hist["resumed"][2]
        rel = abs(l_f - l_r) / abs(l_f)
        p_diff = max(float((a - b).abs().max()) for a, b in zip(
            fresh.model.state_dict().values(), resumed.model.state_dict().values()))
        first = [abs(hist["fresh"][i][0] - epochs[i]["loss"]) / abs(epochs[i]["loss"])
                 for i in (0, 1)]
        print(f"[{tag}] resume: datasets from the cache in {cache_s:.3f} s; epoch 2 of a "
              f"fresh 3-epoch fit: loss {l_f:.7f} error_f {e_f:.5f}; after restore of "
              f"ckpt_last.pkl: loss {l_r:.7f} error_f {e_r:.5f}; relative difference "
              f"{rel:.3e} (tol 1e-6); max parameter difference {p_diff:.3e}; epochs 0-1 "
              f"against train()'s own: {first[0]:.3e}, {first[1]:.3e}")
        assert list(hist["resumed"]) == [2] and rel <= 1e-6
        served = predict.Predictor.from_run(fresh_dir)  # no snapshot there: live
        assert type(served) is predict.Predictor
        for name, t in kept["fresh"].items():
            assert torch.equal(served.model.state_dict()[name], t), name
        print(f"[{tag}] Predictor.from_run(fresh run): state dict bit-equal to the "
              f"trainer's best weights (best error_f {fresh.best_error:.5f})")

        pts = (np.ascontiguousarray(out.points, np.float32),
               np.ascontiguousarray(clean.points, np.float32))
        return {"launches": eval_launches["nearest"], "points": pts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_nearest(torch, label, a, b, calls, reps, plain_reps, brute, library):
    """The nearest-distance kernel against its plain version (and a float64
    brute force where asked), two calls bit-equal, timed per call and on the
    device (its two launches, CUDA events inside the library, queued behind
    a spin kernel so that the host's launch time stays out),
    with its bound and the library call."""
    from geobignn_tpu_torch.ops import nn_cuda

    n, k = a.shape
    m = b.shape[0]
    d2 = nn_cuda.nearest_distance(a, b, squared=True)
    d = nn_cuda.nearest_distance(a, b)
    repeat = bool(torch.equal(d2, nn_cuda.nearest_distance(a, b, squared=True)))
    torch.cuda.synchronize()
    p2 = nn_cuda.nearest_distance_plain(a, b, squared=True)
    p = nn_cuda.nearest_distance_plain(a, b)
    scale = float((a * a).sum(1).max() + (b * b).sum(1).max())
    err2 = float((d2 - p2).abs().max())
    err_d = float((d - p).abs().max())
    assert torch.isfinite(d).all() and float(d.min()) >= 0.0 and repeat
    err2_64 = err_d_64 = None
    if brute:
        ref = torch.cat([(torch.cdist(a[s:s + 4096].double(), b.double()) ** 2).amin(dim=1)
                         for s in range(0, n, 4096)])
        err2_64 = float((d2.double() - ref).abs().max())
        err_d_64 = float((d.double() - ref.sqrt()).abs().max())
        del ref
    ms = _cuda_ms(lambda: nn_cuda.nearest_distance(a, b), reps, warmup=1)
    parts = {}
    for _ in range(reps):
        got: dict = {}
        torch.cuda._sleep(1_000_000)
        nn_cuda._launch(a, b, parts=got)
        for key, v in got.items():
            parts[key] = parts.get(key, 0.0) + v / reps
    device_ms = sum(parts.values())
    plain_ms = _cuda_ms(lambda: nn_cuda.nearest_distance_plain(a, b), plain_reps, warmup=1)
    library_ms = None
    if library:  # one PyTorch call of the same function; it materialises (n, m)
        lib = torch.cdist(a, b).min(dim=1).values
        err_lib = float((d - lib).abs().max())
        del lib
        library_ms = _cuda_ms(lambda: torch.cdist(a, b).min(dim=1).values, 3, warmup=1)
    # the least work: k FMAs a pair, as the JAX docstring counts (2 n m k)
    byts = 4 * ((n + m) * k + n)
    ops = 2 * n * m * k
    t_b, t_o = byts / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    bound = max(t_b, t_o) * 1e3
    row = dict(kernel="nearest", shape=label, n=n, m=m, k=k, calls=calls,
               plan=nn_cuda.split_plan(n, m, k), max_abs_err=err2, tol=NEAREST_TOL * scale,
               err_d=err_d, err_d2_vs_f64=err2_64, err_d_vs_f64=err_d_64,
               err_d_vs_library=err_lib if library else None, bit_repeatable=repeat,
               ms=ms, device_ms=device_ms, parts_ms=parts, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound,
               bound_by="bytes" if t_b >= t_o else "operations",
               share=bound / ms, device_share=bound / device_ms, bytes=byts, ops=ops)
    print("[kernel] " + json.dumps(row))
    assert err2 <= NEAREST_TOL * scale, row
    assert err2_64 is None or err2_64 <= NEAREST_TOL * scale, row
    return row


# --------------------------------------------------------------------------
# phases 11-14: bf16 activations, the fusion layer, streamed buckets,
# dynamic pooling
# --------------------------------------------------------------------------

def _copies(kernels):
    """(device ms, launches) of the dtype-converting copies among
    device_kernels' result: torch's direct_copy_kernel, by name."""
    hits = [(ms, n) for name, (ms, n) in kernels.items() if "direct_copy_kernel" in name]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def _fit_both_ways(torch, cfg, train_ds):
    """Trainer(cfg).fit graphed (counted) and under eager_steps(); returns
    (graphed trainer, eager trainer, epoch losses of each, counts, bit-equal
    parameters and Adam moments)."""
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.trainer import Trainer

    runs = {}
    for mode in ("graphed", "eager"):
        tr = Trainer(cfg, train_ds, None, device="cuda")
        hist = []
        with (eager_steps() if mode == "eager" else contextlib.nullcontext()), \
                (_counted() if mode == "graphed" else contextlib.nullcontext({})) as cnt:
            tr.fit(on_epoch=lambda t, m, e: hist.append(m))
        runs[mode] = (tr, hist, cnt)
    (g, g_hist, cnt), (e, e_hist, _) = runs["graphed"], runs["eager"]
    same = all(torch.equal(a, b) for a, b in zip(g.model.parameters(), e.model.parameters()))
    same = same and all(torch.equal(g.optimizer.state[a][k], e.optimizer.state[b][k])
                        for a, b in zip(g.model.parameters(), e.model.parameters())
                        for k in ("exp_avg", "exp_avg_sq", "step"))
    return g, e, g_hist, e_hist, cnt, same


def _gpu_vs_cpu(tag, g, c, l_g, l_c, what):
    """Phase 7's bf16-compute check, GPU against CPU: the loss within 1e-2
    relative, every tensor but the convs' `u` within 5e-2 of its max|g| and
    at a cosine of at least 0.99 (`u`'s gradient, a small difference of
    large terms, is printed).  The learned pooling parameters, whose
    gradients are zero, are left out."""
    from geobignn_tpu_torch.testing import grad_agreement

    stats = {k: v for k, v in grad_agreement(g, c).items() if ".pooling" not in k}
    not_u = {k: v for k, v in stats.items() if not k.endswith(".u")}
    worst = max(not_u, key=lambda k: not_u[k][0])
    min_cos = min(not_u, key=lambda k: not_u[k][1])
    min_cos_u = min(v[1] for k, v in stats.items() if k.endswith(".u"))
    print(f"[{tag}] gradients GPU vs CPU, {what}: loss {l_g:.6f} vs {l_c:.6f}; worst "
          f"tensor u aside {worst} {not_u[worst][0]:.3e} of its max|g|; smallest "
          f"cosine u aside {min_cos} {not_u[min_cos][1]:.6f}, of the u {min_cos_u:.6f}")
    assert abs(l_g - l_c) <= 1e-2 * abs(l_c)
    assert not_u[worst][0] <= 5e-2 and not_u[min_cos][1] >= 0.99


def bf16_phase(torch, np, train_ds, seeds, f32, kind):
    """Phase 11, for one training set: Trainer(Config(precision="bfloat16"))
    — 20 graphed steps (5 epochs of 4) against the same steps eager,
    parameters and Adam moments bit-equal; one step on the card against the
    CPU's bf16 step; the graphed step's time beside the float32 one's
    (`f32`, from the graph phase of the same call), busy share, mfu_pct and
    the device time of the dtype-converting copies.  Returns the device's
    launches of the graphed fit."""
    import itertools

    import profile_train_step as pts

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.train import profiling, roofline
    from geobignn_tpu_torch.train.trainer import Trainer, _metrics_of

    tag = f"bf16{seeds}"
    cfg = Config(seed=0, max_epoch=5, precision="bfloat16")
    g, e, g_hist, e_hist, cnt, same = _fit_both_ways(torch, cfg, train_ds)
    n_steps = cfg.max_epoch * len(train_ds)
    (graph,) = g._program.graphs.values()
    print(f"[{tag}] Trainer.fit, bf16 activations, {n_steps} steps graphed and eager: "
          f"epoch losses graphed {[round(m['loss'], 6) for m in g_hist]}, eager "
          f"{[round(m['loss'], 6) for m in e_hist]}; parameters and Adam's moments "
          f"bit-equal {same}; the device ran {_nonzero(cnt['device'])}")
    assert same and np.isfinite([m["loss"] for m in g_hist]).all()
    assert cnt["device"] == {k: n_steps * TRAIN_SETS[seeds][k] for k in AGGREGATES}
    assert graph.replays == n_steps - 1 and _replayed(cnt, graph, n_steps - 1, 1), cnt

    # one step on the card against the CPU's bf16 step, on the trained weights
    state = g.model.state_dict()
    s0 = g._get(train_ds, "t", 0)
    s0_cpu = train_ds.get(0, g.plan).to("cpu")
    res = []
    for smp in (s0, s0_cpu):
        mdl = DualGNN(compute_dtype=torch.bfloat16, fc_dtype=torch.bfloat16,
                      device=smp.v.x.device)
        mdl.load_state_dict(state)
        t0 = time.perf_counter()
        loss = _metrics_of(*mdl(smp), smp, cfg)[0]
        loss.backward()
        res.append((mdl, float(loss.detach()), time.perf_counter() - t0))
    _gpu_vs_cpu(tag, res[0][0], res[1][0], res[0][1], res[1][1],
                f"bf16 activations, one patch (CPU {res[1][2]:.2f} s)")
    del e, res

    # per step on one patch, graphed: bf16 beside float32 (measured in the
    # graph phase of this call)
    tr = Trainer(Config(seed=0, precision="bfloat16"), train_ds, None, device="cuda")
    sample = tr._get(train_ds, "t", 0)
    it = itertools.count()
    t = profiling.time_steps(lambda: tr.fused_step(sample, next(it)), steps=20)
    step_ms, kernels = pts.profile_steps(lambda i: tr.fused_step(sample, i), 5)
    dev_ms = sum(ms for ms, _ in kernels.values())
    mfu = roofline.roofline(sample, t["median_ms"] / 1e3)
    cp_ms, cp_n = _copies(kernels)
    f32_cp_ms, f32_cp_n = _copies(f32["kernels"])
    print(f"[{tag}] one graphed step on one 20,000-face patch, CUDA events: bf16 "
          f"activations {_spread(t)}; float32 {_spread(f32['graphed'])}; card {kind}")
    print(f"[{tag}] per step, profiler: bf16 {sum(n for _, n in kernels.values()):.0f} "
          f"kernels, device {dev_ms:.3f} ms, busy share {dev_ms / step_ms:.3f}; float32 "
          f"busy share {f32['busy']:.3f}; roofline at the median step {mfu}")
    print(f"[{tag}] dtype-converting copies (direct_copy_kernel) per step: bf16 "
          f"{cp_ms:.3f} ms in {cp_n:.0f} launches, float32 {f32_cp_ms:.3f} ms in "
          f"{f32_cp_n:.0f}: the bf16 mode's casts, the aggregates' upcasts among "
          f"them, {cp_ms - f32_cp_ms:.3f} ms")
    assert np.isfinite(t["median_ms"]) and mfu["mfu_pct"] > 0
    del g, tr
    torch.cuda.empty_cache()
    return cnt["device"]


def _graphed_grads(torch, mdl, sample, cfg):
    """The loss and every parameter's gradient of one forward and backward
    captured as a CUDA graph (after an eager warm-up on a side stream) and
    replayed once."""
    from geobignn_tpu_torch import capture
    from geobignn_tpu_torch.train.trainer import _metrics_of

    params = list(mdl.parameters())

    def step(s):
        for p in params:
            p.grad = None
        loss = _metrics_of(*mdl(s), s, cfg)[0]
        loss.backward()
        return [loss.detach()] + [p.grad for p in params]

    with capture.side_stream():
        step(sample)
    graph = capture.Graph(step, sample)
    out = [t.clone() for t in graph(sample)]
    for p in params:
        p.grad = None
    return out


def fusion_phase(torch, np, train_ds, kind):
    """Phase 12: Config(fusion_features=16).  Serving seed 0 through
    predict_dir's body (counted as phase 3) and against device="cpu";
    training: a graphed forward and backward bit-equal to the eager one on
    the card, that against the CPU's float32 step (F32_GRAD_TOL, the CPU
    held to the card's branches), and the graphed step's time.  Returns the
    device's launches of the served mesh."""
    import itertools

    from geobignn_tpu_torch import geometry
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.testing import (aggregates_in, grad_agreement, same_branches,
                                            without_remat)
    from geobignn_tpu_torch.train import profiling
    from geobignn_tpu_torch.train.trainer import Trainer, _metrics_of

    tag = "fusion"
    cfg = Config(fusion_features=16, seed=0)
    state = DualGNN(fusion=16, fc_dtype=torch.bfloat16, device="cpu", seed=0).state_dict()
    pred = predict.Predictor(cfg, state, device="cuda")
    mesh, _, launches, _ = serve_phase(pred, 0, tag)
    vp_g, n_g = pred.predict_mesh(mesh)
    t0 = time.perf_counter()
    vp_c, n_c = predict.Predictor(cfg, state, device="cpu").predict_mesh(mesh)
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    e_pos = float(np.abs(vp_g - vp_c).max()) / mel
    e_n = float(np.abs(n_g - n_c).max())
    print(f"[{tag}] GPU vs CPU predict_mesh (CPU {time.perf_counter() - t0:.2f} s): "
          f"positions {e_pos:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals "
          f"{e_n:.3e} (tol {NORMAL_TOL})")
    assert np.isfinite(vp_g).all() and e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL
    del pred

    # training: float32 compute (aggregates and heads), as phase 7's check
    tr = Trainer(cfg, train_ds, None, device="cuda")
    s0 = tr._get(train_ds, "t", 0)
    s0_cpu = train_ds.get(0, tr.plan).to("cpu")
    f32_state = tr.model.state_dict()

    def model(dev):
        mdl = DualGNN(fusion=16, fc_dtype=torch.float32, device=dev)
        mdl.load_state_dict(f32_state)
        return mdl

    with aggregates_in(torch.float32), without_remat():
        graphed = _graphed_grads(torch, model("cuda"), s0, cfg)
    picks: list = []
    with aggregates_in(torch.float32), same_branches(picks, replay=False):
        g = model("cuda")
        loss_g = _metrics_of(*g(s0), s0, cfg)[0]
        loss_g.backward()
    eager = [loss_g.detach()] + [p.grad for p in g.parameters()]
    bit = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    with aggregates_in(torch.float32), same_branches(picks, replay=True) as flips:
        c = model("cpu")
        loss_c = _metrics_of(*c(s0_cpu), s0_cpu, cfg)[0]
        loss_c.backward()
    st = grad_agreement(g, c)
    w = max(st, key=lambda k: st[k][0])
    print(f"[{tag}] one step, float32 compute: the graphed forward and backward "
          f"bit-equal to the eager one {bit}; GPU vs CPU: loss {float(loss_g):.9f} vs "
          f"{float(loss_c):.9f}, worst tensor {w} {st[w][0]:.3e} of its max|g| (tol "
          f"{F32_GRAD_TOL}); the fusion layer's lin_v1.kernel "
          f"{st['fusion.lin_v1.kernel'][0]:.3e}; branches held {flips[0]} (at most "
          f"{MAX_HELD}), widest {flips[1]:.3e}")
    assert bit and st[w][0] <= F32_GRAD_TOL and flips[0] <= MAX_HELD
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    del g, c, graphed, eager

    it = itertools.count()
    t = profiling.time_steps(lambda: tr.fused_step(s0, next(it)), steps=20)
    print(f"[{tag}] one graphed training step (Config defaults, fusion_features=16) "
          f"on one 20,000-face patch, CUDA events: {_spread(t)}; card {kind}")
    del tr
    torch.cuda.empty_cache()
    return launches


def _epoch_busy(torch, np, tr, rng_seed):
    """(wall s, device ms) of one run_epoch: the wall time without the
    profiler, then the device's kernel time of the same epoch under it."""
    import profile_train_step as pts
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run_epoch(np.random.default_rng(rng_seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.run_epoch(np.random.default_rng(rng_seed))
        torch.cuda.synchronize()
    dev = sum(ms for ms, _ in pts.device_kernels(prof).values())
    return wall, dev


def _graph_bytes(torch, graph):
    """(static input bytes, pool bytes) a capture.Graph holds on the device:
    its static inputs, and the segments of its memory pool (which the other
    graphs of its capture.Program share)."""
    from geobignn_tpu_torch.capture import tensors

    inputs = sum(t.numel() * t.element_size() for t in tensors(graph.inputs))
    pool = tuple(graph.graph.pool())
    return inputs, sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == pool)


def bucket_phase(torch, np, kind):
    """Phase 13: a corpus written here (icosphere 3, 4 and 5, noise seeds
    BUCKET_SEEDS), trained streamed (preload=False, prefetch_depth=2) over size
    buckets (buckets_growth=1.5) for 2 epochs, augment off: buckets and
    their padded slots against one merged plan; one graph per bucket and
    its bytes; s/step and edges/s; the busy share of an epoch streamed
    against the same epoch preloaded; the loss trajectory against the
    preloaded, unbucketed run on the card and on the CPU.  Returns the
    device's launches of the streamed fit."""
    from geobignn_tpu_torch import meshio
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.dataset import DualDataset
    from geobignn_tpu_torch.train.trainer import Trainer

    tag = "bucket"
    tmp = tempfile.mkdtemp(prefix="gbn_bucket_")
    try:
        root = os.path.join(tmp, "dataset")
        split = os.path.join(root, "Synthetic", "train")
        for sub in ("noisy", "original"):
            os.makedirs(os.path.join(split, sub))
        names = [f"ico{k}" for k in (3, 4, 5)]
        for k, name in zip((3, 4, 5), names):
            clean = synth.icosphere(k)
            meshio.write_obj(os.path.join(split, "original", f"{name}.obj"),
                             clean.points, clean.fv_indices)
            for sd in BUCKET_SEEDS:
                noisy = synth.add_noise(clean, 0.2, seed=sd)
                meshio.write_obj(os.path.join(split, "noisy", f"{name}_n{sd}.obj"),
                                 noisy.points, noisy.fv_indices)
        with open(os.path.join(root, "Synthetic", "train_list.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        cfg = Config(seed=0, max_epoch=2, augment=False, preload=False,
                     buckets_growth=1.5, prefetch_depth=2)

        def dataset():
            return DualDataset(root, "Synthetic", "train", "train_list.txt", 0,
                               cfg.sub_size, cfg.build_config())

        ds = dataset()
        tr = Trainer(cfg, ds, None, device="cuda")
        n_b = len(set(ds.bucket_of))
        slots = {}
        for i, b in enumerate(ds.bucket_of):
            p = ds._bucket_plans[b]
            slots.setdefault(b, [0, p.v.n1 + p.f.n1])[0] += 1
        merged = ds.plan.v.n1 + ds.plan.f.n1
        print(f"[{tag}] {len(ds)} samples from {len(names) * len(BUCKET_SEEDS)} meshes in "
              f"{n_b} buckets "
              f"(growth 1.5): per bucket (samples, padded vertex + facet slots) "
              f"{[tuple(slots[b]) for b in sorted(slots)]} against {merged} slots of one "
              f"merged plan; padded slots per epoch {sum(n * s for n, s in slots.values())} "
              f"against {len(ds) * merged}")
        hist = []
        with _counted() as cnt:
            tr.fit(on_epoch=lambda t, m, e: hist.append(m))
        graphs = list(tr._program.graphs.values())
        held = [_graph_bytes(torch, g) for g in graphs]
        for m in hist:
            print(f"[{tag}] epoch: loss {m['loss']:.6f}; {1.0 / m['samples_per_s']:.4f} "
                  f"s/step; edges/s {m['edges_per_s']:.4e} (streamed, under the profiler)")
        print(f"[{tag}] {len(graphs)} CUDA graphs of the step, one per bucket plan: "
              + "; ".join(f"{inp / 1e6:.1f} MB of static inputs, replayed {g.replays} times"
                          for g, (inp, _) in zip(graphs, held))
              + f"; one memory pool of {held[0][1] / 1e6:.1f} MB, which they share; the "
              f"device ran {_nonzero(cnt['device'])}")
        assert len(graphs) == n_b >= 3 and all(np.isfinite(m["loss"]) for m in hist)
        assert all(pool > 0 for _, pool in held)
        assert sum(g.replays for g in graphs) == cfg.max_epoch * len(ds) - n_b

        # the same run preloaded and unbucketed, on the card (2 epochs) and on
        # the CPU (the first epoch: its 20,000-face steps take seconds each)
        runs = {}
        for dev in ("cuda", "cpu"):
            # the same seed: the same initial weights
            trp = Trainer(cfg.with_updates(preload=True, buckets_growth=0.0,
                                           max_epoch=cfg.max_epoch if dev == "cuda" else 1),
                          dataset(), None, device=dev)
            h = []
            t0 = time.perf_counter()
            trp.fit(on_epoch=lambda t, m, e: h.append(m["loss"]))
            runs[dev] = (trp, h, time.perf_counter() - t0)
        streamed = [m["loss"] for m in hist]
        d_card = max(abs(a - b) / abs(b) for a, b in zip(streamed, runs["cuda"][1]))
        d_cpu = max(abs(a - b) / abs(b) for a, b in zip(streamed, runs["cpu"][1]))
        print(f"[{tag}] epoch losses streamed and bucketed {streamed}; preloaded, one "
              f"merged plan, on the card {runs['cuda'][1]}, on the CPU {runs['cpu'][1]} "
              f"({runs['cpu'][2]:.1f} s): largest relative difference {d_card:.3e} "
              f"(card), {d_cpu:.3e} (CPU); tol {BUCKET_TOL}")
        assert d_card <= BUCKET_TOL and d_cpu <= BUCKET_TOL

        # busy share of an epoch, streamed and bucketed against preloaded
        wall_s, dev_s = _epoch_busy(torch, np, tr, 7)
        wall_p, dev_p = _epoch_busy(torch, np, runs["cuda"][0], 7)
        print(f"[{tag}] one epoch of {len(ds)} steps: streamed {wall_s:.3f} s, device "
              f"{dev_s:.3f} ms, busy share {dev_s / 1e3 / wall_s:.3f}; preloaded "
              f"{wall_p:.3f} s, device {dev_p:.3f} ms, busy share "
              f"{dev_p / 1e3 / wall_p:.3f}; card {kind}")
        del tr, runs
        torch.cuda.empty_cache()
        return cnt["device"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dynamic_phase(torch, np, train_ds, static_ms, kind):
    """Phase 14: Config(edge_weight_type=4) on the seeds-(0, 6) training
    set: launches of one step (level 1 only), Trainer.fit for 2 epochs
    (graphed, counted), the step's time beside the static model's, the
    matchings' and coalesces' device time on the path's inputs, and one
    step against the CPU's, its matchings held to the card's picks
    (testing.same_matchings).  Returns the device's launches of the fit."""
    import itertools

    import profile_train_step as pts

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.ops import banded_cuda, matching
    from geobignn_tpu_torch.pool.dynamic import DualGNNDynamic, fill_missing_grads
    from geobignn_tpu_torch.testing import same_matchings
    from geobignn_tpu_torch.train import profiling
    from geobignn_tpu_torch.train.trainer import Trainer, _metrics_of

    tag = "dynamic"
    cfg = Config(seed=0, max_epoch=2, edge_weight_type=4)
    probe = Trainer(cfg.with_updates(augment=False), train_ds, None, device="cuda")
    s0 = probe._get(train_ds, "t", 0)
    calls: list = []
    fn = matching.parallel_matching
    matching.parallel_matching = lambda *a, **kw: calls.append((a, kw)) or fn(*a, **kw)
    banded_cuda.reset_launches()
    try:
        probe._step(s0, 0)
        probe._apply(1)
        torch.cuda.synchronize()
    finally:
        matching.parallel_matching = fn
    step = {k: banded_cuda.LAUNCHES[k] for k in AGGREGATES}
    print(f"[{tag}] one step on one patch: the level-1 convs launched {_nonzero(step)}; "
          f"{len(calls)} matchings")
    assert sum(step.values()) > 0 and len(calls) == 8

    # the matchings' and coalesces' device time on the path's inputs
    match_ms = sum(_cuda_ms(lambda a=a, kw=kw: fn(*a, **kw), reps=10) for a, kw in calls)
    reps = [fn(*a, **kw) for a, kw in calls]
    coal_ms = sum(_cuda_ms(lambda a=a, r=r: matching.pool_edges_with_rep(a[0], a[1], r, a[2]),
                           reps=10) for (a, _), r in zip(calls, reps))
    print(f"[{tag}] per forward, CUDA events on the path's inputs: the 8 matchings "
          f"(8 rounds each) {match_ms:.3f} ms, the 8 coalesces of the relabelled "
          f"edges {coal_ms:.3f} ms")

    tr = Trainer(cfg, train_ds, None, device="cuda")
    hist = []
    with _counted() as cnt:
        tr.fit(on_epoch=lambda t, m, e: hist.append(m))
    n_steps = cfg.max_epoch * len(train_ds)
    (graph,) = tr._program.graphs.values()
    for m in hist:
        print(f"[{tag}] epoch: loss {m['loss']:.6f}; {1.0 / m['samples_per_s']:.4f} "
              f"s/step; edges/s {m['edges_per_s']:.4e}")
    print(f"[{tag}] fit: the device ran {_nonzero(cnt['device'])}; the graph replayed "
          f"{graph.replays} times")
    assert cnt["device"] == {k: n_steps * step[k] for k in AGGREGATES}, cnt
    assert graph.replays == n_steps - 1 and _replayed(cnt, graph, n_steps - 1, 1)
    sample = tr._get(train_ds, "t", 0)
    it = itertools.count()
    t = profiling.time_steps(lambda: tr.fused_step(sample, next(it)), steps=20)
    print(f"[{tag}] one graphed step on one 20,000-face patch, CUDA events: "
          f"{_spread(t)}; the static model's {_spread(static_ms)}; card {kind}")
    host_ms, kernels = pts.profile_steps(lambda i: tr.fused_step(sample, i), 3)
    dev_ms = sum(ms for ms, _ in kernels.values())
    groups = {k: f"{ms:.3f} ms in {n:.0f}" for k, (ms, n) in pts.groups_of(kernels).items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:4]
    print(f"[{tag}] per graphed step, profiler: device {dev_ms:.3f} ms, busy share "
          f"{dev_ms / host_ms:.3f}; by group {groups}; the largest kernels "
          + "; ".join(f"{name[:60]} {ms:.3f} ms in {n:.0f}" for name, (ms, n) in top))

    # one step against the CPU's, on the trained weights
    state = tr.model.state_dict()
    s0_cpu = train_ds.get(0, tr.plan).to("cpu")
    records: list = []
    res = []
    for smp, replay in ((s0, False), (s0_cpu, True)):
        mdl = DualGNNDynamic(edge_weight_type=4, device=smp.v.x.device)
        mdl.load_state_dict(state)
        with same_matchings(records, replay=replay, weight_tol=MATCH_WEIGHT_TOL) as seen:
            loss = _metrics_of(*mdl(smp), smp, cfg)[0]
            loss.backward()
        fill_missing_grads(mdl)
        res.append((mdl, float(loss.detach()), seen))
    seen = res[1][2]
    print(f"[{tag}] representatives the CPU step picks apart from the card's, per "
          f"matching (branch, level, round), held to the card's: "
          f"{[c[0] for c in seen]} of {s0.v.x.shape[0]} / {s0.f.x.shape[0]} slots "
          f"(at most {MAX_REP_FLIPS} in all); the edge weights at most "
          f"{max(c[1] for c in seen):.3e} of their scale apart; candidate edges ranked "
          f"apart {[c[2] for c in seen]}, each pair within {max(c[3] for c in seen):.3e} "
          f"of the scale (tol {MATCH_WEIGHT_TOL:.3e} for both)")
    assert sum(c[0] for c in seen) <= MAX_REP_FLIPS
    _gpu_vs_cpu(tag, res[0][0], res[1][0], res[0][1], res[1][1],
                "Config(edge_weight_type=4), one patch")
    pool = [p.grad for mdl, _, _ in res for n, p in mdl.named_parameters() if ".pooling" in n]
    assert len(pool) == 32 and not any(bool(g.any()) for g in pool)
    del tr, probe, res
    torch.cuda.empty_cache()
    return cnt["device"]


# --------------------------------------------------------------------------
# phases 15-17: the multi-device paths — halo-sharded serving and training,
# dp and gp — as one process over a grid of devices, here all cuda:0
# --------------------------------------------------------------------------

def _halo_expected(sample, n_parts):
    """Launches of #1/#2 in one halo forward: each part runs every level-0
    conv of each branch whose level 0 bands (l_conv1, r_conv3, r_conv4)."""
    from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE
    from geobignn_tpu_torch.ops import banded_cuda

    want = _counts()
    for hb, c0 in ((sample.structure.v, 6), (sample.structure.f, 12)):
        if hb.band0 is None:
            continue
        for _, lvl, c_in, c_out in CONV_SCHEDULE:
            if lvl == 0:
                want[FWD[banded_cuda.use_transform_first(c_in or c0, c_out)]] += n_parts
    return want


def _halo_modes(sample):
    """Each level's conv mode per branch, as printed."""
    out = []
    for tag, hb in (("v", sample.structure.v), ("f", sample.structure.f)):
        modes = [f"banded tile {hb.band0['m'].shape[2]}" if i == 0 and hb.band0 is not None
                 else "table" for i in range(3)]
        out.append(f"{tag}: " + ", ".join(f"L{i + 1} {m}" for i, m in enumerate(modes)))
    return "; ".join(out)


def _single_device_sample(np, mesh_n, mesh_o, bc, n_parts, seed):
    """The single-device sample over the owner-constrained hierarchies a halo
    sample of (mesh_n, mesh_o) builds (no tables, no band: COO convs)."""
    from geobignn_tpu_torch import structs
    from geobignn_tpu_torch.data import builder
    from geobignn_tpu_torch.parallel import partition as hp
    from geobignn_tpu_torch.pool.hierarchy import build_hierarchy

    bv, bf, meta = builder.build_raw(mesh_n, mesh_o, bc)
    owner_v = hp.partition_nodes(bv.edge_index, bv.n_nodes, n_parts, seed=seed)
    owner_f = owner_v[meta["fv_indices"][:, 0]].astype(np.int32)
    bv.specs = build_hierarchy(bv.edge_index, bv.edge_weight, bv.x, bv.n_nodes,
                               owner=owner_v, weight_type=bc.weight_type)
    bf.specs = build_hierarchy(bf.edge_index, bf.edge_weight, bf.x, bf.n_nodes,
                               owner=owner_f, weight_type=bc.weight_type)
    plan = builder.plan_for(bv, bf, bc.granularity)
    fv = np.full((plan.f.n1, 3), plan.v.n1 - 1, np.int32)
    fv[: bf.n_nodes] = meta["fv_indices"]
    return structs.DualSample(
        v=builder._pad_branch(bv, plan.v), f=builder._pad_branch(bf, plan.f), fv_indices=fv,
        edge_dual_v=np.zeros(1, np.int32), edge_dual_f=np.zeros(1, np.int32),
        centroid=meta["centroid"].astype(np.float32), scale=np.float32(meta["scale"]))


def _rel(a, b):
    """max|a - b| / max|b| of two arrays or tensors."""
    import numpy as np

    a, b = (np.asarray(t.detach().cpu() if hasattr(t, "detach") else t, np.float64)
            for t in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def halo_serve_phase(torch, np, state, kind):
    """Phase 15, [halo]: Predictor(Config()).predict_mesh_halo of
    add_noise(icosphere(5), 0.2, seed=0) over HALO_PARTS parts on
    [cuda:0] * HALO_PARTS, in table mode and banded; returns the recorded
    banded forward calls and the counted launches."""
    from geobignn_tpu_torch import geometry
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.parallel import halo_train as ht
    from geobignn_tpu_torch.testing import aggregates_in, eager_steps

    cfg = Config()
    pred = predict.Predictor(cfg, state, device="cuda")
    pred_cpu = predict.Predictor(cfg, state, device="cpu")
    mesh = synth.add_noise(synth.icosphere(5), 0.2, seed=0)
    devs = [torch.device("cuda", 0)] * HALO_PARTS
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    res, captured, launches = {}, {}, _counts()
    print(f"[halo] {HALO_PARTS} parts, all on cuda:0 (one card: the parts' kernels "
          f"run one after another on one stream; no time here is a multi-card time)")
    for banded in (False, True):
        mode = "banded" if banded else "table"
        t0 = time.perf_counter()
        sample = ht.build_halo_train_sample(mesh, None, cfg.build_config(), HALO_PARTS,
                                            banded=banded, devices=devs)
        host_s = time.perf_counter() - t0
        with (_recording(captured) if banded else contextlib.nullcontext()), eager_steps():
            v_e, n_e = pred.predict_mesh_halo(mesh, HALO_PARTS, banded, devs)  # recorded
        pred._halo = None  # a fresh plan: the next call runs eagerly and captures
        v_w, n_w = pred.predict_mesh_halo(mesh, HALO_PARTS, banded, devs)
        with _counted() as cnt:  # the main path: one replay
            vp, nf = pred.predict_mesh_halo(mesh, HALO_PARTS, banded, devs)
        fwd = pred._halo[1]
        (graph,) = fwd.program.graphs.values()
        want = _halo_expected(sample, HALO_PARTS)
        print(f"[halo] {mode}: levels {_halo_modes(sample)}; the capture recorded "
              f"{_nonzero(graph.launches)}, expected {_nonzero(want)} (parts x banded "
              f"level-1 convs); the replay, by kernel name {_nonzero(cnt['device'])}, "
              f"wrappers {_nonzero(cnt['wrappers'])}")
        assert graph.launches == want and cnt["device"] == _aggregates(want), cnt
        assert graph.replays == 1 and _replayed(cnt, graph, 1, 0), cnt
        same = all(np.array_equal(a, b) for a, b in ((v_w, v_e), (n_w, n_e), (vp, v_e),
                                                     (nf, n_e)))
        print(f"[halo] {mode}: graphed (warm-up and replay) against eager forward: "
              f"positions and normals bit-equal {same}")
        assert same
        if banded:
            launches = want
        times = _graph_and_eager(lambda i: fwd(sample.arrays))
        upd = [torch.from_numpy(a).to("cuda") for a in (
            vp, mesh.fv_indices.astype(np.int64), mesh.vf_indices.astype(np.int64), nf)]
        upd_ms = _cuda_ms(lambda: predict.update_positions(*upd, n_iter=60), reps=3)
        print(f"[halo] {mode}: host build {host_s:.3f} s; forward of the {HALO_PARTS} "
              f"parts, CUDA events: {_both(times)}; 60 update iterations "
              f"{upd_ms:.3f} ms; card {kind}")
        t0 = time.perf_counter()
        vp_c, nf_c = pred_cpu.predict_mesh_halo(mesh, HALO_PARTS, banded)
        cpu_s = time.perf_counter() - t0
        e_pos, e_n = float(np.abs(vp - vp_c).max()) / mel, float(np.abs(nf - nf_c).max())
        print(f"[halo] {mode}: GPU vs device=\"cpu\" ({cpu_s:.2f} s): positions "
              f"{e_pos:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals {e_n:.3e} "
              f"(tol {NORMAL_TOL})")
        assert np.isfinite(vp).all() and np.isfinite(nf).all()
        assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL
        res[mode] = (vp, nf)
        if not banded:  # the single-device model on the same hierarchies
            single = _single_device_sample(np, mesh, None, cfg.build_config(),
                                           HALO_PARTS, 0).to("cuda")
            model = DualGNN(device="cuda")  # float32 heads, as the halo model's
            model.load_state_dict(state)
            with torch.no_grad():
                v_s, n_s = model(single)
            v_h, n_h = ht.unshard_predictions(sample, *fwd(sample.arrays))
            e_v, e_nn = _rel(v_h, v_s[: sample.n_v]), _rel(n_h, n_s[: sample.n_f])
            print(f"[halo] table mode vs the single-device DualGNN on the same "
                  f"hierarchies (float32, COO convs): positions {e_v:.3e}, normals "
                  f"{e_nn:.3e} of max (tol {F32_TOL})")
            assert e_v <= F32_TOL and e_nn <= F32_TOL
            del single, model
        del sample
        torch.cuda.empty_cache()
    # banded against table: held to the model tolerances with the aggregates
    # in float32 compute (as phase 4 holds the banded patch against the
    # table convs); with the default's bf16 operands, the normals to
    # HALO_BF16_NORMAL_TOL, a multiple of the JAX package's own distance
    with aggregates_in(torch.float32), eager_steps():  # a graph holds its compute dtype
        res["banded32"] = pred.predict_mesh_halo(mesh, HALO_PARTS, True, devs)
    for mode in ("banded32", "banded"):
        e_pos = float(np.abs(res[mode][0] - res["table"][0]).max()) / mel
        e_n = float(np.abs(res[mode][1] - res["table"][1]).max())
        print(f"[halo] banded ({'float32' if mode == 'banded32' else 'bf16'} aggregate "
              f"operands) vs table: positions {e_pos:.3e} mean edge lengths, normals "
              f"{e_n:.3e}" + (f" (tol {POS_TOL_MEL}, {NORMAL_TOL})" if mode == "banded32"
                               else f" (tol {POS_TOL_MEL}, {HALO_BF16_NORMAL_TOL}: "
                               f"{HALO_WITNESS} x the JAX package's {JAX_HALO_BF16_NORMALS})"))
        assert e_pos <= POS_TOL_MEL
        assert e_n <= (NORMAL_TOL if mode == "banded32" else HALO_BF16_NORMAL_TOL)
    assert sum(e["calls"] for e in captured.values()) == sum(launches.values())
    return captured, launches


def _float64(torch, sample):
    """A halo sample with every floating-point array in float64."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.double() if t.is_floating_point() else t

    return dataclasses.replace(sample, arrays=[cast(a) for a in sample.arrays])


def _halo_grads(torch, state, sample, cfg, f32, dtype=None):
    """A DualGNN holding the gradient of the halo loss of `sample` (on its
    parts' devices) at `state`, and the loss; f32: aggregates in float32
    (in float64 with dtype float64: parameters and aggregates, the CPU's
    plain versions)."""
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.params import tree_of
    from geobignn_tpu_torch.parallel import halo_train as ht
    from geobignn_tpu_torch.testing import aggregates_in

    model = DualGNN(device=sample.devices[0])
    model.load_state_dict(state)
    model.to(dtype or torch.float32)
    with aggregates_in(dtype or torch.float32) if f32 else contextlib.nullcontext():
        loss, _ = ht._halo_loss(tree_of(model), sample.arrays, sample.static,
                                cfg.pool_type, cfg.loss_cfg(), compute_dtype=dtype)
        loss.backward()
    return model, float(loss.detach())


def halo_train_phase(torch, np, kind):
    """Phase 16, [halo-train]: HaloTrainer(Config(halo_parts=HALO_PARTS,
    halo_banded=True, max_epoch=2)) on two icosphere(5) pairs on
    [cuda:0] * HALO_PARTS; returns the recorded backward calls and the
    fit's launches."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.builder import attach_tables
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.parallel import accounting
    from geobignn_tpu_torch.testing import grad_agreement, same_branches
    from geobignn_tpu_torch.train.halo_trainer import HaloTrainer
    from geobignn_tpu_torch.train.trainer import _metrics_of

    clean = synth.icosphere(5)
    pairs = [(synth.add_noise(clean, 0.2, seed=s), clean) for s in (0, 6)]
    cfg = Config(halo_parts=HALO_PARTS, halo_banded=True, max_epoch=2, seed=0, augment=False)
    devs = [torch.device("cuda", 0)] * HALO_PARTS
    t0 = time.perf_counter()
    tr = HaloTrainer(cfg, pairs, devices=devs)
    print(f"[halo-train] {len(pairs)} meshes of {clean.n_faces} faces over {HALO_PARTS} "
          f"parts on cuda:0: host build {time.perf_counter() - t0:.3f} s; levels "
          f"{_halo_modes(tr.samples[0])}")
    state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    s0 = tr.samples[0]
    s0_cpu = s0.to([torch.device("cpu")] * HALO_PARTS)

    # one step's gradients: the card against the CPU, bf16 and float32
    captured: dict = {}
    with _recording(captured, backward=True):
        g_bf, l_bf = _halo_grads(torch, state, s0, cfg, False)
    c_bf, lc_bf = _halo_grads(torch, state, s0_cpu, cfg, False)
    _gpu_vs_cpu("halo-train", g_bf, c_bf, l_bf, lc_bf, "bf16 aggregate operands")
    # float32, the CPU's step held to the LeakyReLU branches the card's step
    # took (testing.same_branches, as phase 7)
    picks: list = []
    with same_branches(picks, replay=False):
        g32, l32 = _halo_grads(torch, state, s0, cfg, True)
    with same_branches(picks, replay=True) as flips32:
        c32, lc32 = _halo_grads(torch, state, s0_cpu, cfg, True)
    agree = grad_agreement(g32, c32)
    top = max(agree, key=lambda k: agree[k][0])
    print(f"[halo-train] float32 gradients GPU vs CPU: loss {l32:.6f} vs {lc32:.6f}; "
          f"worst tensor {top} {agree[top][0]:.3e} of its max|g| (tol {F32_GRAD_TOL}); "
          f"LeakyReLU signs held to the card's {flips32[0]} (at most {MAX_HELD}), "
          f"widest {flips32[1]:.3e} of its row's scale")
    assert agree[top][0] <= F32_GRAD_TOL and flips32[0] <= MAX_HELD
    assert abs(l32 - lc32) <= 1e-5 * abs(lc32)

    # against the single-device full-batch step on the same hierarchies, both
    # in float64 on the CPU (where the two models' summation orders cannot
    # put a near-tie apart); the single-device step timed on the card
    bc = dataclasses.replace(cfg.build_config(), reorder=False)
    single = attach_tables(_single_device_sample(np, *pairs[0], bc, HALO_PARTS,
                                                 cfg.preprocess_seed))
    ref64, l_ref64, ref_s = _grad_step(state, single.to("cpu"), "float64", cfg)
    h64, lc64 = _halo_grads(torch, state, _float64(torch, s0_cpu), cfg, True, torch.float64)
    agree = grad_agreement(h64, ref64)  # neither held: both take float64's branches
    top = max(agree, key=lambda k: agree[k][0])
    print(f"[halo-train] float64 halo gradients vs the single-device full-batch step "
          f"on the same hierarchies ({ref_s:.1f} s): loss {lc64:.9f} vs {l_ref64:.9f}; "
          f"worst tensor {top} {agree[top][0]:.3e} of its max|g| (tol {F32_GRAD_TOL})")
    assert agree[top][0] <= F32_GRAD_TOL and abs(lc64 - l_ref64) <= 1e-9 * abs(l_ref64)
    single = single.to("cuda")
    ref = DualGNN(device="cuda")
    ref.load_state_dict(state)

    def single_step():
        ref.zero_grad(set_to_none=True)
        _metrics_of(*ref(single), single, cfg)[0].backward()

    single_ms = _cuda_ms(single_step, reps=3)
    del g_bf, c_bf, g32, c32, h64, ref64, s0_cpu, single, ref
    torch.cuda.empty_cache()

    # the main path: fit, one graph per mesh (its first step eager, the
    # warm-up, then the capture; later steps replay), counted by the
    # wrappers and by kernel name; then one more step, a replay
    hist = []
    steps = cfg.max_epoch * len(pairs)
    per_step = _halo_expected(s0, HALO_PARTS)
    per_step.update({k + "_bwd": v for k, v in per_step.items() if v})
    want = {k: steps * v for k, v in per_step.items()}
    with _counted() as fit_cnt:
        tr.fit(on_epoch=lambda t, m, e: hist.append(m))
    graphs = [g for st in tr._steps.values() for g in st.program.graphs.values()]
    with _counted() as cnt:
        tr._step_for(s0)(s0.arrays, 0)
    (graph,) = tr._step_for(s0).program.graphs.values()
    print(f"[halo-train] Trainer.fit {cfg.max_epoch} epochs x {len(pairs)} meshes, "
          f"{len(graphs)} graphs: by kernel name {_nonzero(fit_cnt['device'])}, expected "
          f"{_nonzero(want)}; the wrappers (warm-ups and captures) "
          f"{_nonzero(fit_cnt['wrappers'])}; one more step, a replay: by kernel name "
          f"{_nonzero(cnt['device'])}, the capture recorded {_nonzero(graph.launches)}; "
          + "; ".join(f"epoch {i} loss {m['loss']:.6f} {1.0 / m['samples_per_s']:.3f} "
                      f"s/step {m['edges_per_s']:.4e} edges/s" for i, m in enumerate(hist))
          + f" (graphed, {HALO_PARTS} parts on one card; card {kind})")
    assert len(graphs) == len(pairs) and all(g.launches == per_step for g in graphs)
    assert fit_cnt["device"] == _aggregates(want), fit_cnt
    assert fit_cnt["wrappers"] == {k: 2 * len(pairs) * v for k, v in per_step.items()}
    assert cnt["device"] == _aggregates(per_step) and _replayed(cnt, graph, 1, 0), cnt
    assert all(np.isfinite(m["loss"]) for m in hist) and hist[-1]["loss"] < hist[0]["loss"]
    _halo_step_graph_vs_eager(torch, state, s0, cfg)

    rep = accounting.halo_comm_report(s0.structure, step_ms_single_chip=single_ms)
    print(f"[halo] comm report ({HALO_PARTS} parts, one mesh, the single-device step "
          f"{single_ms:.3f} ms eager on {kind}): bytes per conv "
          + ", ".join(f"{c['name']} {c['payload_mb'] * 1e6:.0f} ({c['real_mb'] * 1e6:.0f} real)"
                      for c in rep["per_conv"])
          + f"; per step {rep['step_payload_mb']:.3f} MB, {rep['n_rounds_step']} rounds")
    return captured, want


def _halo_step(torch, state, sample, cfg):
    """A fresh DualGNN at `state`, its Adam and make_halo_train_step over
    the sample's parts (rotation on): (model, optimizer, step)."""
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.parallel import halo_train as ht
    from geobignn_tpu_torch.train import optim

    model = DualGNN(device="cuda")
    model.load_state_dict(state)
    opt = optim.make_optimizer(cfg, model.parameters())
    return model, opt, ht.make_halo_train_step(model, opt, sample.static, cfg.loss_cfg(),
                                               cfg.pool_type, augment=True)


def _metric_sums(torch, metrics):
    return torch.stack([v for _, v in sorted(metrics.items())])


def _halo_step_graph_vs_eager(torch, state, sample, cfg):
    """The halo step (rotation on) as one graph against the eager step:
    parameters, Adam's moments and the metric sums after 3 steps of the same
    sample and seeds bit-equal; then per step, graphed and eager, the time
    and the profile."""
    from geobignn_tpu_torch.testing import eager_steps

    runs = []
    for eager in (False, True):
        model, opt, step = _halo_step(torch, state, sample, cfg)
        with eager_steps() if eager else contextlib.nullcontext():
            sums = sum(_metric_sums(torch, step(sample.arrays, seed)) for seed in (1, 2, 3))
        runs.append((model, opt, sums, step))
    (gm, go, gs, step), (em, eo, es, _) = runs
    same = _same_state(torch, gm, go, em, eo) and torch.equal(gs, es)
    print(f"[halo-train] 3 steps of one mesh (rotation on), graphed against eager: "
          f"parameters, Adam's moments and metric sums bit-equal {same}")
    assert same and [g.replays for g in step.program.graphs.values()] == [2]
    times = _graph_and_eager(lambda i: step(sample.arrays, i))
    print(f"[halo-train] one step of the {HALO_PARTS} parts (rotation on), CUDA events: "
          f"{_both(times)}")


def _same_state(torch, gm, go, em, eo):
    """Two models' parameters and their Adam moments bit-equal."""
    return all(torch.equal(a, b) and all(torch.equal(go.state[a][k], eo.state[b][k])
                                         for k in ("exp_avg", "exp_avg_sq", "step"))
               for a, b in zip(gm.parameters(), em.parameters()))


# --------------------------------------------------------------------------
# --large-halo: examples/run_1m.py's halo phase on the card — the 8-part
# halo training step of the 1,310,720-face mesh (table mode, as run_1m runs
# it, and banded) and its halo serving, every part on cuda:0
# --------------------------------------------------------------------------

LARGE_HALO_PARTS = 8
# what the partition's topology alone fixes (vertex level 1 in table mode),
# as docs/results_1m.json's halo8_virtual row records it; the coarser
# levels and the messages follow the pooling, whose floats round with
# numpy's version
LARGE_HALO_TOPOLOGY = {"n_loc": 81928, "h_total": 3488, "rounds_L1v": 3}
LARGE_HALO_MODES = ("v: L1 banded tile 384, L2 table, L3 table; "
                    "f: L1 table, L2 table, L3 table")


def _numpy_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v, fn) for v in tree]
    return fn(tree)


def _large_halo_host(what):
    """One host build of --large-halo on add_noise(icosphere(8), 0.2,
    seed=0), in a worker process of its own: "table" / "banded", run_1m.py's
    call build_halo_train_sample(noisy, clean, BuildConfig(granularity=256,
    reorder=False), 8, seed=0, banded=...) (the parts' tensors travel back
    as numpy arrays); "single", the single-device sample over the same
    owner-constrained hierarchies with its tables; "patches", the
    Predictor's patch dataset of the noisy mesh (the patch-stitched
    witness of the halo-served mesh).  Returns (result, seconds, the
    worker's peak RSS in GB as run_1m.py reads it)."""
    import resource

    import numpy as np

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.builder import BuildConfig, attach_tables
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.parallel import halo_train as ht

    clean = synth.icosphere(8)
    noisy = synth.add_noise(clean, 0.2, seed=0)
    bc = BuildConfig(granularity=256, reorder=False)
    t0 = time.perf_counter()
    if what in ("table", "banded"):
        s = ht.build_halo_train_sample(noisy, clean, bc, LARGE_HALO_PARTS, seed=0,
                                       banded=what == "banded")
        out = dataclasses.replace(s, arrays=_numpy_tree(s.arrays, lambda t: t.numpy()))
    elif what == "single":
        out = attach_tables(_single_device_sample(np, noisy, clean, bc, LARGE_HALO_PARTS, 0))
    else:
        pred = predict.Predictor(Config(), DualGNN(device="cpu").state_dict(), device="cpu")
        out = pred.patch_dataset(noisy)
    secs = time.perf_counter() - t0
    return out, secs, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _large_halo_hosts_started():
    """--large-halo's four host builds (_large_halo_host), each in a spawned
    worker process of its own, started now, so that they run beside the
    kernels' build and one another.  Returns the executors, to shut down,
    and the futures by build."""
    import concurrent.futures
    import multiprocessing

    pools, futures = [], {}
    for what in ("table", "banded", "single", "patches"):
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        pools.append(pool)
        futures[what] = pool.submit(_large_halo_host, what)
    return pools, futures


def _run_1m_row():
    """docs/results_1m.json's halo8_virtual row (read, never written)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "results_1m.json")
    with open(path) as f:
        return next(r for r in json.load(f) if r["phase"] == "halo8_virtual")


def _halo_levels(sample):
    """Per branch and level: n_loc, h_total and exchange rounds."""
    return "; ".join(
        f"{tag}: " + ", ".join(f"L{i + 1} n_loc {sh.n_loc} h_total {sh.h_total} rounds "
                               f"{len(sh.rounds)}" for i, sh in enumerate(hb.levels))
        for tag, hb in (("v", sample.structure.v), ("f", sample.structure.f)))


def large_halo_build_phase(torch, futures, row):
    """[large-halo-build]: the table and banded samples of run_1m.py's call,
    from their workers; each one's level modes, per level n_loc, h_total and
    rounds, messages, seconds and peak RSS beside run_1m.py's row; the
    partition's topology-only figures held to it.  Returns the samples
    (their parts' tensors on the CPU)."""
    samples = {}
    for mode in ("table", "banded"):
        s, secs, rss = futures[mode].result()
        s = dataclasses.replace(s, arrays=_numpy_tree(s.arrays, torch.from_numpy))
        sh = s.structure.v.levels[0]
        print(f"[large-halo-build] {mode}: build_halo_train_sample(add_noise(icosphere(8), "
              f"0.2, seed=0), icosphere(8), BuildConfig(granularity=256, reorder=False), "
              f"{LARGE_HALO_PARTS}, seed=0, banded={mode == 'banded'}): {s.n_f} faces, "
              f"{s.n_v} vertices; levels {_halo_modes(s)}; {_halo_levels(s)}; messages "
              f"{s.meta['messages']}; host build {secs:.1f} s, peak RSS {rss:.2f} GB (its "
              f"worker process); run_1m.py's halo8_virtual row: n_loc {row['n_loc']}, "
              f"h_total {row['h_total']}, rounds_L1v {row['rounds_L1v']}, msgs {row['msgs']}, "
              f"t_build_s {row['t_build_s']}, peak_rss_gb {row['peak_rss_gb']} (the JAX "
              f"package on its own host)")
        got = {"n_loc": sh.n_loc, "h_total": sh.h_total, "rounds_L1v": len(sh.rounds)}
        if mode == "table":
            assert got == LARGE_HALO_TOPOLOGY == {k: row[k] for k in got}, got
        else:  # the same halo; the slots rounded up to the band's tile
            assert _halo_modes(s) == LARGE_HALO_MODES, _halo_modes(s)
            assert sh.n_loc % 384 == 0 and sh.n_loc - 384 < LARGE_HALO_TOPOLOGY["n_loc"]
            assert {k: got[k] for k in ("h_total", "rounds_L1v")} == {
                k: LARGE_HALO_TOPOLOGY[k] for k in ("h_total", "rounds_L1v")}, got
        samples[mode] = s
    return samples


def large_halo_memory_phase(torch, state, sample, cfg):
    """[large-halo-memory]: one eager step of the table sample as the model
    ran before its table convs and fc heads were rematerialized
    (testing.without_remat()): its peak, or the allocation the card
    refused.  A measurement, not a phase of the path: the model runs
    rematerialized everywhere else."""
    from geobignn_tpu_torch.testing import eager_steps, without_remat

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model, opt, step = _halo_step(torch, state, sample, cfg)
    try:
        with eager_steps(), without_remat():
            step(sample.arrays, 1)
        torch.cuda.synchronize()
        outcome = "it fits"
    except torch.cuda.OutOfMemoryError as err:
        outcome = "torch.cuda.OutOfMemoryError: " + str(err).split(". ")[0]
    peak = torch.cuda.max_memory_allocated()
    del model, opt, step
    _free(torch)
    print(f"[large-halo-memory] one eager table-mode step without rematerialization "
          f"(testing.without_remat()): {outcome}; peak {_gib(peak)} "
          f"(torch.cuda.max_memory_allocated; {_gib(held)} held before: the sample) of "
          f"{_gib(torch.cuda.get_device_properties(0).total_memory)}")


def large_halo_train_phase(torch, np, sample, mode, state, cfg, kind, steps=5):
    """[large-halo-train] / [large-halo-train-banded]: make_halo_train_step
    under Adam at 1e-3 over the 8 parts on cuda:0: 3 eager steps (the first
    recorded) against 3 graphed from the same start (rotation on):
    parameters, Adam's moments and metric sums bit-equal; the eager peak
    and the graph's pool; `steps` graphed steps timed (CUDA events), edges/s,
    3 replays counted by kernel name (the capture's launches _halo_expected's
    24 + 24 banded, none in table mode) and profiled (busy share); then,
    the graph's memory returned, `steps` eager steps timed and one profiled.
    Returns the recorded forward and backward calls and the counted
    launches."""
    import itertools

    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import profiling

    tag = "large-halo-train" + ("-banded" if mode == "banded" else "")
    t0 = time.perf_counter()
    per_step = _halo_expected(sample, LARGE_HALO_PARTS)
    per_step.update({k + "_bwd": v for k, v in per_step.items() if v})
    _free(torch)
    held = torch.cuda.memory_allocated()
    fwd, bwd = {}, {}
    em, eo, estep = _halo_step(torch, state, sample, cfg)
    with eager_steps():
        with _recording(fwd), _recording(bwd, backward=True):
            sums = [_metric_sums(torch, estep(sample.arrays, 1))]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sums += [_metric_sums(torch, estep(sample.arrays, s)) for s in (2, 3)]
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    es = sum(sums)
    gm, go, gstep = _halo_step(torch, state, sample, cfg)
    gs = sum(_metric_sums(torch, gstep(sample.arrays, s)) for s in (1, 2, 3))
    (graph,) = gstep.program.graphs.values()
    same = _same_state(torch, gm, go, em, eo) and torch.equal(gs, es)
    in_bytes, pool_bytes = _graph_bytes(torch, graph)
    print(f"[{tag}] {LARGE_HALO_PARTS} parts on cuda:0, Adam at {cfg.lr}, the port's seeded "
          f"parameters: 3 steps eager against 3 graphed from the same start (rotation on): "
          f"parameters, Adam's moments and metric sums bit-equal {same}; the eager step's "
          f"peak {_gib(peak)} (torch.cuda.max_memory_allocated; {_gib(before)} held before "
          f"it: the sample {_gib(held)}, the recorded kernel inputs, the model); the "
          f"graph's pool {_gib(pool_bytes)}, its static inputs {_gib(in_bytes)}; "
          f"{time.perf_counter() - t0:.1f} s into the phase")
    assert same and graph.replays == 2, (same, graph.replays)
    assert graph.launches == per_step, (graph.launches, per_step)
    assert {k: sum(e["calls"] for kk, e in rec.items() if kk[0] == k)
            for rec in (fwd, bwd) for k in {kk[0] for kk in rec}} == _nonzero(per_step)

    it = itertools.count(100)
    graphed = profiling.time_steps(lambda: gstep(sample.arrays, next(it)), steps=steps)
    with _counted() as cnt:  # replays: the wrappers count none
        for _ in range(3):
            gstep(sample.arrays, next(it))
    g_prof = _profiled(lambda i: gstep(sample.arrays, i), steps=3)
    assert sum(cnt["wrappers"].values()) == 0 and _replayed(cnt, graph, 3, 0), cnt
    del gm, go, gstep, graph
    _free(torch)  # the graph's pool, before the eager steps
    with eager_steps():
        eager = profiling.time_steps(lambda: estep(sample.arrays, next(it)), steps=steps,
                                     warmup=1)
        e_prof = _profiled(lambda i: estep(sample.arrays, i), steps=1)
    del em, eo, estep
    _free(torch)
    msgs = sample.meta["messages"]
    groups = sorted(g_prof[3].items(), key=lambda kv: -kv[1][0])
    print(f"[{tag}] one step: graphed {_spread(graphed)}, {_busy(g_prof)}; eager "
          f"{_spread(eager)}, {_busy(e_prof)} (CUDA events); {msgs / (graphed['median_ms'] / 1e3):.4e}"
          f" edges/s at the graphed median ({msgs} messages); the graph's device time by "
          f"kernel group: " + ", ".join(f"{g} {ms:.3f} ms in {n:.0f}" for g, (ms, n) in groups)
          + f"; 3 replays by kernel name {_nonzero(cnt['device'])}, the capture recorded "
          f"{_nonzero(per_step)} a step (expected: {LARGE_HALO_PARTS} parts x banded level-1 "
          f"convs each way); card {kind}; the phase {time.perf_counter() - t0:.1f} s")
    return fwd, bwd, cnt["device"]


def large_halo_kernel_phase(torch, fwd, bwd, kind):
    """[large-halo-kernel]: every distinct #1-#4 call of the banded step
    (part 0's inputs at each shape; tile 384) against its plain version on
    the card.  Returns the rows."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = [check_forward(key, fwd[key], reps=10, tag="large-halo-kernel")
            for key in sorted(fwd)]
    rows += [check_backward(key, bwd[key], gen, reps=10, tag="large-halo-kernel-bwd")
             for key in sorted(bwd)]
    assert rows and all(r["tile"] == 384 for r in rows), [r["tile"] for r in rows]
    for name in AGGREGATES[:2] + AGGREGATES[4:6]:  # #1-#4
        mine = [r for r in rows if r["kernel"] == name]
        per = lambda f: sum(r["calls"] * r[f] for r in mine)
        print(f"[large-halo-kernel] {name} per banded step: {sum(r['calls'] for r in mine)} "
              f"calls of "
              f"{[r['ms'] for r in mine]} ms each, kernel {per('ms'):.3f} ms, plain "
              f"{per('plain_ms'):.3f} ms, bound {per('bound_ms'):.4f} ms; card {kind}")
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _normalized_inputs(calls):
    """While open, geometry.safe_normalize appends each input it is given,
    detached, to `calls`."""
    from geobignn_tpu_torch import geometry

    fn = geometry.safe_normalize
    geometry.safe_normalize = lambda x, dim=-1: calls.append(x.detach()) or fn(x, dim)
    try:
        yield calls
    finally:
        geometry.safe_normalize = fn


def large_halo_single_phase(torch, np, samples, single, state, cfg, mel, kind):
    """[large-halo-vs-single]: the table-mode halo forward and loss against
    the single-device DualGNN on the same owner-constrained hierarchies
    (its convs dense-table convs): in float32 the positions within F32_TOL
    of max and the loss within 1e-5; the normals in float64 (parameters,
    sample and compute) within F32_TOL of max, and in float32 printed with
    what magnifies them: the facet branch's input normals are the cross
    products of the predicted triangles, so the positions' rounding reaches
    a face's normal divided by its triangle's area (random weights predict
    near-degenerate ones); the gradients' agreement printed; the
    single-device step timed.  Then the banded halo forward
    against the table one, as [halo]: its aggregates in float32
    (POS_TOL_MEL / NORMAL_TOL) and with bf16 operands (POS_TOL_MEL /
    LARGE_HALO_BF16_NORMAL_TOL).  Returns the single-device step's ms."""
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.params import tree_of
    from geobignn_tpu_torch.parallel import halo_train as ht
    from geobignn_tpu_torch.parallel import partition as hp
    from geobignn_tpu_torch.testing import aggregates_in, eager_steps, float64_sample
    from geobignn_tpu_torch.train.trainer import _metrics_of

    t0 = time.perf_counter()
    model = DualGNN(device="cuda")  # float32 heads, as the halo model's
    model.load_state_dict(state)
    halo = samples["table"].to([torch.device("cuda", 0)] * LARGE_HALO_PARTS)
    one = single.to("cuda")
    n_v, n_f = halo.n_v, halo.n_f
    seen_h, seen_s = [], []  # what each forward normalizes, in call order
    with eager_steps(), _normalized_inputs(seen_h):
        v_h, n_h = ht.unshard_predictions(
            halo, *ht.make_halo_forward(model, halo.static, cfg.pool_type)(halo.arrays))
    with torch.no_grad(), _normalized_inputs(seen_s):
        v_s, n_s = (t.cpu().numpy() for t in model(one))
    n_s = n_s[:n_f]
    e_v, e_n = _rel(v_h, v_s[:n_v]), _rel(n_h, n_s)
    # the facet branch's input normals (the cross products of the predicted
    # triangles, each model's first normalization) and its heads' outputs
    # (the last): a difference of the predicted positions reaches a face's
    # normal divided by its triangle's area
    unshard = lambda parts: hp.unshard_features(
        np.stack([t.cpu().numpy() for t in parts]), halo.structure.f.levels[0], n_f)
    cross_h, head_h = unshard(seen_h[:LARGE_HALO_PARTS]), unshard(seen_h[-LARGE_HALO_PARTS:])
    cross_s, head_s = (seen_s[k][:n_f].cpu().numpy() for k in (0, -1))
    del seen_h, seen_s
    area = np.linalg.norm(cross_s, axis=1)
    area = area / np.median(area)
    unit = lambda a: a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    d_in = np.abs(unit(cross_h) - unit(cross_s)).max(axis=1)
    worst_in, worst_out = int(d_in.argmax()), int(np.abs(n_h - n_s).max(axis=1).argmax())

    grads = []
    for run in ("halo", "single"):
        model.zero_grad(set_to_none=True)
        if run == "halo":
            loss, _ = ht._halo_loss(tree_of(model), halo.arrays, halo.static, cfg.pool_type,
                                    cfg.loss_cfg())
        else:
            loss = _metrics_of(*model(one), one, cfg)[0]
        loss.backward()
        grads.append((float(loss.detach()), {k: p.grad.detach().clone()
                                             for k, p in model.named_parameters()}))
        del loss
        _free(torch)
    (l_h, g_h), (l_s, g_s) = grads
    worst = max(((float((g_h[k] - g_s[k]).abs().max()) / max(float(g_s[k].abs().max()), 1e-30),
                  k) for k in g_s))

    def single_step():
        model.zero_grad(set_to_none=True)
        _metrics_of(*model(one), one, cfg)[0].backward()

    single_ms = _cuda_ms(single_step, reps=3, warmup=1)
    del grads, g_h, g_s
    model.zero_grad(set_to_none=True)

    # both forwards in float64 (parameters, sample and compute), where no
    # triangle's conditioning reaches 1e-4
    m64 = DualGNN(compute_dtype=torch.float64, fc_dtype=torch.float64, device="cuda")
    m64.to(torch.float64).load_state_dict(state)
    h64 = _float64(torch, halo)
    with eager_steps():
        v_h64, n_h64 = ht.unshard_predictions(h64, *ht.make_halo_forward(
            m64, h64.static, cfg.pool_type, torch.float64)(h64.arrays))
    with torch.no_grad():
        v_s64, n_s64 = (t.cpu().numpy() for t in m64(float64_sample(one)))
    e64 = (_rel(v_h64, v_s64[:n_v]), _rel(n_h64, n_s64[:n_f]))
    del m64, h64
    print(f"[large-halo-vs-single] table mode against the single-device DualGNN on the "
          f"same hierarchies ({n_f} faces; dense-table convs): float32, positions "
          f"{e_v:.3e} of max (tol {F32_TOL}), loss {l_h:.9f} against {l_s:.9f} "
          f"({abs(l_h - l_s) / abs(l_s):.3e} relative, tol 1e-5); float64, positions "
          f"{e64[0]:.3e} and normals {e64[1]:.3e} of max (tol {F32_TOL}); float32 normals, "
          f"printed: {e_n:.3e}, the heads' outputs {_rel(head_h, head_s):.3e} of max, the "
          f"facet branch's input normals {float(d_in.max()):.3e} at a triangle of "
          f"{area[worst_in]:.3e} the median area ({int((area < 1e-3).sum())} of "
          f"{n_f} under 1e-3; the output's worst face {area[worst_out]:.3e}); gradients "
          f"(float32): worst tensor {worst[1]} {worst[0]:.3e} of its max|g| (a finding: "
          f"LeakyReLU near-ties fall apart between two programs at this size); the "
          f"single-device step {single_ms:.3f} ms eager (CUDA events, 3 steps); card {kind}")
    assert np.isfinite([l_h, l_s]).all() and np.isfinite(n_h).all()
    assert e_v <= F32_TOL and abs(l_h - l_s) <= 1e-5 * abs(l_s)
    assert max(e64) <= F32_TOL, e64
    del one, halo
    _free(torch)

    # banded against table, as [halo]: the aggregates in float32 compute to
    # the model tolerances; with the default's bf16 operands the positions
    # to POS_TOL_MEL and the normals to LARGE_HALO_BF16_NORMAL_TOL.  Only
    # vertex level 1 bands, so the normals differ only through the predicted
    # positions, magnified by the facet branch (table convs in both runs) at
    # its near-degenerate triangles: the ratio of the two distances printed
    banded = samples["banded"].to([torch.device("cuda", 0)] * LARGE_HALO_PARTS)
    fwd = ht.make_halo_forward(model, banded.static, cfg.pool_type)
    with eager_steps():
        with aggregates_in(torch.float32):
            v_32, n_32 = ht.unshard_predictions(banded, *fwd(banded.arrays))
        v_b, n_b = ht.unshard_predictions(banded, *fwd(banded.arrays))
    errs = {k: (float(np.abs(v - v_h).max()) / mel, float(np.abs(n - n_h).max()))
            for k, (v, n) in (("float32", (v_32, n_32)), ("bf16", (v_b, n_b)))}
    print(f"[large-halo-vs-single] banded ({_halo_modes(banded)}) against table mode: "
          f"aggregates in float32, positions {errs['float32'][0]:.3e} mean edge lengths "
          f"(tol {POS_TOL_MEL}), normals {errs['float32'][1]:.3e} (tol {NORMAL_TOL}); bf16 "
          f"aggregate operands, positions {errs['bf16'][0]:.3e} (tol {POS_TOL_MEL}), normals "
          f"{errs['bf16'][1]:.3e} (tol {LARGE_HALO_BF16_NORMAL_TOL}: {HALO_WITNESS} x the JAX "
          f"package's own at 81,920 faces); the normals' distance over the positions' "
          + ", ".join(f"{k} {n / max(pos, 1e-30):.3e}" for k, (pos, n) in errs.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    assert all(np.isfinite(a).all() for a in (v_32, n_32, v_b, n_b))
    assert errs["float32"][0] <= POS_TOL_MEL and errs["float32"][1] <= NORMAL_TOL
    assert errs["bf16"][0] <= POS_TOL_MEL and errs["bf16"][1] <= LARGE_HALO_BF16_NORMAL_TOL
    del banded, fwd, model
    _free(torch)
    return single_ms


def large_halo_serve_phase(torch, np, state, mesh, clean, patches, kind):
    """[large-halo-serve]: Predictor(Config()).predict_mesh_halo(mesh, 8,
    banded=True, devices=[cuda:0] * 8) of the noisy 1,310,720-face mesh
    (its first call warms up and captures the forward's graph), the
    predictor's 60 update iterations, the .obj written and
    eval_denoising_result on the card (#7 held against its plain version on
    the points it was given); the forward's replay against its eager run
    (bit-equal) and counted; seconds split into host build, forward, updates,
    write and evaluation; and, as a witness, the distance to the same mesh
    served patch by patch (predict_mesh over the patch dataset a worker
    built, as --large's [large-serve-8]; no bound: halo pooling is
    partition-constrained, so the two are different models of one family).
    Returns the counted launches and #7's row and launches."""
    from geobignn_tpu_torch import geometry, meshio
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer import evaluate, predict
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.parallel import halo_train as ht
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import profiling

    _free(torch)
    pred = predict.Predictor(Config(), state, device="cuda")
    devs = [torch.device("cuda", 0)] * LARGE_HALO_PARTS
    kept, host = [], {"s": 0.0}
    build = ht.build_halo_train_sample

    def timed_build(*args, **kw):  # the predictor's host build, timed and kept
        t = time.perf_counter()
        kept.append(build(*args, **kw))
        host["s"] += time.perf_counter() - t
        return kept[-1]

    ht.build_halo_train_sample = timed_build
    try:
        t0 = time.perf_counter()
        vp, nf = pred.predict_mesh_halo(mesh, LARGE_HALO_PARTS, True, devs)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    finally:
        ht.build_halo_train_sample = build
    (sample,) = kept
    fwd = pred._halo[1]
    (graph,) = fwd.program.graphs.values()
    want = _halo_expected(sample, LARGE_HALO_PARTS)
    with _counted() as cnt:  # the main path's forward: one replay
        got = [t.clone() for outs in fwd(sample.arrays) for t in outs]
    with eager_steps():
        ref = [t.clone() for outs in fwd(sample.arrays) for t in outs]
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    del got, ref
    graphed = profiling.time_steps(lambda: fwd(sample.arrays), steps=5)
    with eager_steps():
        eager = profiling.time_steps(lambda: fwd(sample.arrays), steps=3, warmup=1)
    print(f"[large-halo-serve] predict_mesh_halo of the noisy mesh "
          f"({mesh.n_faces} faces) over {LARGE_HALO_PARTS} parts on cuda:0, banded, "
          f"Config(): levels {_halo_modes(sample)}; the first call {call_s:.3f} s, of which "
          f"the host build {host['s']:.3f} s and the forward's warm-up and capture "
          f"{call_s - host['s']:.3f} s; the forward graphed {_spread(graphed)}, eager "
          f"{_spread(eager)} (CUDA events); a replay against the eager forward: bit-equal "
          f"{same}; the replay by kernel name {_nonzero(cnt['device'])}, the capture "
          f"recorded {_nonzero(graph.launches)}, expected {_nonzero(want)}")
    assert same and graph.launches == want and cnt["device"] == _aggregates(want), cnt
    assert sum(cnt["wrappers"].values()) == 0 and want["aggregate_first"] > 0
    assert _halo_modes(sample).startswith("v: L1 banded tile 384"), _halo_modes(sample)
    assert np.isfinite(vp).all() and np.isfinite(nf).all()
    del sample, kept, fwd, graph
    pred._halo = None
    _free(torch)

    dev = torch.device("cuda")
    fv = torch.from_numpy(mesh.fv_indices.astype(np.int64)).to(dev)
    vf = torch.from_numpy(mesh.vf_indices.astype(np.int64)).to(dev)

    def updated(vp, nf):
        v = predict.update_positions(torch.from_numpy(vp).to(dev), fv, vf,
                                     torch.from_numpy(nf).to(dev), n_iter=60)
        return v.cpu().numpy()

    t0 = time.perf_counter()
    v = updated(vp, nf)
    upd_s = time.perf_counter() - t0
    seen, nearest = [], evaluate.nearest_distance

    def keep(a, b):  # the points #7 is given
        seen.append((a.clone(), b.clone()))
        return nearest(a, b)

    with tempfile.TemporaryDirectory() as root:
        res_dir, orig_dir = os.path.join(root, "result"), os.path.join(root, "original")
        os.makedirs(res_dir)
        os.makedirs(orig_dir)
        meshio.write_obj(os.path.join(orig_dir, "ball.obj"), clean.points, clean.fv_indices)
        t0 = time.perf_counter()
        meshio.write_obj(os.path.join(res_dir, "ball_n1-60.obj"), v, mesh.fv_indices)
        write_s = time.perf_counter() - t0
        banded_cuda.reset_launches()
        evaluate.nearest_distance = keep
        try:
            t0 = time.perf_counter()
            ev = evaluate.eval_denoising_result(res_dir, orig_dir, device="cuda")
            eval_s = time.perf_counter() - t0
        finally:
            evaluate.nearest_distance = nearest
        nn = banded_cuda.LAUNCHES["nearest"]
    corpus = ev["corpus"]
    print(f"[large-halo-serve] 60 update iterations {upd_s:.3f} s; the .obj written in "
          f"{write_s:.3f} s; eval_denoising_result {eval_s:.3f} s, #7 launched {nn} "
          f"time(s), angle {corpus['angle']:.4f}, vertex distance "
          f"{corpus['vertex_dist']:.4e} (random weights); the mesh "
          f"{call_s + upd_s + write_s + eval_s:.3f} s in all; card {kind}")
    assert nn == 1 and corpus["n_verts"] == mesh.n_vertices, (nn, corpus)
    assert np.isfinite([corpus["angle"], corpus["vertex_dist"]]).all()
    ((a, b),) = seen
    nn_row = check_nearest(torch, "serve-halo-8", a, b, calls=nn, reps=3, plain_reps=1,
                           brute=False, library=False)
    del seen, a, b

    # the witness: the same mesh served patch by patch ([large-serve-8])
    pred.patch_dataset = lambda m: patches
    t0 = time.perf_counter()
    vp_w, nf_w = pred.predict_mesh(mesh)
    v_w = updated(vp_w, nf_w)
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    print(f"[large-halo-serve] witness, no bound: the halo-served mesh against the same "
          f"mesh served in {len(patches.entries)} patches (predict_mesh, {time.perf_counter() - t0:.1f} s "
          f"on the card and the host, its patches built by a worker): predicted positions "
          f"{float(np.abs(vp - vp_w).max()) / mel:.3e}, updated positions "
          f"{float(np.abs(v - v_w).max()) / mel:.3e} mean edge lengths, normals "
          f"{float(np.abs(nf - nf_w).max()):.3e} (max); halo pooling is partition-"
          f"constrained, so these are two models of one family")
    del pred
    _free(torch)
    return cnt["device"], nn_row, nn


def large_halo_main(torch, np, kind, t_start, state, hosts):
    """python3 chip_smoke.py --large-halo: examples/run_1m.py's 8-part halo
    training step of the 1,310,720-face mesh on one card, in table mode and
    banded, and the mesh's halo serving with `state` (--large's weights)."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.geometry import mean_edge_length_np
    from geobignn_tpu_torch.models.dual_gnn import DualGNN

    pools, futures = hosts
    row = _run_1m_row()
    clean = synth.icosphere(8)
    mesh = synth.add_noise(clean, 0.2, seed=0)
    samples = large_halo_build_phase(torch, futures, row)
    _lap(t_start, "[large-halo-build]")
    cfg = Config(seed=0, lr=1e-3)
    train_state = DualGNN(device="cpu", seed=0).state_dict()  # params.init_, seed 0
    cuda = [torch.device("cuda", 0)] * LARGE_HALO_PARTS
    large_halo_memory_phase(torch, train_state, samples["table"].to(cuda), cfg)
    for mode in ("table", "banded"):
        # the banded step, the last, leaves its recorded calls and launches
        fwd, bwd, launches = large_halo_train_phase(torch, np, samples[mode].to(cuda), mode,
                                                    train_state, cfg, kind)
        _lap(t_start, f"[large-halo-train{'-banded' if mode == 'banded' else ''}]")
    rows = large_halo_kernel_phase(torch, fwd, bwd, kind)
    del fwd, bwd
    _lap(t_start, "[large-halo-kernel]")
    single, secs, rss = futures["single"].result()
    print(f"[large-halo-vs-single] the single-device sample over the same hierarchies "
          f"(_single_device_sample with attach_tables): host build {secs:.1f} s, peak RSS "
          f"{rss:.2f} GB (its worker process)")
    mel = mean_edge_length_np(mesh.points, mesh.ev_indices) * float(
        samples["table"].meta["scale"])  # the samples' coordinates are normalized
    single_ms = large_halo_single_phase(torch, np, samples, single, train_state, cfg, mel,
                                        kind)
    del single
    from geobignn_tpu_torch.parallel import accounting

    for mode in ("table", "banded"):
        rep = accounting.halo_comm_report(samples[mode].structure,
                                          step_ms_single_chip=single_ms)
        print(f"[large-halo-comm] {mode}: halo_comm_report with the single-device step "
              f"measured here ({single_ms:.3f} ms; run_1m.py assumed 600): efficiency "
              f"{rep['efficiency_no_overlap']:.4f} without overlap, "
              f"{rep['efficiency_real_cut']:.4f} on the real cut; per step "
              f"{rep['step_payload_mb']:.3f} MB in {rep['n_rounds_step']} rounds (run_1m.py's "
              f"row: {row['eff_no_overlap']}, {row['eff_real_cut']}, {row['payload_mb']} MB)")
    del samples
    _lap(t_start, "[large-halo-vs-single]")
    patches, secs, rss = futures["patches"].result()
    for pool in pools:
        pool.shutdown()
    print(f"[large-halo-serve] the witness's patch dataset: {len(patches.entries)} patches, "
          f"host build {secs:.1f} s, peak RSS {rss:.2f} GB (its worker process)")
    served, nn_row, nn = large_halo_serve_phase(torch, np, state, mesh, clean, patches, kind)
    _lap(t_start, "[large-halo-serve]")

    kernels = []
    for name in AGGREGATES[:2] + AGGREGATES[4:6]:  # #1-#4
        mine = [r for r in rows if r["kernel"] == name]
        kernels.append(_kernel_entry(name, mine, launches[name] + served[name]))
    kernels.append({
        "name": "nearest_distance", "route": "cuda",
        "source": "geobignn_tpu_torch/csrc/nearest.cu",
        "replaces": "geobignn_tpu/ops/pallas_nn.py:42", "launches": nn,
        **{k: nn_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}})
    print(f"[time] {time.perf_counter() - t_start:.1f} s after the card was found")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def sharded_phase(torch, np, train_ds, kind):
    """Phase 17, [dp] / [gp] / [dcn]: Trainer(Config(dp=2)), Config(gp=2)
    and Config(dcn=2, dp=1) on [cuda:0] * 2 over phase 7's patches: one
    eager step's gradient against the single-device step of the same (COO)
    model; the graphed step against the eager one (3 steps, rotation on:
    parameters, Adam's moments and metric sums bit-equal), a replay counted,
    both timed and profiled; then Trainer.fit, graphed."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.parallel import api
    from geobignn_tpu_torch.testing import eager_steps, grad_agreement
    from geobignn_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda", 0)
    for grid in (dict(dp=2), dict(gp=2), dict(dcn=2, dp=1)):
        t_grid = time.perf_counter()
        tag = next(iter(grid))
        cfg = Config(seed=0, max_epoch=1, augment=False, fc_precision="float32", **grid)
        tr = Trainer(cfg, train_ds, devices=[dev] * 2)
        state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        idx = list(range(tr._global_batch))
        batch = api.stack_samples([train_ds.get(i, tr.plan) for i in idx])
        with eager_steps():  # an eager step leaves its gradient in .grad
            tr._sharded_step(batch, 0)
        ref = DualGNN(device="cuda")
        ref.load_state_dict(state)
        for i in idx:
            loss, _ = api.dual_loss_and_metrics(ref, None, train_ds.get(i, tr.plan).to(dev),
                                                cfg.loss_cfg(), [dev])
            loss.backward()
        for prm in ref.parameters():
            prm.grad.div_(len(idx))
        worst = max(v[0] for v in grad_agreement(tr.model, ref).values())
        del tr, ref
        # graphed against eager: 3 steps of the same batch and seeds
        runs = []
        for eager in (False, True):
            t = Trainer(dataclasses.replace(cfg, augment=True), train_ds, devices=[dev] * 2)
            t.model.load_state_dict(state)
            with eager_steps() if eager else contextlib.nullcontext():
                sums = sum(torch.stack([v for _, v in sorted(t._sharded_step(batch, seed).items())])
                           for seed in (1, 2, 3))
            runs.append((t, sums))
        (g, gs), (e, es) = runs
        same = _same_state(torch, g.model, g.optimizer, e.model, e.optimizer) and torch.equal(gs, es)
        (graph,) = g._sharded_step.program.graphs.values()
        with _counted() as cnt:
            g._sharded_step(batch, 4)
        times = _graph_and_eager(lambda i: g._sharded_step(batch, i))
        del g, e, runs
        hist = []
        tr = Trainer(cfg, train_ds, devices=[dev] * 2)
        banded_cuda.reset_launches()
        tr.fit(on_epoch=lambda t, m, e: hist.append(m))
        print(f"[{tag}] {grid}: one step ({len(idx)} of phase 7's patches, 2 grid entries on "
              f"cuda:0" + ("; one process: a multi-card or multi-process time is not "
                           "measured" if tag == "dcn" else "") + ") against the single-device "
              f"step of the same model: worst tensor {worst:.3e} of its max|g| (tol "
              f"{F32_GRAD_TOL}); 3 steps graphed against eager (rotation on): parameters, "
              f"Adam's moments and metric sums bit-equal {same}; a replay, by kernel name "
              f"{_nonzero(cnt['device'])}, the capture recorded {_nonzero(graph.launches)}")
        print(f"[{tag}] one step, CUDA events: {_both(times)}")
        print(f"[{tag}] fit (graphed): loss {hist[0]['loss']:.6f}, "
              f"{hist[0]['samples_per_s']:.3f} samples/s, {hist[0]['edges_per_s']:.4e} "
              f"edges/s, {len(tr._sharded_step.program.graphs)} graph; aggregate kernels "
              f"launched {_nonzero(banded_cuda.LAUNCHES)} (the sharded model's convs are "
              f"COO, as the JAX model's with gp_axis); card {kind}; "
              f"{time.perf_counter() - t_grid:.1f} s for this grid")
        assert worst <= F32_GRAD_TOL and np.isfinite(hist[0]["loss"]) and same
        assert _replayed(cnt, graph, 1, 0) and sum(cnt["device"].values()) == 0, cnt
        assert sum(banded_cuda.LAUNCHES.values()) == 0
        assert len(tr._sharded_step.program.graphs) == 1
        del tr, batch
        torch.cuda.empty_cache()


LEGACY_MODELS = ("FacetAttentionGNN", "FGCNet", "FeaStGNNPrePool", "GATGNN")


def _legacy_expected(branch, model):
    """Aggregate launches of one forward and backward of a legacy model on
    `branch`: each FeaStConv on a level with a band launches the schedule
    its widths pick (block-sparse where the level is), and a second banded
    one where the level has a boundary sub-band; once each way.  The GCN and
    GAT convs launch none."""
    from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE, FeaStConv
    from geobignn_tpu_torch.ops.banded_cuda import use_transform_first

    want = dict.fromkeys(AGGREGATES, 0)
    for name, lvl, _, _ in CONV_SCHEDULE:
        conv, level = getattr(model, name, None), branch.levels[lvl]
        if not isinstance(conv, FeaStConv) or level.band is None:
            continue
        kind = FWD[use_transform_first(*conv.w.shape[1:])]
        if level.blk_idx is not None:
            want["bs_" + kind] += 1
        else:
            want[kind] += 1 + (level.jnodes is not None)
    want.update({k + "_bwd": v for k, v in want.items() if not k.endswith("_bwd")})
    return want


def legacy_phase(torch, np, train_ds, seeds, kind):
    """Phase 18, [legacy]: the four legacy models (models/legacy.py) with
    seeded weights on the facet branch of phase 7's patch 0, on the input
    slices of tests/test_legacy_models.py.  Per model: the forward and
    backward of the summed squared error, counted (#1-#6 by the wrappers and
    by kernel name, against _legacy_expected) and recorded; the forward on
    the card against device="cpu" (bf16 aggregate operands: NORMAL_TOL); the
    float32 gradients against the CPU's, the CPU held to the card's
    branches (F32_GRAD_TOL, or, for a tensor whose float32 sum cancels
    further than that from the float64 step, three times the CPU's own
    distance, as tests/test_torch_legacy.py); forward and forward+backward
    times.  Returns the counted launches and the recorded calls."""
    from geobignn_tpu_torch.models import legacy
    from geobignn_tpu_torch.testing import (TIE_TOL, aggregates_in, float64_sample,
                                            grad_agreement, same_branches)
    from geobignn_tpu_torch.train import profiling

    tag = f"legacy{seeds}"
    raw = train_ds.get(0).f  # numpy: .to() moves numpy arrays only
    b_cpu, b_gpu = raw.to("cpu"), raw.to("cuda")
    n = int(b_cpu.levels[0].node_mask.sum())
    modes = ["table" if lv.band is None else "block-sparse" if lv.blk_idx is not None
             else f"banded tile {lv.band.shape[1]}" + (" + sub-band" if lv.jnodes is not None
                                                        else "") for lv in b_cpu.levels]
    print(f"[{tag}] facet branch of patch 0: {n} faces, levels {modes}")
    launched = dict.fromkeys(AGGREGATES, 0)
    recorded = []

    def sse(mdl, b, sl, dt=None):
        mdl.zero_grad(set_to_none=True)
        with aggregates_in(dt) if dt else contextlib.nullcontext():
            loss = ((mdl(b, b.x[:, sl]) - b.y) ** 2).sum()
            loss.backward()
        return float(loss.detach())

    for name in LEGACY_MODELS:
        cls = getattr(legacy, name)
        sl = slice(3, 6) if name == "FacetAttentionGNN" else slice(0, 6)
        model = cls(device="cuda", seed=7)
        state = model.state_dict()
        cpu = cls(device="cpu")
        cpu.load_state_dict(state)
        want = _legacy_expected(b_gpu, model)
        fwd_rec, bwd_rec = {}, {}  # per model: the recording keys leave out the heads
        with _recording(fwd_rec), _recording(bwd_rec, backward=True), _counted() as cnt:
            sse(model, b_gpu, sl)
        assert _aggregates(cnt["wrappers"]) == want and cnt["device"] == want, (name, cnt)
        launched = {k: launched[k] + want[k] for k in AGGREGATES}
        recorded.append((fwd_rec, bwd_rec))

        with torch.no_grad():
            out_g = model(b_gpu, b_gpu.x[:, sl]).cpu()
            t0 = time.perf_counter()
            out_c = cpu(b_cpu, b_cpu.x[:, sl])
            cpu_s = time.perf_counter() - t0
        e_n = float((out_g[:n] - out_c[:n]).abs().max())
        assert bool(torch.isfinite(out_g).all()) and e_n <= NORMAL_TOL, (name, e_n)

        picks: list = []
        with same_branches(picks, replay=False):
            l_g = sse(model, b_gpu, sl, torch.float32)
        with same_branches(picks, replay=True) as flips:
            l_c = sse(cpu, b_cpu, sl, torch.float32)
        stats = {k: v[0] for k, v in grad_agreement(model, cpu).items()}
        over, own = {k: v for k, v in stats.items() if v > F32_GRAD_TOL}, {}
        if over:  # a sum that cancels: the CPU's own float32 distance
            c64 = cls(device="cpu").to(torch.float64)
            c64.load_state_dict(state)
            with same_branches(picks, replay=True):
                sse(c64, float64_sample(b_cpu), sl, torch.float64)
            own = {k: v[0] for k, v in grad_agreement(cpu, c64).items() if k in over}
        worst = max(stats, key=stats.get)
        assert flips[0] <= LEGACY_MAX_HELD and abs(l_g - l_c) <= 1e-5 * abs(l_c), \
            (name, flips, l_g, l_c)
        assert all(v <= 3 * own[k] for k, v in over.items()), (name, over, own)

        with torch.no_grad():
            fwd = profiling.time_steps(lambda: model(b_gpu, b_gpu.x[:, sl]), steps=20)
        both = profiling.time_steps(lambda: sse(model, b_gpu, sl), steps=20)
        print(f"[{tag}] {name}" + (f" ({model.heads} heads)" if hasattr(model, "heads") else "")
              + f": launches by kernel name {_nonzero(cnt['device'])}, wrappers "
              f"{_nonzero(_aggregates(cnt['wrappers']))}, expected {_nonzero(want)}; "
              f"normals GPU vs device=\"cpu\" {e_n:.3e} (tol {NORMAL_TOL}; CPU forward "
              f"{cpu_s:.2f} s); float32 gradients GPU vs CPU: loss {l_g:.6f} vs {l_c:.6f}, "
              f"worst tensor {worst} {stats[worst]:.3e} of its max|g| (tol {F32_GRAD_TOL}"
              + (", over it: " + ", ".join(f"{k} {v:.3e} (the CPU's own float32 "
                                           f"{own[k]:.3e} from float64, tol 3x)"
                                           for k, v in over.items()) if over else "")
              + f"); branches held {flips[0]} (at most {LEGACY_MAX_HELD}; widest "
              f"{flips[1]:.3e}, near-ties within {TIE_TOL}); forward {_spread(fwd)}, forward+backward {_spread(both)} "
              f"(CUDA events); card {kind}")
        del model, cpu
        torch.cuda.empty_cache()
    return launched, recorded


def icp_phase(torch, np, kind):
    """Phase 19, [icp]: utils.icp_align on the card against device="cpu" on
    the icosphere(5) vertex set (10,242 points) and its copy rotated by 0.3
    degrees about a skew axis and shifted, each point moving less than half
    the spacing, so that every nearest point is unique and its own image:
    R and t within 1e-5, R within 1e-4 of the true rotation; time."""
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.train import profiling
    from geobignn_tpu_torch.utils import icp_align

    src = synth.icosphere(5).points.astype(np.float64)
    axis = np.array([0.3, -0.5, 0.81]) / np.linalg.norm([0.3, -0.5, 0.81])
    ang = np.radians(0.3)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
    dst = src @ rot.T + np.array([0.002, -0.0015, 0.0025])
    args = [torch.from_numpy(a.astype(np.float32)) for a in (src, dst)]
    gpu = [a.to("cuda") for a in args]
    _, r_g, t_g = icp_align(*gpu)
    t0 = time.perf_counter()
    _, r_c, t_c = icp_align(*args)
    cpu_s = time.perf_counter() - t0
    e_r, e_t = (float((a.cpu() - b).abs().max()) for a, b in ((r_g, r_c), (t_g, t_c)))
    e_true = float(np.abs(r_g.cpu().numpy() - rot).max())
    t = profiling.time_steps(lambda: icp_align(*gpu), steps=20)
    print(f"[icp] icp_align, 10 iterations, {src.shape[0]} points: GPU vs device=\"cpu\" "
          f"R {e_r:.3e}, t {e_t:.3e} (tol 1e-5); R vs the true rotation {e_true:.3e} "
          f"(tol 1e-4); {_spread(t)} (CUDA events; CPU {cpu_s:.3f} s); card {kind}")
    assert e_r <= 1e-5 and e_t <= 1e-5 and e_true <= 1e-4


def viz_phase(torch, np, mesh, vp, kind):
    """Phase 20, [viz]: viz.hausdorff_heatmap of phase 3's served result
    (its positions on the noisy mesh's faces) against the clean
    icosphere(5), on the card (#7, counted) and with device="cpu": the
    distances it colors by within #7's tolerance of the CPU's (squared),
    both .off files written.  Returns #7's launches."""
    from geobignn_tpu_torch import meshio, viz
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.models import losses
    from geobignn_tpu_torch.ops import banded_cuda

    result, clean = meshio.TriMesh(vp, mesh.fv_indices), synth.icosphere(5)
    seen, nearest = [], losses.nearest_distance

    def keep(*args, **kw):  # the distances the heatmap colors by
        seen.append(nearest(*args, **kw))
        return seen[-1]

    losses.nearest_distance = keep
    tmp = tempfile.mkdtemp(prefix="viz_")
    try:
        banded_cuda.reset_launches()
        t0 = time.perf_counter()
        path = viz.hausdorff_heatmap(os.path.join(tmp, "gpu.off"), result, clean)
        gpu_s = time.perf_counter() - t0
        launches = banded_cuda.LAUNCHES["nearest"]
        path_c = viz.hausdorff_heatmap(os.path.join(tmp, "cpu.off"), result, clean,
                                       device="cpu")
        lines = [open(p).read().splitlines() for p in (path, path_c)]
    finally:
        losses.nearest_distance = nearest
        shutil.rmtree(tmp, ignore_errors=True)
    d_g, d_c = (d.double().cpu() for d in seen)
    scale = float((torch.from_numpy(result.points).double() ** 2).sum(1).max()
                  + (torch.from_numpy(clean.points).double() ** 2).sum(1).max())
    err = float((d_g ** 2 - d_c ** 2).abs().max()) / scale
    same = sum(a == b for a, b in zip(*lines)) / len(lines[1])
    print(f"[viz] hausdorff_heatmap of the served seed-0 result ({result.n_vertices} "
          f"vertices) against icosphere(5): #7 launched {launches}; squared distances "
          f"GPU vs device=\"cpu\" {err:.3e} of max(|a|^2 + |b|^2) (tol {NEAREST_TOL}); "
          f"largest distance {float(d_g.max()):.6f}; .off written ({len(lines[0])} lines, "
          f"{same:.6f} of them equal to the CPU's); {gpu_s:.3f} s wall; card {kind}")
    assert launches == 1 and seen[0].is_cuda and err <= NEAREST_TOL
    assert lines[0][0] == "COFF" and len(lines[0]) == len(lines[1]) == 2 + result.n_vertices \
        + result.n_faces
    return launches


# --------------------------------------------------------------------------
# the programs that train to convergence (--campaign, and [campaign-short]
# of the default run): geobignn_tpu_torch/examples/train_synthetic_campaign.py
# and halo_convergence.py, counterparts of the JAX package's examples/
# --------------------------------------------------------------------------

CAMPAIGN_EPOCHS, CAMPAIGN_SHORT_EPOCHS = 500, 10
CAMPAIGN_SHORT_FINAL = 2  # held-out meshes of [campaign-short]'s final_eval
# --campaign's accuracy bounds on the corpus means (degrees; the Hausdorff
# distance in mean edge lengths): about 1.2x the JAX package's round-5 run
# and above both of its recorded runs (docs/campaign_r5, docs/campaign_r2:
# their distance is the JAX package's own run-to-run variance); each
# class's noisy angle over its angle1 at least CAMPAIGN_CLASS_GAIN
CAMPAIGN_BOUNDS = {"angle1": 2.2, "angle2": 2.1, "hausdorff": 1.9}
CAMPAIGN_CLASS_GAIN = 8.0
CAMPAIGN_CLASSES = ("smooth", "torus", "sharp", "mixed")
CAMPAIGN_CURVE = (0, 10, 50, 100, 200, 300, 400, 499)  # epochs printed beside r5's
# halo_convergence.py: 60 epochs from each seed of JAX_INIT_SEEDS; |single
# - halo| / single of the last 10 epochs' mean eval error_f, and each mean
# within HALO_CONV_OF_JAX times the JAX run's (docs/halo_conv/summary.json,
# seed 7)
HALO_CONV_EPOCHS, HALO_CONV_SEED, HALO_CONV_REL_GAP, HALO_CONV_OF_JAX = 60, 7, 0.05, 1.25
CAMPAIGN_KEEP = os.path.join("log", "campaign")  # --campaign's artefacts (not committed)
HALO_CONV_KEEP = os.path.join("log", "halo_conv_seeds")  # --halo-conv's


def _modes(sample):
    """Each level's conv path in a padded sample: a band (and its tile, and
    whether a boundary sub-band runs beside it), block-sparse (K column
    blocks a row block) or the dense-table conv."""
    out = []
    for side in ("v", "f"):
        for i, lvl in enumerate(getattr(sample, side).levels):
            if lvl.blk_idx is not None:
                mode = f"block-sparse tile {lvl.band.shape[1]} K {lvl.blk_idx.shape[1]}"
            elif lvl.band is not None:
                mode = f"band tile {lvl.band.shape[1]}" + (
                    " + sub-band" if lvl.jband is not None else "")
            else:
                mode = "table"
            out.append(f"{side}{i} {mode}")
    return ", ".join(out)


def campaign_build_phase(short, tag, log):
    """[campaign-build]: the campaign's corpus (the whole one, or its short
    selection) and its host build, each timed; each level's mode in the
    merged plan, for the train and for the eval samples (each set pads to
    its own table widths)."""
    from geobignn_tpu_torch.examples import train_synthetic_campaign as tsc

    t0 = time.perf_counter()
    sets = tsc.corpus(short=short)
    gen_s = time.perf_counter() - t0
    (train_pairs, _), (eval_pairs, _) = sets
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        dss = tsc.datasets(tsc.campaign_config(), train_pairs, eval_pairs)
    build_s = time.perf_counter() - t0
    plan = dss[0].plan.merge(dss[1].plan)
    faces = [m.n_faces for m, _ in train_pairs + eval_pairs]
    modes = [_modes(ds.get(0, plan)) for ds in dss]
    print(f"[{tag}-build] {len(train_pairs)} train and {len(eval_pairs)} eval samples of "
          f"{min(faces)}-{max(faces)} faces: the meshes {gen_s:.2f} s, the host build "
          f"{build_s:.2f} s; merged plan: {plan.v.n1} vertex and {plan.f.n1} facet rows; "
          f"levels of the train samples: {modes[0]}; of the eval samples: {modes[1]}")
    assert (len(train_pairs), len(eval_pairs)) == ((24, 6) if short else (66, 24))
    return sets, dss


def campaign_phase(torch, np, dss, epochs, tag, log, kind, every):
    """[campaign] / [campaign-short]: train_synthetic_campaign.train on the
    card for `epochs` epochs from a fresh run directory in a temporary one
    (no resume): the first epoch's aggregate calls recorded (the first
    step's and the eval pass's warm-ups and captures); epoch 0's eval pass,
    its replay and its eager run bit-equal; every `every`-th epoch's eval
    error_f and error_v, train loss, samples/s, edges/s; one step graph
    and one eval graph, their replays and shared pool; the checkpoints'
    seconds; the eval pass graphed against eager; then one more epoch and
    eval pass counted by kernel name (replays only)."""
    from geobignn_tpu_torch.examples import train_synthetic_campaign as tsc
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import checkpoint

    train_ds, eval_ds = dss
    n_train, n_eval = len(train_ds), len(eval_ds)
    tmp = tempfile.mkdtemp(prefix="gbn_campaign_")
    cfg = tsc.campaign_config(epochs, log_dir=os.path.join(tmp, "log"))
    out = sys.stdout
    fwd, bwd = {}, {}
    recording = contextlib.ExitStack()
    recording.enter_context(_recording(fwd))
    recording.enter_context(_recording(bwd, backward=True))
    saves = {"n": 0, "s": 0.0}
    save = checkpoint.save_checkpoint

    def timed_save(*args, **kw):
        t = time.perf_counter()
        try:
            return save(*args, **kw)
        finally:
            saves["n"] += 1
            saves["s"] += time.perf_counter() - t

    curve, last = {}, [time.perf_counter()]

    def on_epoch(tr, train_m, eval_m):
        wall = time.perf_counter() - last[0]
        if tr.epoch == 0:
            recording.close()
            again = tr.evaluate()  # every sample a replay of the eval graph
            with eager_steps():
                eager = tr.evaluate()
            same = again == eval_m == eager
            print(f"[{tag}] epoch 0's eval pass graphed (its first sample warms up and "
                  f"captures) error_f {eval_m['error_f']!r}, every sample replayed "
                  f"{again['error_f']!r}, eager {eager['error_f']!r}: loss_v, loss_f, "
                  f"error_v and error_f bit-equal {same}", file=out, flush=True)
            assert same, (eval_m, again, eager)
        curve[tr.epoch] = dict(eval_m, loss=train_m["loss"], wall_s=wall,
                               samples_per_s=train_m["samples_per_s"],
                               edges_per_s=train_m["edges_per_s"])
        if tr.epoch % every == 0 or tr.epoch == epochs - 1:
            print(f"[{tag}] epoch {tr.epoch}: eval error_f {eval_m['error_f']:.4f} deg, "
                  f"error_v {eval_m['error_v']:.5f}; train loss {train_m['loss']:.5f}; "
                  f"{train_m['samples_per_s']:.1f} samples/s, "
                  f"{train_m['edges_per_s']:.4e} edges/s; the epoch {wall:.3f} s wall",
                  file=out, flush=True)
        last[0] = time.perf_counter()

    checkpoint.save_checkpoint = timed_save
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            tr, run_dir, best = tsc.train(cfg, train_ds, eval_ds, device="cuda",
                                          on_epoch=on_epoch)
    finally:
        checkpoint.save_checkpoint = save
        recording.close()
    fit_s = time.perf_counter() - t0
    (step_graph,) = tr._program.graphs.values()
    (eval_graph,) = tr._eval_program.graphs.values()
    step_in, pool = _graph_bytes(torch, step_graph)
    eval_in, eval_pool = _graph_bytes(torch, eval_graph)
    assert eval_pool == pool and step_graph.replays == epochs * n_train - 1
    assert eval_graph.replays == epochs * n_eval - 1 + n_eval  # and epoch 0's replayed pass
    timed = {}
    for mode in ("graphed", "eager"):
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            times = []
            for _ in range(5):
                t = time.perf_counter()
                tr.evaluate()  # syncs once
                times.append((time.perf_counter() - t) * 1e3)
        timed[mode] = sorted(times)[2]
    train_s = sum(n_train / c["samples_per_s"] for c in curve.values())
    walls = [c["wall_s"] for c in curve.values()]
    print(f"[{tag}] {epochs} epochs of {n_train} steps and an eval pass of {n_eval} samples: "
          f"{fit_s:.1f} s wall, {sum(walls) / len(walls):.3f} s an epoch (median "
          f"{sorted(walls)[len(walls) // 2]:.3f}), the steps {train_s:.1f} s of it, "
          f"{saves['n']} checkpoints written in {saves['s']:.2f} s; best eval error_f "
          f"{best:.4f} deg; one step graph ({step_graph.replays} replays, static inputs "
          f"{step_in / 1e6:.1f} MB) and one eval graph ({eval_graph.replays} replays, "
          f"static inputs {eval_in / 1e6:.1f} MB) in one memory pool of {pool / 1e6:.1f} MB; "
          f"the eval pass graphed {timed['graphed']:.3f} ms, eager {timed['eager']:.3f} ms "
          f"(host clock, median of 5, one sync a pass); launches the captures recorded: "
          f"step {_nonzero(_aggregates(step_graph.launches))}, eval forward "
          f"{_nonzero(_aggregates(eval_graph.launches))}; card {kind}")
    with _counted() as cnt:  # one more epoch and eval pass: replays only
        tr.run_epoch(np.random.default_rng(epochs))
        tr.evaluate()
    want = {k: n_train * step_graph.launches[k] + n_eval * eval_graph.launches[k]
            for k in AGGREGATES}
    print(f"[{tag}] one counted epoch ({n_train} step replays) and eval pass ({n_eval} "
          f"replays): the device ran {_nonzero(cnt['device'])}; the wrappers counted "
          f"{sum(cnt['wrappers'][k] for k in AGGREGATES)}")
    assert sum(cnt["wrappers"][k] for k in AGGREGATES) == 0 and cnt["device"] == want, \
        (cnt["device"], want)
    return dict(tr=tr, cfg=cfg, run_dir=run_dir, best=best, fwd=fwd, bwd=bwd, curve=curve,
                device=cnt["device"], tmp=tmp, eval_ms=timed, pool=pool)


def campaign_kernel_checks(torch, camp, tag):
    """The first epoch's recorded aggregate calls against their plain
    versions on the card."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = [check_forward(k, camp["fwd"][k], reps=5, tag=f"{tag}-kernel")
            for k in sorted(camp["fwd"])]
    rows += [check_backward(k, camp["bwd"][k], gen, reps=5, tag=f"{tag}-kernel-bwd")
             for k in sorted(camp["bwd"])]
    camp["fwd"].clear()
    camp["bwd"].clear()
    torch.cuda.empty_cache()
    return rows


def campaign_eval_phase(torch, np, camp, sets, tag, log, kind, failures, n_final=None):
    """[campaign-eval]: train_synthetic_campaign.evaluate_best (final_eval
    with the best checkpoint) on the card over the held-out meshes (the
    first n_final of them): each shape's and class's angles and Hausdorff
    distance beside the JAX runs' recorded ones, the accuracy bounds of the
    whole campaign (misses go to `failures`), #7 held against its plain
    version on the points it was last given; then on the last of those
    meshes the best checkpoint's predict_mesh against device="cpu", and its
    first patch with its band structures taken away (every conv the table
    conv) against the banded kernels in float32 compute."""
    from geobignn_tpu_torch import geometry
    from geobignn_tpu_torch.examples import train_synthetic_campaign as tsc
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.testing import aggregates_in, eager_steps
    from geobignn_tpu_torch.train import checkpoint

    (train_pairs, _), (eval_pairs, eval_names) = sets
    eval_pairs, eval_names = eval_pairs[:n_final], eval_names[:n_final]
    cfg, tr = camp["cfg"], camp["tr"]
    seen, nearest = [], tsc.nearest_distance

    def keep(a, b):  # the points #7 is given
        seen.append((a.clone(), b.clone()))
        return nearest(a, b)

    banded_cuda.reset_launches()
    tsc.nearest_distance = keep
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            res = tsc.evaluate_best(cfg, camp["run_dir"], tr.epoch + 1, camp["best"],
                                    len(train_pairs), eval_pairs, eval_names, device="cuda")
    finally:
        tsc.nearest_distance = nearest
    eval_s = time.perf_counter() - t0
    nn = banded_cuda.LAUNCHES["nearest"]
    assert nn == len(seen) == len(eval_pairs), (nn, len(seen))
    for r in res["per_shape"]:
        print(f"[{tag}-eval] {r['name']} [{r['klass']}] {r['faces']} faces: noisy "
              f"{r['angle_noisy']} -> angle1 {r['angle1']} angle2 {r['angle2']} "
              f"Hausdorff {r['hausdorff']}")
    refs = {}
    for run in ("r5", "r2"):
        with open(os.path.join("docs", f"campaign_{run}", "campaign_results.json")) as f:
            refs[run] = json.load(f)
    for klass in CAMPAIGN_CLASSES + ("corpus",):
        mine = res["corpus"] if klass == "corpus" else res["per_class"].get(klass)
        if mine is None:
            continue
        theirs = {run: (r["corpus"] if klass == "corpus" else r["per_class"].get(klass, {}))
                  for run, r in refs.items()}
        print(f"[{tag}-eval] {klass}: angle_noisy {mine['angle_noisy']}, angle1 "
              f"{mine['angle1']}, angle2 {mine['angle2']}, Hausdorff {mine['hausdorff']}; "
              + "; ".join(f"JAX {run} {t.get('angle_noisy')} / {t.get('angle1')} / "
                          f"{t.get('angle2')} / {t.get('hausdorff')}" for run, t in theirs.items()))
    print(f"[{tag}-eval] final_eval of {len(eval_pairs)} held-out meshes with the best "
          f"checkpoint (eval error_f {camp['best']:.4f} deg): {eval_s:.1f} s; #7 launched "
          f"{nn} times; card {kind}")
    if n_final is None:
        c = res["corpus"]
        failures += [f"corpus {k} {c[k]} > {b}" for k, b in CAMPAIGN_BOUNDS.items()
                     if not c[k] <= b]
        failures += [f"{k}: angle1 {v['angle1']} not {CAMPAIGN_CLASS_GAIN}x below its noisy "
                     f"{v['angle_noisy']}" for k, v in res["per_class"].items()
                     if not v["angle_noisy"] >= CAMPAIGN_CLASS_GAIN * v["angle1"]]
        print(f"[{tag}-eval] bounds: corpus {CAMPAIGN_BOUNDS}, each class's angle1 "
              f"{CAMPAIGN_CLASS_GAIN}x below its noisy angle: "
              + ("met" if not failures else "MISSED: " + "; ".join(failures)))
    nn_row = check_nearest(torch, tag, *seen[-1], calls=nn, reps=10, plain_reps=2,
                           brute=True, library=True)
    del seen

    # the trained weights served: the card against the CPU, and against the
    # table convs
    best_state, _, _ = checkpoint.load_checkpoint(os.path.join(camp["run_dir"], "ckpt_best.pkl"))
    mesh, name = eval_pairs[-1][0], eval_names[-1][0]
    pred = predict.Predictor(cfg, best_state, device="cuda")
    vp_g, n_g = pred.predict_mesh(mesh)
    t0 = time.perf_counter()
    vp_c, n_c = predict.Predictor(cfg, best_state, device="cpu").predict_mesh(mesh)
    cpu_s = time.perf_counter() - t0
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    e_pos, e_n = float(np.abs(vp_g - vp_c).max()) / mel, float(np.abs(n_g - n_c).max())
    mem = pred.patch_dataset(mesh)
    patch0 = mem.get(0)
    nv, nf = (int(b.n_nodes) for b in mem.entries[0][:2])
    banded_cuda.reset_launches()
    with eager_steps():  # aggregates_in swaps functions a replayed graph never calls
        v_tb, n_tb = pred._apply(_without_bands(patch0))
        assert sum(banded_cuda.LAUNCHES.values()) == 0
        with aggregates_in(torch.float32):
            v_bd, n_bd = pred._apply(patch0)
    assert sum(banded_cuda.LAUNCHES.values()) > 0
    mel0 = mel * float(mem.entries[0][2]["scale"])  # patch coordinates are normalized
    e_pos_t = float(np.abs(v_tb[:nv] - v_bd[:nv]).max()) / mel0
    e_n_t = float(np.abs(n_tb[:nf] - n_bd[:nf]).max())
    print(f"[{tag}-eval] the best checkpoint served on {name} ({mesh.n_faces} faces, "
          f"{len(mem.entries)} patch(es)): the card against device=\"cpu\" ({cpu_s:.2f} s) "
          f"positions {e_pos:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals {e_n:.3e} "
          f"(tol {NORMAL_TOL}); patch 0's table convs against the banded kernels in float32 "
          f"compute: positions {e_pos_t:.3e} (tol {POS_TOL_MEL}), normals {e_n_t:.3e} "
          f"(tol {NORMAL_TOL}, as [tables])")
    assert np.isfinite(vp_g).all() and np.isfinite(n_g).all()
    assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL
    assert e_pos_t <= POS_TOL_MEL and e_n_t <= NORMAL_TOL
    del pred, patch0, mem
    return dict(res=res, nearest_row=nn_row, nearest=nn)


def campaign_short_phase(torch, np, kind):
    """[campaign-short], after the default run's training phases: the
    campaign's short corpus (24 train, 6 eval samples) for
    CAMPAIGN_SHORT_EPOCHS epochs through the campaign's module, the eval
    graph replayed; eval error_f at the last epoch under half of epoch
    0's; the recorded calls against their plain versions; final_eval on
    CAMPAIGN_SHORT_FINAL held-out meshes.  Returns the counted epoch's
    launches and #7's."""
    tag = "campaign-short"
    with tempfile.TemporaryFile("w+") as log:
        sets, dss = campaign_build_phase(True, tag, log)
        camp = campaign_phase(torch, np, dss, CAMPAIGN_SHORT_EPOCHS, tag, log, kind,
                              every=1)
        first, final = camp["curve"][0]["error_f"], camp["curve"][CAMPAIGN_SHORT_EPOCHS - 1]["error_f"]
        print(f"[{tag}] eval error_f {first:.4f} deg at epoch 0, {final:.4f} at epoch "
              f"{CAMPAIGN_SHORT_EPOCHS - 1}: {final / first:.3f} of it (bound 0.5)")
        assert final < 0.5 * first, (first, final)
        campaign_kernel_checks(torch, camp, tag)
        ev = campaign_eval_phase(torch, np, camp, sets, tag, log, kind, [],
                                 n_final=CAMPAIGN_SHORT_FINAL)
    shutil.rmtree(camp["tmp"], ignore_errors=True)
    counts = {**_counts(**camp["device"]), "nearest": ev["nearest"]}
    del camp, dss
    _free(torch)
    return counts


def _halo_pair(torch, hc, log, seed, out_dir, init=None):
    """halo_convergence.run single-device and with 8 parts on cuda:0 from
    `seed` (and `init`'s weights, if given) into out_dir; compare()'s
    summary and each run's seconds."""
    secs = {}
    for mode in ("single", "halo"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            hc.run(mode, HALO_CONV_EPOCHS, seed, out_dir, "cuda", init)
        secs[mode] = time.perf_counter() - t0
        _free(torch)
    with contextlib.redirect_stdout(log):
        return hc.compare(out_dir), secs


def _halo_curves(tag, out_dir):
    """(a_7)'s curves every 5 epochs beside the JAX run's (docs/halo_conv/)."""
    def curve(path):
        with open(path) as f:
            return {r["epoch"]: r["error_f"] for r in map(json.loads, f)}

    ref_dir = os.path.join("docs", "halo_conv")
    mine = {m: curve(os.path.join(out_dir, f"{m}_curve.jsonl")) for m in ("single", "halo")}
    theirs = {m: curve(os.path.join(ref_dir, f"{m}_curve.jsonl")) for m in ("single", "halo")}
    for e in sorted({*range(0, HALO_CONV_EPOCHS, 5), HALO_CONV_EPOCHS - 1}):
        print(f"[{tag}] a_{HALO_CONV_SEED} epoch {e}: eval error_f single "
              f"{mine['single'][e]:.3f}, halo(8) {mine['halo'][e]:.3f} (JAX "
              f"{theirs['single'][e]:.3f} / {theirs['halo'][e]:.3f})")


def halo_conv_phase(torch, np, log, kind, failures, fwd, bwd):
    """[halo-conv]: halo_convergence.run single-device and with 8 parts,
    every part on cuda:0 (each halo step and eval forward one CUDA graph),
    HALO_CONV_EPOCHS epochs each, in pairs: (a_s) from the port's initial
    weights and (b_s) from the JAX trainers' (halo_convergence.jax_init(s))
    for s in halo_convergence.JAX_INIT_SEEDS, one line a pair (final means, their share of
    the JAX run's, rel_gap, seconds), then each side's min, median and
    max.  (a_7)'s curves beside the JAX run's, and its single-device run
    once more with its aggregates in float32 against its halo curve.  Held:
    HALO_CONV_OF_JAX on (a_7) and (b_7), HALO_CONV_REL_GAP on (b_7),
    halo_convergence.gate on the a_s against the b_s; misses go to
    `failures`.  The aggregate calls of (a_7) are recorded into `fwd` and
    `bwd` (_recording).  Each pair's curves and summary go to
    HALO_CONV_KEEP."""
    from geobignn_tpu_torch.examples import halo_convergence as hc
    from geobignn_tpu_torch.testing import aggregates_in

    tag = "halo-conv"
    with open(os.path.join("docs", "halo_conv", "summary.json")) as f:
        ref = json.load(f)
    gaps: dict = {"a": {}, "b": {}}
    missed = []
    for seed in hc.JAX_INIT_SEEDS:
        for side in ("a", "b"):
            what = f"{side}_{seed}"
            out_dir = tempfile.mkdtemp(prefix=f"gbn_halo_conv_{what}_")
            init = hc.jax_init(seed) if side == "b" else None
            with contextlib.ExitStack() as rec:
                if what == f"a_{HALO_CONV_SEED}":
                    rec.enter_context(_recording(fwd))
                    rec.enter_context(_recording(bwd, backward=True))
                summary, secs = _halo_pair(torch, hc, log, seed, out_dir, init)
            gaps[side][seed] = summary["rel_gap"]
            means = {m: summary[f"{m}_final_mean"] for m in ("single", "halo")}
            print(f"[{tag}] seed {seed}, ({what}) from "
                  + ("the port's initial weights" if side == "a" else
                     f"the JAX trainers' ({os.path.relpath(init)})")
                  + f": single {means['single']}, halo {means['halo']} (of the JAX run's "
                  f"{means['single'] / ref['single_final_mean']:.4f} / "
                  f"{means['halo'] / ref['halo_final_mean']:.4f}), rel_gap "
                  f"{summary['rel_gap']}; single {secs['single']:.1f} s, halo "
                  f"{secs['halo']:.1f} s (8 parts on cuda:0)", flush=True)
            if seed == HALO_CONV_SEED:
                missed += [f"({what}) {m}_final_mean {v} > {HALO_CONV_OF_JAX}x the JAX "
                           f"run's {ref[f'{m}_final_mean']}" for m, v in means.items()
                           if not v <= HALO_CONV_OF_JAX * ref[f"{m}_final_mean"]]
            if what == f"b_{HALO_CONV_SEED}" and not summary["rel_gap"] <= HALO_CONV_REL_GAP:
                missed.append(f"({what}) rel_gap {summary['rel_gap']} > {HALO_CONV_REL_GAP}")
            if what == f"a_{HALO_CONV_SEED}":
                _halo_curves(tag, out_dir)
                # whether the single-device run's bf16 aggregate operands move
                # the gap (the halo run's table convs compute in float32)
                f32_dir = tempfile.mkdtemp(prefix="gbn_halo_conv_f32_")
                shutil.copy2(os.path.join(out_dir, "halo_curve.jsonl"), f32_dir)
                with aggregates_in(torch.float32), contextlib.redirect_stdout(log):
                    hc.run("single", HALO_CONV_EPOCHS, seed, f32_dir, "cuda")
                    f32 = hc.compare(f32_dir)
                shutil.rmtree(f32_dir, ignore_errors=True)
                _free(torch)
                print(f"[{tag}] (a_{seed})'s single-device run again with its aggregates in "
                      f"float32 (testing.aggregates_in): {json.dumps(f32)}")
            _keep(out_dir, ("single_curve.jsonl", "halo_curve.jsonl", "summary.json"),
                  os.path.join(HALO_CONV_KEEP, what))
            shutil.rmtree(out_dir, ignore_errors=True)
    for side, label in (("a", "the port's initial weights"), ("b", "the JAX trainers'")):
        vals = list(gaps[side].values())
        print(f"[{tag}] rel_gap from {label} over seeds {min(gaps[side])}-"
              f"{max(gaps[side])}: {json.dumps(gaps[side])}; min {min(vals)}, median "
              f"{float(np.median(vals))}, max {max(vals)}")
    met, rule = hc.gate(gaps["a"], gaps["b"], HALO_CONV_REL_GAP)
    print(f"[{tag}] the port's own weights (halo_convergence.gate): {rule}: "
          + ("met" if met else "MISSED"))
    if not met:
        missed.append(f"gate: {rule}")
    print(f"[{tag}] bounds: final means <= {HALO_CONV_OF_JAX}x the JAX run's on "
          f"(a_{HALO_CONV_SEED}) and (b_{HALO_CONV_SEED}), rel_gap <= {HALO_CONV_REL_GAP} on "
          f"(b_{HALO_CONV_SEED}), the gate on the a_s; card {kind}: "
          + ("met" if not missed else "MISSED: " + "; ".join(missed)))
    failures += missed
    return gaps


def _keep(src_dir, names, dst_dir):
    """Copy the named files of src_dir that exist into dst_dir."""
    os.makedirs(dst_dir, exist_ok=True)
    for name in names:
        if os.path.exists(os.path.join(src_dir, name)):
            shutil.copy2(os.path.join(src_dir, name), os.path.join(dst_dir, name))


def campaign_main(torch, np, kind, t_start):
    """python3 chip_smoke.py --campaign: the whole campaign (66 + 24
    samples, 500 epochs) and its final evaluation; the modules' own output
    and the run's files go to CAMPAIGN_KEEP."""
    failures: list = []
    os.makedirs(CAMPAIGN_KEEP, exist_ok=True)
    with open(os.path.join(CAMPAIGN_KEEP, "campaign_log.txt"), "w") as log:
        sets, dss = campaign_build_phase(False, "campaign", log)
        _lap(t_start, "[campaign-build]")
        camp = campaign_phase(torch, np, dss, CAMPAIGN_EPOCHS, "campaign", log, kind,
                              every=50)
        _keep(camp["run_dir"], ("metrics.jsonl", "params.json"), CAMPAIGN_KEEP)
        with open(os.path.join("docs", "campaign_r5", "metrics.jsonl")) as f:
            r5 = {r["epoch"]: r["error_f"] for r in map(json.loads, f) if r["split"] == "test"}
        print("[campaign] eval error_f by epoch, this run against JAX r5: " + ", ".join(
            f"{e}: {camp['curve'][e]['error_f']:.3f} / {r5[e]:.3f}" for e in CAMPAIGN_CURVE))
        _lap(t_start, "[campaign]")
        rows = campaign_kernel_checks(torch, camp, "campaign")
        ev = campaign_eval_phase(torch, np, camp, sets, "campaign", log, kind, failures)
        _keep(camp["run_dir"], ("campaign_results.json",), CAMPAIGN_KEEP)
        shutil.rmtree(camp["tmp"], ignore_errors=True)
        device = camp["device"]
        del camp, dss
        _free(torch)
        _lap(t_start, "[campaign-eval]")
    kernels = [_kernel_entry(name, [r for r in rows if r["kernel"] == name], device[name])
               for name in AGGREGATES if device[name]]
    kernels.append({
        "name": "nearest_distance", "route": "cuda",
        "source": "geobignn_tpu_torch/csrc/nearest.cu",
        "replaces": "geobignn_tpu/ops/pallas_nn.py:42", "launches": ev["nearest"],
        **{k: ev["nearest_row"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    if failures:
        raise AssertionError("accuracy bounds missed: " + "; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def halo_conv_main(torch, np, kind, t_start):
    """python3 chip_smoke.py --halo-conv: halo_conv_phase's ten pairs, the
    wrappers' launch counts zeroed just before them and read just after;
    then every #1-#4 call of (a_7)'s single-device run (its first steps'
    and eval passes' warm-ups and captures) against its plain version, and
    a kernels line of those.  The modules' own output goes to
    HALO_CONV_KEEP/halo_conv_log.txt."""
    from geobignn_tpu_torch.ops import banded_cuda

    failures: list = []
    fwd, bwd = {}, {}
    os.makedirs(HALO_CONV_KEEP, exist_ok=True)
    with open(os.path.join(HALO_CONV_KEEP, "halo_conv_log.txt"), "w") as log:
        banded_cuda.reset_launches()
        halo_conv_phase(torch, np, log, kind, failures, fwd, bwd)
        launches = dict(banded_cuda.LAUNCHES)
    _lap(t_start, "[halo-conv]")
    print(f"[halo-conv] the wrappers counted {_nonzero(launches)} over the ten pairs and "
          f"the float32 rerun (eager calls and captures; a graph's replays are not counted)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = [check_forward(k, fwd.pop(k), reps=5, tag="halo-conv-kernel") for k in sorted(fwd)]
    rows += [check_backward(k, bwd.pop(k), gen, reps=5, tag="halo-conv-kernel-bwd")
             for k in sorted(bwd)]
    path = [k for k in AGGREGATES if launches[k]]
    assert {"aggregate_first", "transform_first", "aggregate_first_bwd",
            "transform_first_bwd"} <= set(path), launches
    assert all(any(r["kernel"] == k for r in rows) for k in path), (path, len(rows))
    kernels = [_kernel_entry(k, [r for r in rows if r["kernel"] == k], launches[k])
               for k in path]
    _lap(t_start, "the kernel checks")
    print(json.dumps({"kernels": kernels}))
    if failures:
        raise AssertionError("accuracy bounds missed: " + "; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# --probes: the measuring scripts of geobignn_tpu_torch/examples/ (the JAX
# repo's examples/ probes' twins) at the JAX scripts' default shapes, as
# (module, arguments); kernel_probe in both schedules, banded and
# block-sparse; trace_step also traces run_1m.py's 8-part halo step, first,
# on a card nothing else holds (its eager warm-up peaks near 20 GiB beside
# a graph pool of 21)
PROBE_RUNS = (
    ("trace_step", ["--subdiv", "8", "--halo-parts", "8",
                    "--trace-dir", os.path.join("log", "trace_step_halo8")]),
    ("kernel_probe", []),
    ("kernel_probe", ["--c-in", "32", "--c-out", "64"]),
    ("kernel_probe", ["--blocksparse", "9"]),
    ("kernel_probe", ["--blocksparse", "9", "--c-in", "32", "--c-out", "64"]),
    ("trace_step", []),
    ("profile_step", []),
    ("profile_large", []),
    ("probe_serial", []),
    ("probe_f1_327k", []),
    ("bench_dynamic", []),
    ("probe_dynamic", []),
    ("halo_scaling_report", []),
)


def run_probes(torch, runs, tag):
    """Each (module, arguments) of `runs` on cuda:0, then every aggregate
    call it made (the first at each shape, recorded) against its plain
    version on the card (check_forward / check_backward, the script's
    tolerances; `[tag-kernel]` lines), its recorded inputs freed before the
    next run.  Returns the rows and each run's seconds."""
    import importlib

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, secs = [], []
    for name, argv in runs:
        mod = importlib.import_module(f"geobignn_tpu_torch.examples.{name}")
        fwd, bwd = {}, {}
        t0 = time.perf_counter()
        with _recording(fwd), _recording(bwd, backward=True):
            mod.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        print(f"[probes] {name} {' '.join(argv)}: {secs[-1]:.1f} s")
        _free(torch)
        for key in sorted(fwd):
            rows.append(check_forward(key, fwd.pop(key), reps=5, tag=f"{tag}-kernel"))
            torch.cuda.empty_cache()
        for key in sorted(bwd):
            rows.append(check_backward(key, bwd.pop(key), gen, reps=5,
                                       tag=f"{tag}-kernel-bwd"))
            torch.cuda.empty_cache()
    return rows, secs


def probes_main(torch, kind, t_start):
    """python3 chip_smoke.py --probes: PROBE_RUNS, every aggregate call they
    made held against its plain version, and a kernels line of those."""
    from geobignn_tpu_torch.ops import banded_cuda

    banded_cuda.reset_launches()
    rows, secs = run_probes(torch, PROBE_RUNS, "probes")
    launches = dict(banded_cuda.LAUNCHES)
    _lap(t_start, f"the probes ({sum(secs):.1f} s) and their kernel checks")
    kernels = [_kernel_entry(name, [r for r in rows if r["kernel"] == name], launches[name])
               for name in AGGREGATES if launches[name]]
    print(f"[probes] the wrappers counted {_nonzero(launches)} (eager calls and captures; "
          f"a graph's replays are not counted)")
    assert kernels and all(any(r["kernel"] == k for r in rows) for k in AGGREGATES
                           if launches[k])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def main(argv) -> int:
    import torch

    if argv not in ([], ["--large"], ["--large-halo"], ["--campaign"], ["--halo-conv"],
                    ["--probes"]):
        print("usage: python3 chip_smoke.py "
              "[--large | --large-halo | --campaign | --halo-conv | --probes]", file=sys.stderr)
        return 2
    # 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    import numpy as np

    from geobignn_tpu_torch import geometry, native
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer import predict
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.ops import banded_cuda
    from geobignn_tpu_torch.testing import aggregates_in, eager_steps, heads_peak_bytes

    # --large-halo's host builds run in worker processes from here on
    hosts = _large_halo_hosts_started() if argv == ["--large-halo"] else None
    # 2. build --------------------------------------------------------------
    secs = banded_cuda.build(force=True)
    print(f"[build] nvcc {sorted(banded_cuda.SOURCES.values())} -> sm_90a "
          f"(in parallel) in {secs:.2f} s")
    for ln in _resources(banded_cuda.BUILD_LOG):
        print(f"[build] {ln}")
    t0 = time.perf_counter()
    has_native = native.has_native()
    print(f"[build] native mesh library: {has_native} ({time.perf_counter() - t0:.2f} s)")

    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=0).state_dict()
    if argv == ["--large"]:
        return large_main(torch, np, kind, t_start, state)
    if argv == ["--large-halo"]:
        return large_halo_main(torch, np, kind, t_start, state, hosts)
    if argv == ["--campaign"]:
        return campaign_main(torch, np, kind, t_start)
    if argv == ["--halo-conv"]:
        return halo_conv_main(torch, np, kind, t_start)
    if argv == ["--probes"]:
        return probes_main(torch, kind, t_start)
    # 3. the serving path, every level banded ---------------------------------
    cfg = Config()
    pred = predict.Predictor(cfg, state, device="cuda")
    pred_cpu = predict.Predictor(cfg, state, device="cpu")
    mesh, captured, launches, _ = serve_phase(pred, 0, "main")

    # host build, forward of one patch and the update loop, timed apart
    t0 = time.perf_counter()
    mem = pred.patch_dataset(mesh)
    assert len(mem.entries) == 2, len(mem.entries)
    samples = [mem.get(i) for i in range(len(mem.entries))]
    host_s = time.perf_counter() - t0
    sample = samples[0].to("cuda")
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: pred.model(sample), reps=5)
    vp0, np0 = pred.predict_mesh(mesh)
    upd = [torch.from_numpy(a).to("cuda") for a in (
        vp0, mesh.fv_indices.astype(np.int64), mesh.vf_indices.astype(np.int64), np0)]
    upd_ms = _cuda_ms(lambda: predict.update_positions(*upd, n_iter=60), reps=3)
    print(f"[main] host build of both patches (split, graphs, hierarchies, "
          f"tables, bands): {host_s:.3f} s; DualGNN forward of one patch: "
          f"{fwd_ms:.3f} ms; 60 update iterations: {upd_ms:.3f} ms")
    del samples, sample
    serve_graph_phase(torch, pred, mesh, kind)

    # 4. GPU vs CPU ------------------------------------------------------------
    vp_g, n_g = vp0, np0
    t0 = time.perf_counter()
    vp_c, n_c = pred_cpu.predict_mesh(mesh)
    cpu_s = time.perf_counter() - t0
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    e_pos = float(np.abs(vp_g - vp_c).max()) / mel
    e_n = float(np.abs(n_g - n_c).max())
    print(f"[cpu] plain-version predict_mesh {cpu_s:.2f} s; GPU vs CPU: positions "
          f"{e_pos:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals {e_n:.3e} "
          f"(tol {NORMAL_TOL})")
    assert np.isfinite(vp_g).all() and np.isfinite(n_g).all()
    assert e_pos <= POS_TOL_MEL and e_n <= NORMAL_TOL

    # the table path.  As a user reaches it: Config(reorder=False), no RCM
    # order, no band, every conv a dense-table conv in float32 torch, no
    # kernel launched.  Its distance to the default run is printed, not
    # bounded: the default rounds the aggregates' operands to bf16.
    pred_tbl = predict.Predictor(Config(reorder=False), state, device="cuda")
    pred_tbl.predict_mesh(mesh)  # warm-up
    banded_cuda.reset_launches()
    t0 = time.perf_counter()
    vp_t, n_t = pred_tbl.predict_mesh(mesh)
    torch.cuda.synchronize()
    tbl_s = time.perf_counter() - t0
    print(f"[tables] predict_mesh under Config(reorder=False) {tbl_s:.3f} s wall, "
          f"launches {sum(banded_cuda.LAUNCHES.values())}; vs the default run "
          f"(bf16 aggregate operands): positions "
          f"{float(np.abs(vp_t - vp_g).max()) / mel:.3e} mean edge lengths, normals "
          f"{float(np.abs(n_t - n_g).max()):.3e}")
    assert sum(banded_cuda.LAUNCHES.values()) == 0
    assert np.isfinite(vp_t).all() and np.isfinite(n_t).all()
    del pred_tbl
    # Held to the model tolerances: patch 0 in the default order with its
    # band structures taken away, so that every level takes the table conv,
    # against the same patch through the banded kernels in float32 compute
    # (what the JAX package's banded-vs-table model test compares).
    patch0 = mem.get(0)
    stripped = _without_bands(patch0)
    nv, nf = (int(b.n_nodes) for b in mem.entries[0][:2])
    banded_cuda.reset_launches()
    with eager_steps():  # aggregates_in swaps functions a replayed graph never calls
        v_tb, n_tb = pred._apply(stripped)
        assert sum(banded_cuda.LAUNCHES.values()) == 0
        with aggregates_in(torch.float32):
            v_bd, n_bd = pred._apply(patch0)
    assert sum(banded_cuda.LAUNCHES.values()) == sum(SERVE_LAUNCHES[0].values()) // 2
    mel0 = mel * float(mem.entries[0][2]["scale"])  # patch coordinates are normalized
    e_pos_t = float(np.abs(v_tb[:nv] - v_bd[:nv]).max()) / mel0
    e_n_t = float(np.abs(n_tb[:nf] - n_bd[:nf]).max())
    print(f"[tables] patch 0, table convs vs banded kernels in float32 compute: "
          f"positions {e_pos_t:.3e} mean edge lengths (tol {POS_TOL_MEL}), normals "
          f"{e_n_t:.3e} (tol {NORMAL_TOL})")
    assert e_pos_t <= POS_TOL_MEL and e_n_t <= NORMAL_TOL
    del patch0, stripped

    # 5. the serving path through the block-sparse level -------------------------
    mesh1, captured1, launches1, _ = serve_phase(pred, 1, "main-bs")
    t0 = time.perf_counter()
    mem1 = pred.patch_dataset(mesh1)
    patch0 = mem1.get(0)
    host1_s = time.perf_counter() - t0
    f1 = patch0.f.levels[0]
    assert f1.blk_idx is not None and f1.band.shape[:2] == (79, 256), f1.band.shape
    sample1 = patch0.to("cuda")
    with torch.no_grad():
        fwd1_ms = _cuda_ms(lambda: pred.model(sample1), reps=5)
    print(f"[main-bs] finest facet level: mask {tuple(f1.band.shape)} "
          f"({int(f1.band.sum())} set slots), blk_idx {tuple(f1.blk_idx.shape)}; "
          f"host build of the patches' entries and of patch 0: {host1_s:.3f} s; "
          f"DualGNN forward of one patch: {fwd1_ms:.3f} ms")
    nv, nf = (int(b.n_nodes) for b in mem1.entries[0][:2])
    v_g, nrm_g = (a[:k] for a, k in zip(pred._apply(patch0), (nv, nf)))
    t0 = time.perf_counter()
    v_c, nrm_c = (a[:k] for a, k in zip(pred_cpu._apply(patch0), (nv, nf)))
    cpu1_s = time.perf_counter() - t0
    # patch coordinates are normalized: (point - centroid) * scale
    mel1 = (geometry.mean_edge_length_np(mesh1.points, mesh1.ev_indices)
            * float(mem1.entries[0][2]["scale"]))
    e_pos1 = float(np.abs(v_g - v_c).max()) / mel1
    e_n1 = float(np.abs(nrm_g - nrm_c).max())
    print(f"[cpu-bs] plain-version forward of patch 0 (of 2) {cpu1_s:.2f} s; GPU vs "
          f"CPU on that patch: positions {e_pos1:.3e} mean edge lengths (tol "
          f"{POS_TOL_MEL}), normals {e_n1:.3e} (tol {NORMAL_TOL})")
    assert np.isfinite(v_g).all() and np.isfinite(nrm_g).all()
    assert e_pos1 <= POS_TOL_MEL and e_n1 <= NORMAL_TOL
    del sample1, patch0, mem1

    _lap(t_start, "phases 3-5")
    # 6. forward kernels against their plain versions --------------------------
    rows = [check_forward(key, captured[key]) for key in sorted(captured)]
    # 128 -> 128 at T=256 as well (the path runs that width only at T=128)
    r_, p_, x_, w_, m_ = next(e["args"] for k, e in sorted(captured.items())
                              if k[0] == "aggregate_first" and k[2] == 256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x128 = torch.randn((x_.shape[0], 128), device="cuda", generator=gen)
    w128 = torch.randn((9, 128, 128), device="cuda", generator=gen) * 0.05
    check_forward(("aggregate_first",), {"args": [r_, p_, x128, w128, m_],
                                         "cd": torch.bfloat16, "calls": 0})
    rows += [check_forward(key, captured1[key], reps=10) for key in sorted(captured1)
             if key[0].startswith("bs_")]
    for name in FWD:
        assert sum(r["calls"] for r in rows if r["kernel"] == name) == launches[name]
        assert sum(r["calls"] for r in rows if r["kernel"] == "bs_" + name) \
            == launches1["bs_" + name]
    del captured, captured1
    check_edge_cases()
    torch.cuda.empty_cache()

    _lap(t_start, "phase 6")
    # 7. training ---------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    bwd_rows, fit_launches, more = [], {}, []
    for seeds, prefix in (((0, 6), ""), ((1, 2), "bs_")):
        train = train_phase(torch, np, seeds, overfit=not prefix, kind=kind)
        if not prefix:
            patches = train["train_ds"]  # phase 17's
            patch_step_ms = train["graph"]["graphed"]["median_ms"]  # phase 22's
        # 11-12, 14: the modes of this training set's patches
        more.append(bf16_phase(torch, np, train["train_ds"], seeds, train["graph"], kind))
        if not prefix:
            more.append(fusion_phase(torch, np, train["train_ds"], kind))
            more.append(dynamic_phase(torch, np, train["train_ds"],
                                      train["graph"]["graphed"], kind))
        # 18: the legacy models on this training set's patch 0
        legacy_launches, legacy_rec = legacy_phase(torch, np, train["train_ds"], seeds, kind)
        more.append(legacy_launches)
        for fwd_rec, bwd_rec in legacy_rec:
            rows += [check_forward(key, fwd_rec[key], reps=5) for key in sorted(fwd_rec)]
            bwd_rows += [check_backward(key, ent, gen) for key, ent in sorted(bwd_rec.items())]
        del legacy_rec
        mine = [check_backward(key, ent, gen)
                for key, ent in sorted(train["captured"].items())
                if key[0].startswith("bs_") == bool(prefix)]
        per_step = {prefix + k + "_bwd": sum(
            r["calls"] * r["ms"] for r in mine if r["kernel"] == prefix + k + "_bwd")
            for k in FWD}
        print(f"[train{seeds}] backward kernels per step: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in per_step.items())
              + f" of a {train['step_ms']:.3f} ms step; card {kind}")
        for name in per_step:
            assert sum(r["calls"] for r in mine if r["kernel"] == name) \
                == TRAIN_SETS[seeds][name]
            fit_launches[name] = train["launches"][name]
        bwd_rows += mine
        del train
        torch.cuda.empty_cache()

    _lap(t_start, "phases 7, 11, 12, 14")
    # the fc heads' memory: the bf16 facet head alone at N = 2^20 rows, forward
    # and backward, in row chunks and rematerialized against one piece
    model = DualGNN(fc_dtype=torch.bfloat16, device="cuda")
    feat = torch.randn((1 << 20, 32), device="cuda", generator=gen)
    peaks = [heads_peak_bytes(model, feat, chunked) / 2**30 for chunked in (True, False)]
    print(f"[heads] facet head at N = 2^20 rows, bf16, forward and backward: peak "
          f"{peaks[0]:.3f} GiB in row chunks, rematerialized; {peaks[1]:.3f} GiB in one "
          f"piece, every intermediate kept (torch.cuda.max_memory_allocated)")
    assert peaks[1] - peaks[0] >= 4.0
    del model, feat
    torch.cuda.empty_cache()

    _lap(t_start, "the heads")
    # 21. [campaign-short]: train_synthetic_campaign on its short corpus, the
    # eval pass as its CUDA graph
    short = campaign_short_phase(torch, np, kind)
    more.append(short)
    _lap(t_start, "[campaign-short]")
    # 15-17. the multi-device paths, every part on cuda:0 ------------------------
    # [large]'s host build runs meanwhile in a worker process: the graphed
    # times of phases 15-17 are the device's; phase 13's streamed epoch,
    # bound by the host, comes after it
    large_pool, large_host = _large_host_started(7)
    halo_fwd, halo_launches = halo_serve_phase(torch, np, state, kind)
    _lap(t_start, "phase 15")
    rows += [check_forward(key, halo_fwd[key], reps=10) for key in sorted(halo_fwd)]
    halo_bwd, halo_fit = halo_train_phase(torch, np, kind)
    _lap(t_start, "phase 16")
    bwd_rows += [check_backward(key, ent, gen) for key, ent in sorted(halo_bwd.items())]
    more += [halo_launches, halo_fit]
    del halo_fwd, halo_bwd
    torch.cuda.empty_cache()
    sharded_phase(torch, np, patches, kind)
    del patches
    torch.cuda.empty_cache()

    _lap(t_start, "phases 15-17")
    # 13. streamed size buckets ---------------------------------------------------
    more.append(bucket_phase(torch, np, kind))
    torch.cuda.empty_cache()

    _lap(t_start, "phase 13")
    # 7b. the bench's shape: one graphed step on a union batch of 8 meshes ---------
    union_phase(torch, np, kind)

    _lap(t_start, "phase 7b")
    # 7c. [large]: one whole 327,680-face mesh, one graphed training step ---------
    t0 = time.perf_counter()
    host = large_host.result()
    large_pool.shutdown()
    print(f"[large] its host build ran in a worker process from phase 15 on; waited "
          f"for it {time.perf_counter() - t0:.1f} s")
    more.append(large_phase(torch, np, host, kind))
    del host
    print(f"[large] the phase took {time.perf_counter() - t0:.1f} s")

    _lap(t_start, "phase 7c")
    # 8. the run-directory path ---------------------------------------------------
    run = rundir_phase(torch, np)
    torch.cuda.empty_cache()

    _lap(t_start, "phase 8")
    # 9. the nearest-distance kernel against its plain version -------------------
    gen = torch.Generator(device="cuda").manual_seed(7)

    def cloud(n, k):
        return torch.randn((n, k), device="cuda", generator=gen)

    nn_rows = [check_nearest(torch, "path", *(torch.from_numpy(x).to("cuda")
                                              for x in run["points"]),
                             calls=run["launches"], reps=20, plain_reps=3,
                             brute=True, library=True)]
    for label, n, k, reps, plain_reps, brute, library in (
            ("40k", 40_000, 3, 10, 2, True, True),
            ("500k", 500_000, 3, 2, 1, False, False),
            ("wide", 8_192, 64, 10, 3, True, True)):
        nn_rows.append(check_nearest(torch, label, cloud(n, k), cloud(n, k), 0, reps,
                                     plain_reps, brute, library))
        torch.cuda.empty_cache()
    assert nn_rows[0]["n"] == nn_rows[0]["m"] == 10242 and run["launches"] == 1

    _lap(t_start, "phase 9")
    # 19-20. icp_align; the Hausdorff heatmap of the served result through #7 --------
    icp_phase(torch, np, kind)
    viz_launches = viz_phase(torch, np, mesh, vp_g, kind)
    _lap(t_start, "phases 19-20")
    # 22. two of the probes: kernel_probe at its default shape, its calls
    # against their plain versions; halo_scaling_report's host half at
    # subdiv 5 beside phase 7's graphed 20,000-face step
    run_probes(torch, [("kernel_probe", [])], "probe")
    from geobignn_tpu_torch.examples import halo_scaling_report

    halo_scaling_report.main(["--cells", "5:4,8,16", "--step-ms", f"{patch_step_ms:.3f}"])
    _lap(t_start, "phase 22")
    recs = PROFILE_WINDOWS
    print(f"[profile] {len(recs)} counted runs: launch calls without a kernel record "
          f"{sum(r['unrecorded'] for r in recs)}, of them in the primers "
          f"{sum(r['unrecorded_in_primer'] for r in recs)}; the least time from a launch "
          f"call to its kernel's start "
          f"{min(r['min_launch_to_start_us'] for r in recs if r['kernels']):.1f} us; raw "
          f"aggregate records equal to the grouped ones in every run "
          f"{all(r['raw_equals_grouped'] for r in recs)}; per run (in the primer, elsewhere, "
          f"least launch-to-start us) "
          + json.dumps([[r["unrecorded_in_primer"], r["unrecorded"] - r["unrecorded_in_primer"],
                         r["min_launch_to_start_us"]] for r in recs]))

    kernels = []
    for name in AGGREGATES:
        if name.endswith("_bwd"):
            mine, n_l = [r for r in bwd_rows if r["kernel"] == name], fit_launches[name]
        else:
            mine = [r for r in rows if r["kernel"] == name]
            n_l = (launches1 if name.startswith("bs_") else launches)[name]
        n_l += sum(m[name] for m in more)  # the main paths of phases 11-14
        assert mine and n_l > 0, name
        kernels.append(_kernel_entry(name, mine, n_l))
    path_row = nn_rows[0]
    kernels.append({
        "name": "nearest_distance", "route": "cuda",
        "source": "geobignn_tpu_torch/csrc/nearest.cu",
        "replaces": "geobignn_tpu/ops/pallas_nn.py:42",
        "launches": run["launches"] + viz_launches + short["nearest"],
        **{k: path_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}})
    assert len(kernels) == len(KERNELS) == 9
    print(f"[time] {time.perf_counter() - t_start:.1f} s after the card was found")

    # 10. result -----------------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
