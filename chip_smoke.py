#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ with nvcc (sm_90a),
     one nvcc per source, all started together;
  3. kernel phase: each kernel against its plain PyTorch version — the
     forward kernels at every distinct ResNet-50 shape at batch 32 (bf16
     and f32) and at batch 128 (bf16, the train step's calls), the 1x1
     backward kernels (dgrad, wgrad) at every 1x1 stride-1 backward
     shape at batch 128 in bf16 and f32 — every prologue variant the path
     uses; the backward kernels run twice on the same inputs and must give
     the same bits; each call's route (pc.FORWARD_ROUTES,
     pc.BACKWARD_ROUTES) is logged, and a forward call fails unless it
     took "wgmma" in bf16 and "simple" in f32;
  4. serving phase: full-width ResNet-50 (224x224x3, 1000 classes, bf16,
     helpers="pallas", seeded random weights and BatchNorm statistics)
     behind ParallelInference(batch_limit=32): after a warm-up round,
     SERVE_THREADS closed-loop clients send mixed-size requests for
     SERVE_S seconds (hundreds of requests); throughput over the whole
     window, latency percentiles over every request; every response
     checked against a direct `net.output` on the same rows; the kernel
     launch counters must move by 30 (1x1) and 16 (3x3) per forward, every
     call on the "wgmma" route; the kernel path checked against the torch
     reference path;
  5. training: a step check (one `fit_batch` of the same ResNet-50 on one
     batch of 32 under "pallas" against "fused", f32 with TF32 off and
     bf16: each of the 30 routed 1x1 backwards against the composed
     backward on the same operands, the loss gap and, in f32, the
     update), then the training run — ResNet-50 at batch 128, bf16,
     nesterovs lr 1e-2, on one fixed seeded batch: TRAIN_WARMUP steps,
     then TRAIN_STEPS timed steps (img/s, ms/step from CUDA events, peak
     memory, launches per step of all four kernels: 30/16/30/30, every
     call on the "wgmma" route, a finite loss that falls,
     then a torch.profiler window: the device's busy time per step, its
     idle share, and the kernels that take the most device time), and
     the same, without the profiler window, for
     "fused" (cuDNN convolutions) as the yardstick;
  5b. the training engine on the same flagship (ResNet-50, bf16,
     helpers="pallas"): the group check — from one seeded state at batch
     32, GROUP_K eager StepProgram.run calls against one
     run_group(GROUP_K) replay (a CUDA graph of GROUP_K captured train
     steps), then a second replay after a guard snapshot restore: params,
     updater state, BN states and losses bit for bit (first, two eager
     runs must agree; if cuDNN's default algorithms make them differ,
     cudnn.deterministic is set for the engine's bitwise checks only);
     timed runs at batch 128 on one fixed batch — run (k=1) and
     run_group(GROUP_K) for ENGINE_STEPS steps under "pallas" and "fused":
     ms/step (CUDA events), img/s, host img/s, capture time (outside the
     window), peak memory, launches per step (30/16/30/30, all "wgmma",
     under "pallas"), the idle share (profiler window against the
     unprofiled ms/step) and MFU (img/s x 3 x the net's layer-shape
     multiply-adds per image / 989e12, which counts a multiply-add as one
     FLOP; twice that at two), with a
     finite, falling loss; EarlyStoppingTrainer end to end (ES_BATCHES
     batches of 128 through the input pipeline, DataSetLossCalculator,
     ES_EPOCHS epochs, NonFiniteGuard skip_step, LocalFileGraphSaver):
     the best model verifies and rescores exactly after a reload; a run
     with one NaN batch skips it once per epoch and ends bit for bit
     where a run over the clean batches ends;
  5c. MultiLayerNetwork (no helper tier, so no kernel of csrc/ on its
     path; the launch counters, zeroed before it, are read after it): the
     zoo's full-width VGG16 (224x224x3, 1000 classes, dropout 0.5 on both
     4096-wide dense layers, bf16 policy, seeded init) — `output` at
     MLN_BATCH timed by CUDA events and its log-probs against the f32
     torch path (MLN_LOGP_TOL), a few requests through ParallelInference
     against direct output; StepProgram.run and run_group(GROUP_K) with
     dropout on, MLN_STEPS steps on one fixed batch after warm-up and
     capture: ms/step, img/s, idle share, peak memory, capture s, MFU
     from VGG16's multiply-adds (one FLOP each, and two), a finite
     falling loss; a second k captured into the program's one graph
     pool and a shorter window run eagerly; the dropout checks at
     MLN_CHECK_BATCH (replay against eager steps from one generator
     state, bit for bit with the generator's state; consecutive replays
     draw new masks; a guard's skip of a NaN batch ends where the run
     without it ends); then AlexNet (LRN, the 11x11 stride-4 "same"
     conv) for ALEXNET_STEPS steps with a finite, falling loss. Images
     are scaled by MLN_INPUT_SCALE and the rates lowered (see there);
  5d. TrainingMaster and ParallelWrapper on the flagship (ResNet-50,
     bf16, helpers="pallas"; a batch_fn cycling through TM_DATA seeded
     host batches built before any timed window): TrainingMaster
     (steps_per_dispatch=GROUP_K, pipeline on) at batch 128, TM_STEPS
     steps after a warm-up fit — ms/step by the host clock with a sync at
     the end, img/s, the ratio to phase 5b's run_group(GROUP_K), the
     steady state between group ends (CUDA events), the idle share (a
     profiler window), launches per step (30/16/30/30, all "wgmma") and
     per replay, a finite falling loss — and the same at
     steps_per_dispatch=1 for TM_K1_STEPS steps; the save and restore
     seconds and bytes of one flagship checkpoint; at batch 32 the
     resume (a fresh net restores step GROUP_K of a 2*GROUP_K-step run
     and trains on: bit for bit), a torn write (checkpoint.write:truncate
     on the second save: load_latest_checkpoint falls back to the
     first) and a guard drill (one inner step of a group poisoned under
     skip_step: bit for bit a run without that batch);
     ParallelWrapper(steps_per_dispatch=GROUP_K) over PW_BATCHES batches
     of 128 against hand-driven run_group calls (bit for bit), and
     EarlyStoppingParallelTrainer over ES_PARALLEL_EPOCHS epochs with a
     LocalFileGraphSaver (the best model verifies and rescores exactly).
     The bitwise checks run with phase 5b's cuDNN setting;
  5e. observability on the flagship (lines start "obs"): TrainingMaster
     (steps_per_dispatch=GROUP_K) at batch 128 with every hook of the
     observability slice — a Tracer, the default phase profiler, a
     StepWatchdog, a Supervisor, TelemetryListener, StatsListener and
     ScoreIterationListener — against the same fit with none, from one
     seeded state: ms/step of each arm (two fits each, off on on off)
     and their ratio, each window's device time (CUDA events) and the
     median of the per-window on/off ratios and their mean without the
     one worst pair (each fails above OBS_RATIO_MAX),
     the slowest window with its profiler phase, the phase shares and
     coverage (>= OBS_COVERAGE_MIN), launches per step (30/16/30/30, all
     "wgmma"), the final state bit for bit; the registry's steps and
     phase histograms; the CostModel's FLOPs per step (register_perf of
     the captured group) against 3 x 2 x the net's layer-shape
     multiply-adds x 128 and its MFU against the fits'; StatsListener's
     histograms, render_html, export_stats_html and a UIServer GET; at
     batch 32 a `train.hang` cut by the watchdog and resumed by the
     Supervisor from the newest checkpoint, bit for bit, the hang instant
     parented to the hung window, the detection latency; OBS_REQUESTS
     traced requests through ParallelInference (every request's span
     chain, the dl4j_serving_* counters) and the device's idle share
     under SERVE_THREADS clients (the window's batches, each shape's
     kernels timed alone under the profiler); the Chrome trace
     (train_group steps = steps run) and prometheus_text parsed;
  5f. recurrent networks (lines start "rnn"; TF32 off; no kernel of csrc/
     on the path: the launch counters, zeroed before it, must read 0
     after it): the zoo's TextGenerationLSTM at bench.py:196 bench_lstm's
     configuration (2x GravesLSTM(256), vocab 98, sequence 256, bf16
     policy, rmsprop, truncated BPTT 50: five chunks of 50 and one of 6)
     on a seeded learnable one-hot character stream, through
     StepProgram.run at batch 64 and 2048 (and 2048 with bptt_remat):
     tokens/s, ms per batch and per 50-step chunk (CUDA events), peak
     memory, MFU from the layer shapes' multiply-adds per token, the idle
     share (a profiler window over one 50-step chunk's step against its
     unprofiled ms) and the top device kernels, a finite loss whose
     first-chunk score falls; at batch 64 greedy generation of
     RNN_GENERATE characters after a
     RNN_PROMPT-character prompt through rnn_time_step (ms per
     character); rnn_time_step step by step against output() on one
     sequence (f32: RNN_STREAM_TOL; the bf16 policy's output against the
     f32 stream: RNN_BF16_LOGP_TOL); the yardstick, a non-peephole LSTM
     layer against torch.nn.LSTM (cuDNN) with the weights mapped
     [i,f,o,g] -> [i,f,g,o], at RNN_YARDSTICK_SHAPES: f32 outputs within
     RNN_YARDSTICK_TOL, forward and forward+backward ms (f32 and bf16);
     tests/fixtures/golden_graph.zip restored on the card against its
     expected outputs within RNN_GOLDEN_TOL;
  5g. the graph zoo and transfer learning (lines start "zoo ", "tl ",
     "solver ", "pretrain "): GoogLeNet (224x224x3), InceptionResNetV1
     (160x160x3) and FaceNetNN4Small2 (96x96x3), 1000 classes, bf16,
     helpers="pallas", zoo defaults (nesterovs lr 1e-2), batch ZOO_BATCH
     — the forward against "fused" on the same weights (bf16 and f32,
     ZOO_LOGP_TOL); every kernel call of a batch-BATCH forward and of a
     train step counted by kernel and route against the counts derived
     from the layer shapes (path_launches), and each distinct call (the
     forward's, the step's 1x1 backwards) against its plain version in
     its dtype on the route its shape takes and in f32 on "simple"; for
     GoogLeNet every routed 1x1 backward of a batch-ZOO_CHECK_BATCH step
     against the composed backward (ROUTE_TOL), one run_group(GROUP_K)
     replay against eager steps bit for bit with dropout on, ZOO_STEPS
     timed steps through run_group(GROUP_K) under "pallas" and "fused",
     and its kernel calls timed (card, plain, library, bound) and summed
     per route; for the two embedding nets ZOO_SMALL_STEPS steps, the
     embedding rows' norms (EMBED_NORM_TOL) and the center-loss centers
     moving; ModelSelector.select("cnn"): every CNN zoo model at its
     full input size, one forward at batch 1; the ResNet-50 transfer
     (TransferLearning.GraphBuilder, frozen through "s4b5_out", nesterovs
     lr 1e-3): TL_STEPS steps, frozen params bit for bit, launches per
     step 30/16/5/5, ms/step against phase 5b's full step, write_model
     and ModelGuesser.load_model_guess scoring the same bits; VGG16
     transfer at VGG_TL_BATCH (frozen through its last pooling layer,
     the head's width replaced): frozen-base and full fine-tune ms/step,
     and TransferLearningHelper's featurized fit against the frozen
     net's fit (TL_HELPER_TOL); LeNet at MNIST width, f32: SOLVER_ITERS
     iterations of each line-search solver, a falling loss; an RBM ->
     AutoEncoder -> VAE -> softmax MLN pretrained PRETRAIN_EPOCHS epochs
     of PRETRAIN_BATCHES batches, each layer's loss falling;
  5h. Keras import and data (lines start "keras " and "data: "; no
     h5py needed: the port reads HDF5 itself): the seven
     tests/fixtures/*.h5 imported onto the card in f32 against their
     expected outputs (KERAS_TOL); canonical Keras VGG16 (BASELINE config
     4; relu convolutions) and Keras ResNet50, their committed
     tf.keras configurations (tests/fixtures/torch/) with weights seeded
     from --seed written into a whole-model .h5 by this script's HDF5
     writer (write_keras_h5) and imported (seconds, GB/s, every weight bit
     for bit); VGG16 with VGG16ImagePreProcessor on 0-255 images at
     KERAS_VGG_BATCH, bf16, run_group(GROUP_K): frozen through
     block5_pool and full fine-tune (ms/step, img/s, idle share, peak
     memory, a falling loss, the frozen params bit for bit), the
     fine-tuned net written with its normalizer and read back (the same
     normalizer, the same output bits and score), Evaluation,
     ROCMultiClass and EvaluationCalibration of a held batch on the card
     against the same fed CPU copies; ResNet50 under "pallas" and bf16:
     the forward against "fused" (bf16 and f32, ZOO_LOGP_TOL), its kernel
     calls (a batch-BATCH forward, a batch-KERAS_RESNET_BATCH train step)
     counted against path_launches and each distinct one against its
     plain version (TOL), KERAS_RESNET_STEPS timed steps beside phase
     5b's zoo ResNet-50; the native host library available, a seeded
     CSV of CSV_ROWS x CSV_COLS parsed by the C++ path and the NumPy
     fallback (bit for bit, rows/s) and fed through
     RecordReaderDataSetIterator into batches on the card; LeNet
     (BASELINE config 1) on MnistDataSetIterator's stand-in, LENET_STEPS
     steps through run_group(GROUP_K), a falling loss;
  5i. the decode-serving path (lines start "decode "; f32, TF32 off; no
     kernel of csrc/ on it: the launch counters, zeroed before it, must
     read 0 after it): bench_serving.py:1183 bench_decode's configuration
     (CausalTransformer vocab 512, d 128, 8 heads, 4 layers, ctx 128, seed
     7; DecodeProgram(max_slots=8, page_size=16)) serving DECODE_REQUESTS from
     random.Random(--seed) (prompts 4-48, 8-48 new tokens): the naive
     per-request sequential_decode arm and DecodeEngine(
     max_prefills_per_step=2), two interleaved reps each, all four token
     lists identical; tok/s of each and their ratio, decode steps, mean
     slot occupancy, ms per decode and per chunk dispatch (CUDA events),
     PyTorch kernel launches per dispatch, the idle share of a profiled
     window of engine steps; the requests served once more by the
     engine's own loop thread (start, submit, result, stop), tokens
     identical; the journal arm (GenerationJournal, fsync_interval_s
     0.05) against none, tokens identical; the paged drills, each bit for
     bit against sequential_decode — shared prefix (hits and skipped
     chunks), copy-on-write, ring wrap past max_ctx, an eviction storm
     (serving.slot_evict), a decode.nonfinite quarantine and replay, a
     StepWatchdog restart of the loop thread wedged by decode.hang, a
     resume_tokens continuation, a cold recovery from the journal of an
     engine stopped mid-generation — with the three programs' build
     counts unchanged after warm-up; one chunk's and one decode step's
     pool and logits on the card against the port on the CPU (same
     seeded weights and pool; DECODE_CPU_TOL) and the greedy tokens of
     16 requests against the CPU's where its margin is wide; then
     GPT-2-small width (vocab 50257, d 768, 12 heads, 12 layers, ctx
     1024, seeded; DecodeProgram(max_slots=32, page_size=16), a 2.4 GB
     pool): GPT2_REQUESTS requests (prompts 64-512, 32-128 new tokens) through the
     engine, tok/s, peak memory, the engine equal to the oracle on 4 of
     them, ms per decode step and per chunk beside the step's bound
     (weights + live K/V over 3.35 TB/s), and one chunk and one step
     against the CPU as at bench width;
  5j. the serving control plane (lines start "control "): (a) phase 4's
     ResNet-50 (bf16, "pallas", batch_limit=32) behind
     ModelServer(...).start(): SERVE_THREADS closed-loop npz clients of
     SERVE_SIZES rows for CONTROL_NPZ_S and CONTROL_JSON_THREADS JSON
     clients of 1 row for CONTROL_JSON_S, run from a spawned child
     process (CPU only, the port's client) so client encoding never
     takes the server's GIL: req/s, img/s, p50/p99, bytes per request,
     every response within LOGP_TOL["served"] of direct output, the
     kernels' launches 30/16 per forward, all "wgmma"; (b) a hot swap
     under 8 npz clients — a second seeded ResNet-50 written with
     write_model, PUT with activate, a corrupted upload (409), rollback,
     swap to v2 again: zero failed, zero mixed (each response within the
     limit of its version's reference and beyond it of the other's), the
     swap's seconds, v2 in f32 on the "simple" route (a zip carries no
     compute dtype); (c) tenant admission in process at 2x the
     closed-loop capacity of CONTROL_SOAK_ROWS-row requests
     (CONTROL_SOAK_MIX): gold loses nothing, its p99 against its
     unloaded p99, bronze takes the largest share of the sheds; (d)
     three in-process replicas (batch_limit CONTROL_FLEET_BATCH) behind
     a ReplicaRouter and a FleetController(min=max=3, CONTROL_SLO) under
     CONTROL_FLEET_CLIENTS router clients: a canary-first rollout of
     v2, a rollout.canary_poison rollout of v3 that breaches, rolls
     back and holds down, a serving.replica_kill tick that removes a
     replica and backfills it on the indexed device, zero mixed and zero
     failed outside the armed poison; (e) decode over HTTP: phase 5i's
     bench requests through CONTROL_DECODE_CLIENTS generate threads
     on each wire (tokens equal to phase 5i's oracle), 429 with
     Retry-After from an over-subscribed engine, a router migrating a
     generation from a retiring replica (and restarting it from the
     prompt under serving.migrate_fail), a cold restart from a killed
     server's journal, and CONTROL_GPT2_REQUESTS GPT-2-width requests
     over the npz wire equal to the in-process engine's tokens;
  5k. cluster supervision and clustering (lines start "cluster ",
     "tsne ", "kmeans ", "dashboard" and "nn "): (a) the flagship
     (ResNet-50, bf16, "pallas", batch TRAIN_BATCH) in a worker process
     (tests/fixtures/torch/cluster_worker.py) training CLUSTER_STEPS steps
     through TrainingMaster(steps_per_dispatch=GROUP_K) with a checkpoint
     per window, under StepWatchdog(heartbeat=HeartbeatFile(...),
     hang_exit_after=2) and ClusterSupervisor(nprocs=1): (i) unfaulted,
     the oracle; (ii) wedged inside a CUDA wait (a spinning kernel and
     torch.cuda.synchronize) after step 8's checkpoint in its first
     generation: the watchdog marks the lease and exits EXIT_HANG, the
     supervisor relaunches from step 8; (iii) the same wedge with the
     hard exit out of reach: the supervisor finds the lease stale,
     SIGTERMs (deferred by the wait) and SIGKILLs, and relaunches — (ii)
     and (iii) end bit for bit where (i) ends; every generation launches
     30/16/30/30 kernels per step, all "wgmma", records one capture event
     and replays the rest; detection-to-exit and relaunch-to-first-step
     seconds; (b) t-SNE's exact tier at TSNE_EXACT_N seeded MNIST-shaped
     rows of 784 (perplexity 30, TSNE_EXACT_ITERS iterations) and (c) its
     chunked tier at TSNE_N (K = 90, row_block 2048, TSNE_CHUNKED_ITERS):
     ms per iteration beside its bound, the KL at the first, 100th and
     last iteration (the last below the 100th), peak memory, the 10-NN
     label share in 2-D, P and the first iterations against the port on
     the CPU from the card's states (a spawned CPU process), and the
     chunked tier's KL on (b)'s rows against (b)'s; (d) k-means (k =
     KMEANS_K) on (c)'s rows against the CPU's; (e) a
     NearestNeighborsServer over NN_ROWS x NN_DIM f32 under NN_CLIENTS
     client threads (req/s, p50/p99, the device ms of a request beside
     its bound), NN_CHECK_QUERIES answers against an f64 brute force,
     VPTree and KDTree against knn; (f) embedding_scatter on DASH_ROWS
     rows and render_html's t-SNE tab;
  5l. the embedding trainers and graph embeddings (lines start "nlp "; no
     kernel of csrc/ on the path: the launch counters, zeroed before it,
     must read 0 after it; the port's native library must have built, so
     the C++ packers run): (a) word2vec at bench.py:468 bench_word2vec's
     configuration (vocab 5,000, 2,000,000 seeded zipf-1.1 words in
     sequences of 1,000, dim 128, window 5, K = 5, skip-gram NS, the dense
     tier): one warm epoch, then NLP_EPOCHS epochs timed NLP_REPS times up
     to a host read of one table element, the best rep: words/s, peak
     memory; the split — one epoch's host side alone (indexing,
     subsampling, the native packer on its thread) and its device side
     alone (the captured slabs dispatched back to back), device ms per
     batch beside the bound of the rows gathered and scattered (B x (K+2) x
     D x 4 bytes each way at 3.35 TB/s), busy ms per batch and the idle
     share of a profiled slab; a finite table and similarity(w0, w1); (b)
     CBOW + hierarchical softmax, vocab 50,000, dim 300, NLP_WIDE_WORDS words,
     1 epoch, on the int32 wire: the same numbers; (c) on (a)'s first
     NLP_CUT_WORDS words, each dense mode (skip-gram and CBOW x NS and
     HS) and the scan tier, GloVe, and (on NLP_PV_CUT_DOCS of its
     sequences) ParagraphVectors DBOW and DM with infer_vector, on the
     card and on the CPU: packs equal, tables within NLP_TABLE_TOL; each
     dense mode twice on the card: whether the two runs gave equal bits;
     (d)
     tests/test_nlp.py's two-topic corpus at NLP_TOPIC_SENTS sentences in
     the four dense modes (intra-topic similarity above inter-topic by
     NLP_TOPIC_GAP) and ParagraphVectors DBOW separating its documents;
     (e) DeepWalk at BlogCatalog's scale (a seeded planted partition of
     10,312 vertices, 333,983 edges, 39 blocks; d 128, window 10, walk
     length 40, BLOG_WALKS walks per vertex): walk and fit seconds,
     words/s, the share of each vertex's 10 nearest in its block against
     1/39; Node2Vec, one walk per vertex, finite;
  5m. data-parallel scale-out and ZeRO-1 (lines start "scaleout "): (a)
     an NCCL process group of world 1 (127.0.0.1, a free port); the
     flagship trained through TrainingMaster(steps_per_dispatch=GROUP_K)
     unsharded and through TrainingMaster(sharding="zero1",
     steps_per_dispatch=GROUP_K), SCALEOUT_STEPS timed steps each after a
     warm-up window (the kernel launch counters zeroed before the zero1
     fit and read after it: `scaleout_launches`): params and updater
     state bit for bit, ms/step of each, the collectives each captured
     group holds (and the NCCL kernels a profiled replay shows),
     memory_facts (at world 1 the policy shards nothing; the bytes it
     would shard at dp 2 and 8), the NCCL reduce-scatter and all-gather
     at world 1 against their inputs; a save (main file + updshard
     sidecar, seconds) and a fresh master's restore, GROUP_K more steps
     bit for bit against the uninterrupted run; (b)
     ParallelWrapper(averaging_frequency=GROUP_K) on the same batches from
     the same seed against the unsharded state (bit for bit, the
     rendezvous of one rank is an identity), then with
     threshold_compression=SCALEOUT_THRESHOLD: wire_stats and a falling
     loss; (c) StaleGradientTrainer for SCALEOUT_STALE_STEPS steps plus
     flush() against the delayed-gradient oracle (plain steps applying
     the previous step's gradient), per-step losses within STEP_TOL;
     (d) tests/fixtures/torch/scaleout_worker.py's gang of 2 ranks over
     gloo, once with CUDA tensors on the one card and once on the CPU
     (kernel-free nets: conv + BatchNorm with differing batch halves for
     plain dp, a dense net for local SGD k=2 and for ZeRO-1; batch
     SCALEOUT_GANG_BATCH, SCALEOUT_GANG_STEPS steps): card against CPU
     within SCALEOUT_GANG_TOL, ZeRO-1 against the unsharded 2-rank run
     bit for bit on the card; (e) parallel/dcn_model.crossover_report fed
     (a)'s measured ms/step and the flagship's f32 parameter bytes (its
     link constants describe a TPU slice's DCN, not this card's links);
  5n. tensor and sequence parallelism (lines start "mesh "; no kernel of
     csrc/ on these paths: the launch counters, zeroed before it and
     counted in the gang's ranks too, must read 0): a 2-rank gloo gang of
     this script (`--mesh-rank`, CUDA tensors on the one card) runs (a)
     ring_self_attention over make_mesh(sp=2) at GPT-2-small's heads
     (MESH_RING: B 1, T 8192, H 12, D 64), causal, f32 and bf16: ms per
     call, the same output on both ranks, against dense attention on the
     card (MESH_RING_TOL), beside one scaled_dot_product_attention call of
     the whole sequence; (b) phase 5c's VGG16 at MESH_VGG_BATCH through
     ParallelWrapper(tp=2): ms/step in the steady state and over a fit
     with its slicing and gathering, the collectives, each rank's param
     and updater bytes, the params against the one-process fit from the
     same seeded init (MESH_TP_TOL) and equal on both ranks; (c)
     DistributedSequenceVectors at phase 5l's bench.py:468 configuration
     over the two ranks (sync_every 1, MESH_W2V_EPOCHS timed epochs):
     words/s, the rendezvous seconds, the tables equal on both ranks;
     and beside the gang (d) tests/test_torch_cluster_gang.py's SIGKILL
     drill on the card (tests/fixtures/torch/gang_worker.py's 2 ranks
     under ClusterSupervisor, MESH_DRILL_STEPS steps): the relaunched
     gang equal to its unfaulted run;
  5o. the analyzer (lines start "analysis "): (a) tools/analyze_torch.py
     (the AST passes) on the tree, exit 0 against its baseline; (b) the
     program lint (analysis/program_lint.py) of full-width records on
     the card, outside any capture: the flagship ResNet-50 train step at
     batch TRAIN_BATCH (bf16, "pallas") and its run_group(GROUP_K) group
     record beside the launches and collectives of the group captured
     for the same key, the batch-BATCH serving forward through
     ParallelInference's buckets, the decode step and chunk prefill at
     bench_decode's width — every record's numbers printed (ops, f32
     products, copy bytes and share, host reads, kernel launches by
     route and dtype), every launch of the four kernels bf16 "wgmma",
     every finding held against tools/analyze_torch_baseline.json; (c)
     ANALYSIS_SERVE_S of phase 5j's serving (ResNet-50 "pallas" over HTTP
     from ANALYSIS_SERVE_THREADS client threads) and a short decode run
     under the port's LockOrderSanitizer: no lock-order cycle, the long
     holds reported; (d) the four kernels' launches on this path;
  6. timing: every kernel call of one batch-32 forward and of one
     batch-128 train step, timed on the card (kernel, plain version, one
     library call) beside its bound and the ratio of the two, with the
     backward calls' route, each call reading its inputs from device
     memory, not from L2;
  7. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--nccl-gang N` (a machine with N cards) runs only the tests' gang of N
ranks over NCCL, one card per rank, against the same gang over gloo on
the CPU (`nccl_gang`), then the last line. Its second launch is the F11
drill (ROADMAP queue 3): ZeRO-1's run_group(4) with the collectives
captured, the refusal lifted (DL4J_TPU_NCCL_CAPTURE=1), a 60 s process
group timeout with blocking waits, NCCL's INIT/COLL log and every rank's
warm-up, capture and replay lines; `--gang-logs DIR` keeps every rank's
whole log.

Imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the port package beside it, it exits non-zero and
prints no result.
"""

import argparse
import faulthandler
import json
import os
import random
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

# the device and image size of the run (a CPU rehearsal of the control
# flow may lower them; the driver's run never does)
DEV = "cuda"
HW = 224
BATCH = 32                     # forward kernel shapes, step check
TRAIN_BATCH = 128              # the train step: bench.py's flagship batch
TRAIN_WARMUP = 2
TRAIN_STEPS = 8
PROFILE_STEPS = 3              # profiled after the timed steps
PROFILE_TOP = 12
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2
# phase 5b, the training engine
GROUP_K = 4                    # steps per run_group (bench.py:72 unroll=4)
ENGINE_CHECK_BATCH = 32        # the bitwise group check
ENGINE_WARMUP = 2              # eager warm-up steps before the timed run
ENGINE_STEPS = 8               # timed steps: 8 run() calls, 2 replays
ENGINE_PROFILE_STEPS = 4       # steps under torch.profiler, after those
ES_BATCHES = 3                 # EarlyStoppingTrainer: batches per epoch
ES_EPOCHS = 2
# MFU: a train step is 3x the forward's multiply-adds, counted from the
# layer shapes (macs_per_image); "mfu" counts one multiply-add as one
# FLOP, as bench.py does; "mfu_2flops" counts it as two, the FLOPs the
# card's peak counts. (bench.py:57-63's 4.09e9 per image is a ResNet-50
# whose stage stride sits on the 3x3; the zoo's has 3.858e9.)
# phase 5c, MultiLayerNetwork: the zoo's VGG16 at full width (bench.py:506
# bench_vgg16's batch) and AlexNet
MLN_BATCH = 32
MLN_OUTPUT_CALLS = 10          # timed output() calls
MLN_WARMUP = 2
MLN_STEPS = 8                  # timed steps: 8 run() calls, 2 replays
MLN_PROFILE_STEPS = 4
MLN_CHECK_BATCH = 8            # the dropout checks
MLN_SERVE_SIZES = (1, 3, 8, 16, 32, 5)
ALEXNET_STEPS = 8
# phase 5d, TrainingMaster and ParallelWrapper on the flagship
TM_DATA = 4                    # seeded host batches a batch_fn cycles through
TM_STEPS = 8                   # timed steps at steps_per_dispatch=GROUP_K
TM_K1_STEPS = 4                # timed steps at steps_per_dispatch=1
TM_PROFILE_STEPS = 4           # profiled steps after a timed fit
TM_CHECK_BATCH = 32            # the resume, torn-write and guard checks
TM_CKPT_REPEATS = 1            # timed saves and restores of one checkpoint
PW_BATCHES = 4                 # ParallelWrapper's bitwise check
ES_PARALLEL_EPOCHS = 1
# phase 5f, recurrent networks: the zoo's TextGenerationLSTM at
# bench.py:196 bench_lstm's configuration
RNN_VOCAB = 98
RNN_SEQ = 256
RNN_BATCHES = (64, 2048)       # bench_lstm's default; the README's batch
RNN_REMAT_BATCH = 2048         # bench.py lstm 2048 remat
RNN_FOLLOW = 0.9               # share of characters that follow the rule
RNN_WARMUP = 1                 # fit_batch calls before the timed ones
RNN_STEPS = 2                  # timed fit_batch calls (6 chunks each)
RNN_CHUNK_CALLS = 4            # timed calls of one 50-step chunk's step
RNN_PROMPT = 32                # greedy generation at batch 64
RNN_GENERATE = 128
RNN_CHECK_STEPS = 64           # the stream-vs-output check's sequence
# rnn_time_step against output() in f32: the JAX package's bar
# (tests/test_smoke.py::test_rnn_time_step_matches_full_forward)
RNN_STREAM_TOL = {"rtol": 1e-4, "atol": 1e-5}
# the bf16 policy's output() against the f32 stream, max |log p - log
# p_ref|: readings 0.0288-0.0297 in three runs (PERF.md, PR 9), margin 3.4x
RNN_BF16_LOGP_TOL = 0.1
RNN_YARDSTICK_SHAPES = ((64, 50, 256), (2048, 50, 256))
RNN_YARDSTICK_TOL = 1e-5       # f32, TF32 off: max |port - cuDNN|
RNN_YARDSTICK_CALLS = 10
RNN_GOLDEN_TOL = 1e-5          # golden_graph.zip, max abs error
# phase 5e, observability on the flagship
OBS_STEPS = 20                 # steps per timed fit; two fits per arm
OBS_RATIO_MAX = 1.10           # hooks-on / hooks-off: the median window
                               # ratio, and their mean less the worst one
OBS_COVERAGE_MIN = 0.95        # the phase profiler's attributed share
# both arms' producer runs two windows ahead: at the default depth (2 <
# GROUP_K) the profiler's per-window wait leaves the producer pinning the
# window's last batches after the replay, where no replay hides it
OBS_PIPELINE_DEPTH = 2 * GROUP_K
# CostModel FLOPs per step vs 3 x 2 x the zoo ResNet50's layer-shape
# multiply-adds x 128, and its MFU vs the same fits' at that count
OBS_FLOPS_TOL = 0.05
OBS_WATCHDOG_S = 10.0          # flagship fit: > capture (0.64 s, PR 5)
                               # and a checkpoint save (1.2 s, PR 7)
OBS_DRILL_STEPS = 3 * GROUP_K  # the hang drill at TM_CHECK_BATCH
OBS_DRILL_WATCHDOG_S = 5.0
OBS_HANG_S = 120.0             # the train.hang delay the watchdog cuts
OBS_REQUESTS = 30              # sequential mixed-size served requests
OBS_SERVE_SIZES = (1, 3, 8, 16, 32, 5, 40)
OBS_IDLE_S = 2.0               # the serving idle-share window
# The zoo's VGG16 and AlexNet have linear convolutions: ConvolutionLayer's
# default activation is identity and the JAX package's zoo sets none (the
# configuration is held to its JSON). Under He init the activations then
# grow about 1.4x per conv: unit-variance images give VGG16 logits near
# 800 (CPU rehearsal at 64x64), a softmax saturated to one-hot, and
# nesterovs at the zoo's lr 1e-2 diverges at once (811 -> 2.5e24 -> NaN).
# At init the nets are positively homogeneous (zero biases), so images
# scaled by MLN_INPUT_SCALE give logits 100x smaller (a softmax whose
# every class is informative), and the rates below are ones under which
# the loss fell steadily in CPU rehearsals at reduced sizes (VGG16 at
# 128x128: lr 1e-4 and 1e-5; AlexNet at 224: lr 1e-3 slowly, 1e-2 with a
# spike; on the card AlexNet at 1e-3 fell only 0.04 in 8 steps).
MLN_INPUT_SCALE = 0.01
VGG16_LR = 1e-5
ALEXNET_LR = 3e-3
# VGG16's max |log p - log p_ref|: the bf16 policy against the f32 torch
# path, and served responses against direct output; set from the readings
# 0.148 and 0.092 (PERF.md, section 2) with a margin of 3.3-3.4x
MLN_LOGP_TOL = {"bf16_vs_f32": 0.5, "served": 0.3}
SERVE_S = 8.0                  # measured serving window
SERVE_THREADS = 8              # closed-loop clients
SERVE_SIZES = (1, 3, 8, 16, 32)
POOL_PER_SIZE = 4              # distinct requests of each size

# distinct ResNet-50 shapes at 224x224: (H=W, K, N) for the 1x1 convs,
# (H=W, C) for the 3x3 convs (C -> C)
SHAPES_1X1 = [(56, 64, 256), (56, 256, 64), (56, 64, 64),
              (28, 128, 512), (28, 512, 128),
              (14, 256, 1024), (14, 1024, 256),
              (7, 512, 2048), (7, 2048, 512)]
SHAPES_3X3 = [(56, 64), (28, 128), (14, 256), (7, 512)]
VARIANTS = ("plain", "affine", "affine_relu", "full")
# prologues of the 30 1x1 stride-1 convs' backward: plain input (the
# first block's a/sc convs), affine+relu, and the block inputs
# affine + plain x2 + relu, affine + affine x2 + relu
BWD_VARIANTS = ("plain", "affine_relu", "affine_x2_relu", "affine_affx2_relu")
# normalized error bounds: max|kernel - plain| / max(max|plain|, 1).
# f32: both accumulate in f32 (no TF32), only the order differs.
# bf16: one rounding of the output to bf16 (2^-8 relative) may land on
# either side when the f32 sums differ in their last bits.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# phase 5g: the graph zoo at full input size (GoogLeNet 224, Inception-
# ResNet v1 160, FaceNet NN4.small2 96), trained at ZOO_BATCH
ZOO_HW = {"GoogLeNet": 224, "InceptionResNetV1": 160,
          "FaceNetNN4Small2": 96}
ZOO_BATCH = TRAIN_BATCH
ZOO_STEPS = 8                  # GoogLeNet: timed steps, 2 replays
ZOO_SMALL_STEPS = 4            # InceptionResNetV1, FaceNetNN4Small2
ZOO_CHECK_BATCH = 32           # the routed-backward and replay checks
ZOO_PROFILE_STEPS = 4
TL_STEPS = 8                   # ResNet-50 transfer: timed steps
VGG_TL_BATCH = 32              # bench.py:506 bench_vgg16's batch
VGG_TL_STEPS = 4
VGG_TL_CLASSES = 100           # the replaced head's width
SOLVER_BATCH = 128
SOLVER_ITERS = 6
PRETRAIN_BATCH = 128
PRETRAIN_BATCHES = 8
PRETRAIN_EPOCHS = 2
# End-to-end limits on max |log p - log p_ref| over every class of every
# row (log-probabilities weigh small and large probabilities alike). Set
# from the readings of earlier runs (PERF.md) with a margin of 2-4x: the
# bf16 gaps there (0.129) are about one bf16 rounding step of a logit
# between 16 and 32 (0.125); the f32 gap was 2.3e-5. Two distinct
# rows of the serving pool differ by more than the served limit (checked),
# so a response that carries another request's row fails.
LOGP_TOL = {"served": 0.3, "bf16_vs_torch": 0.3, "bf16_vs_f32": 1.0,
            "f32_vs_torch": 1e-4}
# Step check: one fit_batch of "pallas" and of "fused" on the same
# weights and batch (PERF.md, PR 2, has the readings the limits come
# from). Two f32 train steps differ where a relu input lies within
# rounding of zero: the two paths put it on opposite sides (a mask flip),
# its gradient changes by its whole size, and the BatchNorm backward
# spreads that over its channel — a few such elements move the update by
# some 1e-3 of its size (tests/test_torch_train.py: with float64's masks
# imposed an f32 step matches float64 within 1e-4). So the wiring is held
# where no mask can flip: every routed 1x1 conv's backward in the
# "pallas" step (dx, dx2, dW, db, ds/dt) against the composed backward of
# "fused" on the same operands, error max|a - b| / max|b| (db: over the
# largest sum of |ybar|, its terms — a conv bias in front of a BatchNorm
# has a zero gradient up to rounding). ROUTE_TOL: f32 1e-4, both sum in
# f32 in another order; bf16 2^-6, the composed form rounds du, the scale
# and their product to bf16 where the kernel rounds once (three roundings
# of 2^-9). The step: relative loss gap, readings 6.2e-8 (f32) and
# 6.1e-5 (bf16), margin 16x; the f32 update's error over the largest
# update in the network ("overall", reading 3.6e-3: mask flips), margin
# 2.8x. bf16's update error (reading 0.21: bf16 rounding flips far more
# masks) has no limit.
ROUTE_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
STEP_TOL = {"float32": {"loss": 1e-6, "overall": 1e-2},
            "bfloat16": {"loss": 1e-3}}
# phase 5m: data-parallel scale-out and ZeRO-1 at world 1 on the flagship,
# and the 2-rank gloo gang of the tests on the one card. The gang's card
# against its CPU run: f32 with TF32 off on both, three small nets; a
# CUDA reduction order against the CPU's, so rtol 1e-4 / atol 1e-5.
SCALEOUT_STEPS = 8             # timed steps of each TrainingMaster fit
SCALEOUT_THRESHOLD = 1e-3      # (b)'s threshold compression
SCALEOUT_STALE_STEPS = 4
SCALEOUT_GANG_BATCH = 64
SCALEOUT_GANG_STEPS = 6
SCALEOUT_GANG_TOL = {"rtol": 1e-4, "atol": 1e-5}
# phase 5n: tensor and sequence parallelism, distributed embeddings and
# the gang drill, on a 2-rank gloo gang sharing the one card. (a) ring
# attention at GPT-2-small's heads over sp 2, causal; (b) VGG16 (phase
# 5c's model, images and rate) over tp 2; (c) DistributedSequenceVectors
# at phase 5l's bench.py:468 configuration; (d) the SIGKILL drill of
# tests/test_torch_cluster_gang.py on the card.
MESH_RING = dict(B=1, T=8192, H=12, D=64)
MESH_RING_CALLS = 3            # timed calls per dtype, after one warm call
# the ring against dense attention on the card (both from the same
# inputs): f32 at JAX's ring bar (tests/test_ring_attention.py, TF32 off);
# bf16 within two of its ulps of the f32 dense output
MESH_RING_TOL = {"float32": {"rtol": 2e-4, "atol": 2e-5},
                 "bfloat16": {"rtol": 8e-3, "atol": 1e-3}}
MESH_VGG_BATCH = 32
MESH_VGG_STEPS = 3             # timed steps, after one warm step
MESH_TP_TOL = {"rtol": 1e-3, "atol": 1e-4}   # tests/test_parallel.py's tp bar
MESH_W2V_EPOCHS = 2            # timed, after one warm epoch
MESH_DRILL_STEPS = 6
# phase 5o: the analyzer. The flagship's records at TRAIN_BATCH (group
# record at GROUP_K), the serving record at BATCH, the decode records at
# DECODE_BENCH; serving under the lock-order sanitizer
ANALYSIS_SERVE_S = 6.0
ANALYSIS_SERVE_THREADS = 4
ANALYSIS_SERVE_SIZES = (1, 3, 8, 16)
ANALYSIS_DECODE_REQUESTS = 4
ANALYSIS_LONG_HOLD_S = 1.0
# phase 5h: Keras import and data. The seven Keras fixtures against their
# expected outputs at tests/test_modelimport.py's bars; canonical Keras
# VGG16 (BASELINE config 4, bench.py:506 bench_vgg16: batch 32, frozen
# through block5_pool and full fine-tune) and Keras ResNet50 (the forward
# at BATCH, KERAS_RESNET_STEPS train steps at KERAS_RESNET_BATCH) written
# with seeded weights and imported; a CSV of CSV_ROWS x CSV_COLS; LeNet
# (BASELINE config 1) on the MNIST stand-in. The Keras models take HW-sized
# images (their configurations' own 224 unless a CPU rehearsal lowers HW).
KERAS_FIXTURES = ("seq_cnn", "func_merge", "lstm_seq", "func_cnn_merge",
                  "lstm_encoder", "conv1d_stack", "lrn_cnn")
KERAS_TOL = {"rtol": 1e-4, "atol": 1e-5}
KERAS_VGG_BATCH = 32
KERAS_VGG_STEPS = 8
KERAS_RESNET_BATCH = TRAIN_BATCH
KERAS_RESNET_STEPS = 8
# the bf16 "pallas" forward against "fused", max |log p - log p_ref|, of
# the imported ResNet50 (its f32 limit is ZOO_LOGP_TOL's): the first chip
# reading was 0.169 (f32 1.9e-5; PERF.md, phase 5h), margin 3x
KERAS_RESNET_BF16_LOGP_TOL = 0.5
CSV_ROWS = 500_000
CSV_COLS = 11
CSV_BATCH = 4096
LENET_BATCH = 64
LENET_STEPS = 8
# phase 5i, the decode-serving path: bench_serving.py:1183 bench_decode's
# configuration and traffic (its 64 requests cut to DECODE_REQUESTS, prompts
# 4-48, 8-48 new tokens,
# drawn from random.Random(--seed)), then GPT-2-small width
# (openai-community/gpt2's published config: 12 layers, 12 heads, 768
# wide, 1024 positions, vocab 50257; seeded weights, nothing downloaded)
DECODE_BENCH = dict(vocab_size=512, d_model=128, n_heads=8, n_layers=4,
                    max_ctx=128, seed=7)
DECODE_SLOTS, DECODE_PAGE = 8, 16
DECODE_REQUESTS = 24            # bench_decode's 64, cut for the time limit
DECODE_PROMPT, DECODE_NEW = (4, 48), (8, 48)
DECODE_PREFILLS = 2            # max_prefills_per_step, as bench_decode
DECODE_TIMED = 10              # dispatches timed per program
DECODE_IDLE_SKIP = 60          # engine steps before the profiled window
DECODE_IDLE_STEPS = 30         # engine steps in the profiled window
GPT2 = dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=12,
            max_ctx=1024)
GPT2_SLOTS, GPT2_PAGE = 32, 16
GPT2_REQUESTS = 12             # of the GPT2_SLOTS slots (cut)
GPT2_PROMPT, GPT2_NEW = (64, 512), (32, 128)
GPT2_PREFILLS = 4              # chunk dispatches per engine step
GPT2_ORACLE = 4                # requests checked against sequential_decode
GPT2_TIMED = 5
GPT2_BOUND_LIVE = 512          # live cells per slot in the timed step
# the card against the port on the CPU (which tests/test_torch_decode_
# parity.py holds to JAX): the largest |card - CPU| allowed on a logit or
# a pool cell, f32 (that test's TOL), and greedy tokens compared on the
# requests whose CPU top-1 margin exceeds 100 x it at every step
DECODE_CPU_TOL = 1e-5
DECODE_CPU_MARGIN = 100 * DECODE_CPU_TOL
DECODE_CPU_REQUESTS = 16       # bench-width requests decoded on the CPU
DECODE_CPU_WIDE_MIN = 4        # wide-margin requests the check needs
DECODE_POOL_STD = 0.5          # the seeded pool's cells (K/V at init ~0.55)
# Phase 5g: the zoo graphs' "pallas" forward against "fused" on the same
# weights, max |log p - log p_ref|, under the bf16 policy (per model) and
# in f32 (TF32 off). With seeded random weights a deep bf16 graph's logits
# carry errors of O(1): its features grow large and positive, and the
# rescaled head sums them with cancellation (any bf16 mode of GoogLeNet
# against f32 reads 3.3 at 64x64 on the CPU). Limits from the readings of
# the first chip run (PERF.md, PR 10): bf16 GoogLeNet 1.99 (margin 2x),
# InceptionResNetV1 0.027 and FaceNetNN4Small2 0.028 (3.6x); f32 1.07e-4
# at most (4.7x). Embedding rows: norms 1 within 2^-6 (readings 4.1e-3,
# 3.6e-3: a few bf16 roundings of 2^-9). The TransferLearningHelper's
# tail against the frozen net's own fit on the same batches (norm_err):
# the same kernels on the same bf16 values, read bit for bit (0.0) on
# the H100 and the CPU; the limit leaves room for a library that picks
# another algorithm for the tail's own calls.
ZOO_LOGP_TOL = {"GoogLeNet": 4.0, "InceptionResNetV1": 0.1,
                "FaceNetNN4Small2": 0.1, "float32": 5e-4,
                "KerasResNet50": KERAS_RESNET_BF16_LOGP_TOL}
EMBED_NORM_TOL = 2.0 ** -6
TL_HELPER_TOL = 1e-6
# phase 5j, the serving control plane: phase 4's network and traffic over
# HTTP (npz: SERVE_THREADS clients of SERVE_SIZES rows; JSON: 1-row
# requests, a 32-row JSON body being ~50 MB of text), the hot swap, tenant
# admission at 2x capacity (bench_serving.py:324 bench_soak's path,
# tenant mix and shed thresholds, :434-441), a three-replica fleet, and
# decode over HTTP (phase 5i's configurations)
CONTROL_NPZ_S = 3.0
CONTROL_JSON_S = 2.0
CONTROL_JSON_THREADS = 4
CONTROL_SWAP_WAIT = 16         # requests a version serves per drill step
CONTROL_SOAK_ROWS = 16
CONTROL_CAPACITY_S = 2.0       # closed loop, gold only
CONTROL_BASELINE_S = 2.0       # gold alone, open loop at its soak rate
CONTROL_SOAK_S = 3.0           # open loop at 2x capacity
# (tenant, share of the offered load, priority, quota rate as a share
# of capacity, burst)
CONTROL_SOAK_MIX = (("gold", 0.15, "high", None, None),
                    ("silver", 0.25, "normal", 0.04, 8),
                    ("bronze", 0.60, "low", 0.02, 4))
CONTROL_SHED_THRESHOLDS = {"low": 0.03, "normal": 0.08}
CONTROL_FLEET = 3
CONTROL_FLEET_BATCH = 16       # each replica's batch_limit
CONTROL_FLEET_CLIENTS = 4
CONTROL_FLEET_ROWS = 8
CONTROL_SLO = ("error_rate<0.05,min_requests=5,window=500ms,windows=2,"
               "ramp_windows=1")
CONTROL_DECODE_CLIENTS = 8
CONTROL_GPT2_REQUESTS = 4
CONTROL_GPT2_PROMPT = (64, 256)
# phase 5k: cluster supervision of the flagship and clustering. (a) A
# worker process (tests/fixtures/torch/cluster_worker.py) trains the
# flagship through TrainingMaster(steps_per_dispatch=GROUP_K,
# checkpoint_every=GROUP_K) under StepWatchdog(heartbeat=HeartbeatFile,
# hang_exit_after=2) and ClusterSupervisor(nprocs=1): the unfaulted
# oracle, a wedge inside a CUDA wait at the start of window
# CLUSTER_WEDGE_WINDOW (after the checkpoint of step 8) escalated by the
# watchdog's hard exit, and the same wedge found stale by the supervisor.
# The worker captures its group before the watchdog starts, so the lease
# covers steps and checkpoints (CLUSTER_WATCHDOG_S, CLUSTER_LEASE_S) and
# CLUSTER_STARTUP_GRACE_S covers the interpreter, the build and the
# capture. (b)-(d) run on seeded MNIST-shaped rows made as the port's
# MNIST stand-in makes them (datasets/fetchers.py: 10 class templates +
# noise, 28x28 = 784 wide): t-SNE's exact tier at DENSE_CAP rows and its
# chunked tier at MNIST's 70,000 (perplexity 30, K = 90 neighbours,
# row_block 2048), k-means with k = 10 on the 70,000. (e) serves k-NN over
# a seeded 1,000,000 x 128 f32 corpus (a user's embedding table). (f)
# runs the dashboard's t-SNE tab on 2,000 of (b)'s rows.
CLUSTER_STEPS = 12             # three windows: the wedge's at the last
CLUSTER_WEDGE_WINDOW = 3
CLUSTER_WATCHDOG_S = 4.0       # the worker watchdog's timeout_s
CLUSTER_LEASE_S = 12.0         # the supervisor's lease_timeout_s: above
                               # the hard exit's 2 x CLUSTER_WATCHDOG_S
CLUSTER_STARTUP_GRACE_S = 180.0
CLUSTER_WEDGE = "cuda"         # wedge inside a CUDA wait
CLUSTER_WEDGE_S = 120.0        # the spin kernel's length (killed earlier)
CLUSTER_RUN_S = 600.0          # each supervised run's deadline
TSNE_EXACT_N = 16384           # clustering.Tsne.DENSE_CAP
TSNE_N = 70000                 # MNIST's train + test rows
TSNE_D = 784
TSNE_PERPLEXITY = 30.0
TSNE_EXACT_ITERS = 200         # the JAX package's default max_iter, 500, cut
TSNE_CHUNKED_ITERS = 200
TSNE_ROW_BLOCK = 2048
# the card against the port on the CPU from the same state (one
# iteration each, on the card's state: a chaotic map amplifies one ulp
# to a different embedding within tens of iterations), error over
# max(1, max|y|): f32 sums in another order; the affinities within
# TSNE_P_TOL (the 50-step beta bisection may take one comparison the
# other way; the symmetrized sparse P scaled by 2N, its conditional P's
# scale)
TSNE_STEP_TOL = 1e-4
# the first chip run read 1.12e-4 on the dense P's rows (16,384 x 784:
# |x|^2 ~ 300 cancels in each f32 d2); margin 4.5x
TSNE_P_TOL = 5e-4
TSNE_EXACT_CPU_STEPS = 10
TSNE_CHUNKED_CPU_STEPS = 1     # one CPU iteration at 70,000 rows: ~25 s
TSNE_CHECK_ROWS = 256          # rows whose kNN and P the CPU recomputes
TSNE_LABEL_SHARE = 0.9         # of each point's 10 nearest in 2-D
# (b)'s embedding against the chunked tier's on (b)'s rows, each scored
# by the exact tier's KL (its dense P): JAX's bar, tests/test_clustering.py
TSNE_KL_REL = 0.15
TSNE_KL_ABS = 0.1
# a k-NN answer in f32 may name a neighbour whose exact squared distance
# exceeds the true k-th one's by the rounding of |q|^2 + |x|^2 - 2 q.x:
# KNN_ULPS x 2^-24 x (|q|^2 + max |x|^2) (a sum of 784 products rounds
# ~sqrt(784) = 28 ulps of its size on average)
KNN_ULPS = 64
KMEANS_K = 10
KMEANS_ITERS = 100
KMEANS_GAP_TOL = 1e-4          # a point may change cluster only this near a tie
KMEANS_TOL = 1e-4              # centres and inertia, relative
NN_ROWS = 1_000_000
NN_DIM = 128
NN_K = 10
NN_QUERIES = 64                # per request
NN_CLIENTS = 8
NN_WINDOW_S = 3.0
NN_CHECK_QUERIES = 256
NN_TREE_ROWS = 20000
NN_TREE_QUERIES = 8
DASH_ROWS = 2000

# Phase 5l: the embedding trainers and graph embeddings. (a) is bench.py:468
# bench_word2vec's configuration: vocab 5,000, 2,000,000 zipf-1.1 words
# from default_rng(0) in sequences of 1,000, dim 128, window 5, K = 5,
# skip-gram with negative sampling, the dense tier; one warm epoch, then
# NLP_EPOCHS epochs timed NLP_REPS times, the best rep. (b) CBOW with
# hierarchical softmax at the width of the published GoogleNews vectors
# (300) over a 50,000-word zipf vocabulary (above the int16 wire's
# 32,768: the int32 wire), NLP_WIDE_WORDS words, one epoch. (c) the card
# against the port on the CPU on (a)'s first NLP_CUT_WORDS words. (d)
# tests/test_nlp.py's two-topic corpus at NLP_TOPIC_SENTS sentences. (e)
# DeepWalk at BlogCatalog's scale (Perozzi et al. 2014, table 1: 10,312
# vertices, 333,983 edges, 39 labels) on a seeded planted partition (the
# real graph is not in the repository) with the paper's d = 128, window
# 10 and walk length 40; walks per vertex cut from the paper's 80 to 5
# (the JAX fit_graph default) and Node2Vec's one walk per vertex to
# length 10: both are Python loops on the host.
NLP_VOCAB = 5000
NLP_WORDS = 1_000_000
NLP_SEQ = 1000
NLP_DIM = 128
NLP_WINDOW = 5
NLP_NEG = 5
NLP_EPOCHS = 2                 # bench.py's 5, cut for the time limit
NLP_REPS = 1
NLP_WIDE_VOCAB = 50_000
NLP_WIDE_DIM = 300
NLP_WIDE_WORDS = 1_000_000
NLP_CUT_WORDS = 20_000
# the card against the port on the CPU after the same fit: max abs error
# over max(1, max|CPU table|) (the card sums scatters with float atomics,
# the CPU in index order; the port against the JAX package reads ~1e-5
# at this bar in tests/test_torch_nlp_parity.py)
NLP_TABLE_TOL = 1e-4
NLP_PV_CUT_DOCS = 50           # (c)'s ParagraphVectors: 50 of its sequences
NLP_TOPIC_SENTS = 20_000
NLP_TOPIC_BATCH = 128          # tests/test_nlp.py's dense batch for 12 words
NLP_TOPIC_GAP = 0.2            # intra- over inter-topic similarity
NLP_PV_DOCS = 400
NLP_PV_EPOCHS = 20
NLP_PV_NN_SHARE = 0.9          # docs whose nearest doc shares their topic
BLOG_VERTICES = 10_312
BLOG_EDGES = 333_983
BLOG_BLOCKS = 39
BLOG_INSIDE = 0.8              # share of edges inside a block
BLOG_DIM = 128
BLOG_WINDOW = 10
BLOG_WALK = 40
BLOG_WALKS = 2                 # per vertex (the paper's 80, cut)
BLOG_N2V_WALK = 5              # Node2Vec's one walk per vertex, cut from 40
BLOG_SHARE_MIN = 0.9           # of each vertex's 10 nearest in its block


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def norm_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def copies_for(nbytes):
    """Input copies to rotate through so that one pass over them moves
    4x the L2: every call then reads its inputs from device memory."""
    return max(1, min(64, -(-4 * L2_BYTES // max(1, int(nbytes)))))


def time_ms(torch, calls, min_calls=10, replays=5):
    """Device time of one call: max(min_calls, len(calls)) calls, taken
    in turn from `calls` (each on its own copy of the inputs), captured in
    a CUDA graph (so host-side launch overhead does not stretch the
    timeline) and replayed `replays` times between CUDA events."""
    reps = max(min_calls, len(calls))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def log_probs(np, p):
    return np.log(np.maximum(np.asarray(p, np.float64), 1e-30))


def logp_gap(np, a, b):
    """max |log a - log b| over all elements."""
    return float(np.abs(log_probs(np, a) - log_probs(np, b)).max())


# ------------------------------------------------------------ phase 3


def make_inputs(torch, gen, dt, m, k, n, kind, variant, hw=None):
    dev = DEV
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if kind == "1x1":
        x = r(m, k).to(dt)
        w = (r(k, n) / k ** 0.5).to(dt)
    else:
        bsz, h = hw
        x = r(bsz, h, h, k).to(dt)
        w = (r(3, 3, k, n) / (9 * k) ** 0.5).to(dt)
    kw = {}
    if variant != "plain":
        kw["scale"] = r(k) * 0.5 + 1.0
        kw["shift"] = r(k) * 0.1
    if variant in ("affine_relu", "full"):
        kw["relu"] = True
    if variant == "full" and kind == "1x1":
        kw["add"] = r(m, k).to(dt)
        kw["emit_u"] = True
    return x, w, r(n) * 0.1, kw


def kernel_phase(torch, pc, batch, dtypes=("bfloat16", "float32")):
    """The forward kernels against their plain versions at every distinct
    ResNet-50 shape at `batch`, every prologue variant; each call's route
    (pc.FORWARD_ROUTES) must be "wgmma" for bf16 and "simple" for f32."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    worst = {}
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        tol = TOL[dtype]
        cases = [("1x1", h, k, n) for h, k, n in SHAPES_1X1] + \
                [("3x3", h, c, c) for h, c in SHAPES_3X3]
        for kind, h, k, n in cases:
            m = batch * h * h
            for variant in VARIANTS:
                x, w, b, kw = make_inputs(torch, gen, dt, m, k, n, kind,
                                          variant, (batch, h))
                if kind == "1x1":
                    kern, plain = pc.fused_conv1x1, pc.ref_fused_conv1x1
                    name = "fused_conv1x1"
                else:
                    kern, plain = pc.fused_conv3x3, pc.ref_fused_conv3x3
                    name = "fused_conv3x3"
                pc.reset_launch_counts()
                got = kern(x, w, b, **kw)
                ref = plain(x, w, b, **kw)
                # the main path asks for no statistics: same y, no ssum/ssq
                bare = kern(x, w, b, **kw, stats=False)
                torch.cuda.synchronize()
                route = launched_routes(pc)[name]
                want = "wgmma" if dtype == "bfloat16" else "simple"
                errs = {"y": norm_err(got[0], ref[0]),
                        "ssum": norm_err(got[1], ref[1]),
                        "ssq": norm_err(got[2], ref[2])}
                if kind == "1x1" and kw.get("emit_u"):
                    errs["u"] = norm_err(got[3], ref[3])
                abs_y = float((got[0].float() - ref[0].float()).abs().max())
                worst[name] = max(worst.get(name, 0.0), abs_y)
                ok = all(e <= tol for e in errs.values()) and bool(
                    torch.isfinite(got[0]).all()) and torch.equal(
                    bare[0], got[0]) and bare[1] is None and route == want
                log(f"check {name} {dtype} batch {batch} {kind} {h}x{h} "
                    f"K={k} N={n} {variant}: " + " ".join(
                        f"{key}={v:.2e}" for key, v in errs.items())
                    + f" max_abs_y={abs_y:.3e} tol={tol:g} route={route} "
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    fail(f"{name} disagrees with its plain version or took "
                         f"route {route}, not {want} ({dtype}, batch "
                         f"{batch}, {kind} {h}x{h} K={k} N={n} {variant})")
    return worst


def backward_inputs(torch, gen, dt, m, k, n):
    """Every operand a 1x1 backward call can take, at one shape."""
    r = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    return {"dy": (r(m, n) * 0.1).to(dt), "y": r(m, n).to(dt),
            "w": (r(k, n) / k ** 0.5).to(dt), "x": r(m, k).to(dt),
            "x2": r(m, k).to(dt), "du_out": (r(m, k) * 0.1).to(dt),
            "scale": r(k) * 0.5 + 1.0, "shift": r(k) * 0.1,
            "scale2": r(k) * 0.5 + 1.0, "shift2": r(k) * 0.1,
            "dssum": r(n) * 1e-3, "dssq": r(n) * 1e-3}


# prologue flags (affine, x2: None | "plain" | "affine", relu) of a variant
VARIANT_FLAGS = {"plain": (False, None, False),
                 "affine_relu": (True, None, True),
                 "affine_x2_relu": (True, "plain", True),
                 "affine_affx2_relu": (True, "affine", True)}


def backward_args(ops, affine, x2, duo, stats, relu):
    """dgrad_conv1x1's keyword arguments for one call of the path."""
    kw = {"dy": ops["dy"], "y": ops["y"], "w": ops["w"], "x": ops["x"],
          "relu": relu}
    if affine:
        kw["scale"], kw["shift"] = ops["scale"], ops["shift"]
    if x2 is not None:
        kw["x2"] = ops["x2"]
    if x2 == "affine":
        kw["scale2"], kw["shift2"] = ops["scale2"], ops["shift2"]
    if duo:
        kw["du_out"] = ops["du_out"]
    if stats:
        kw["dssum"], kw["dssq"] = ops["dssum"], ops["dssq"]
    return kw


def wgrad_args(kw):
    return {k: v for k, v in kw.items() if k not in ("w", "du_out")}


def launched_routes(pc):
    """The route (pc.FORWARD_ROUTES, pc.BACKWARD_ROUTES) each kernel took
    since the counts were last reset: "wgmma", "simple", "none", or
    "mixed"."""
    out = {}
    for name, routes in {**pc.FORWARD_ROUTES,
                         **pc.BACKWARD_ROUTES}.items():
        took = [r for r, v in routes.items() if v]
        out[name] = took[0] if len(took) == 1 else ("mixed" if took
                                                     else "none")
    return out


def backward_kernel_phase(torch, pc, batch):
    """dgrad/wgrad against their plain versions at every 1x1 stride-1
    backward shape of ResNet-50 at `batch`, bf16 and f32, every variant
    with and without du_out and statistics; each kernel run twice on the
    same inputs must give the same bits."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst = {"dgrad_conv1x1": 0.0, "wgrad_conv1x1": 0.0}
    names = ("dx1", "dx2", "ds1", "dt1", "ds2", "dt2", "db")
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        tol = TOL[dtype]
        for h, k, n in SHAPES_1X1:
            m = batch * h * h
            ops = backward_inputs(torch, gen, dt, m, k, n)
            for variant in BWD_VARIANTS:
                for duo in (False, True):
                    for stats in (False, True):
                        kw = backward_args(ops, *VARIANT_FLAGS[variant][:2],
                                           duo, stats,
                                           VARIANT_FLAGS[variant][2])
                        wkw = wgrad_args(kw)
                        pc.reset_launch_counts()
                        got = pc.dgrad_conv1x1(**kw)
                        again = pc.dgrad_conv1x1(**kw)
                        ref = pc.ref_dgrad_conv1x1(**kw)
                        gw = pc.wgrad_conv1x1(**wkw)
                        gw2 = pc.wgrad_conv1x1(**wkw)
                        rw = pc.ref_wgrad_conv1x1(**wkw)
                        torch.cuda.synchronize()
                        routes = launched_routes(pc)
                        errs, same = {}, torch.equal(gw, gw2)
                        for nm, a, b, c in zip(names, got, ref, again):
                            if (a is None) != (b is None):
                                fail(f"dgrad {nm}: absent in one version")
                            if a is not None:
                                errs[nm] = norm_err(a, b)
                                same = same and torch.equal(a, c)
                        errs["dW"] = norm_err(gw, rw)
                        abs_dx = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got[:2], ref[:2])
                                     if a is not None)
                        abs_dw = float((gw - rw).abs().max())
                        worst["dgrad_conv1x1"] = max(worst["dgrad_conv1x1"],
                                                     abs_dx)
                        worst["wgrad_conv1x1"] = max(worst["wgrad_conv1x1"],
                                                     abs_dw)
                        ok = same and all(e <= tol for e in errs.values()) \
                            and bool(torch.isfinite(got[0]).all()) \
                            and bool(torch.isfinite(gw).all())
                        log(f"check backward {dtype} M={m} K={k} N={n} "
                            f"{variant} du_out={int(duo)} stats={int(stats)}: "
                            + " ".join(f"{key}={v:.2e}"
                                       for key, v in errs.items())
                            + f" max_abs_dx={abs_dx:.3e} "
                            f"max_abs_dW={abs_dw:.3e} bitwise_repeat="
                            f"{same} tol={tol:g} route dgrad="
                            f"{routes['dgrad_conv1x1']} wgrad="
                            f"{routes['wgrad_conv1x1']} "
                            + ("ok" if ok else "FAIL"))
                        if not ok:
                            fail(f"1x1 backward kernels disagree with their "
                                 f"plain versions or are not repeatable "
                                 f"({dtype}, M={m} K={k} N={n} {variant} "
                                 f"du_out={duo} stats={stats})")
            del ops
    return worst


# ------------------------------------------------------------ phase 4


def randomize_batchnorm(torch, net, seed, hw=None):
    """Seeded random gamma/beta, and running statistics near the real
    per-channel statistics of each conv output on a seeded batch of
    `hw`-sized images (default HW; so the network's activations stay at a
    realistic scale), scaled/offset by seeded noise (var > 0): the affine
    prologues are not the identity. The output layer is rescaled so the
    logits have unit spread."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import BatchNormalization

    gen = torch.Generator().manual_seed(seed)
    bn_nodes = [n for n in net.topo if n.kind == "layer"
                and isinstance(n.obj, BatchNormalization)]
    params = {k: dict(v) for k, v in net.params.items()}
    for node in bn_nodes:
        c = params[node.name]["gamma"].shape[0]
        # the last BN of each residual branch (the zoo's "_c_bn", Keras
        # ResNet50's "_3_bn") gets a small gamma, as in trained ResNets:
        # blocks stay near the identity, so the random network does not
        # amplify rounding differences layer by layer
        g0 = 0.2 if node.name.endswith(("_c_bn", "_3_bn")) else 1.0
        params[node.name]["gamma"] = (
            g0 * (1.0 + 0.1 * torch.randn(c, generator=gen))).to(DEV)
        params[node.name]["beta"] = (0.1 * torch.randn(c, generator=gen)).to(DEV)
    # batch statistics: an f32 per-layer twin whose BN layers have no
    # running state (the eval path then normalizes with batch statistics)
    twin = ComputationGraph(net.conf, device=DEV)
    twin._fusion_plan = None
    twin.params = params
    twin.states = {k: ({} if k in {n.name for n in bn_nodes} else v)
                   for k, v in net.states.items()}
    hw = hw or HW
    x = torch.randn(8, hw, hw, 3, generator=gen).to(DEV)
    acts = twin.feed_forward(x)
    # output layer scaled so the logits have unit spread: softmax then is
    # not saturated and a comparison of probabilities means something
    out_name = net.conf.network_outputs[0]
    feats = acts[net.conf.node(out_name).inputs[0]].float()
    logits = feats @ params[out_name]["W"] + params[out_name]["b"]
    params[out_name] = dict(params[out_name],
                            W=params[out_name]["W"] / float(logits.std()))
    states = dict(net.states)
    for node in bn_nodes:
        a = acts[node.inputs[0]].float()
        c = a.shape[-1]
        mean = a.mean(dim=(0, 1, 2))
        var = a.var(dim=(0, 1, 2), unbiased=False)
        std = var.clamp_min(1e-6).sqrt()
        noise_m = torch.randn(c, generator=gen).to(DEV)
        noise_v = torch.rand(c, generator=gen).to(DEV)
        states[node.name] = {"mean": mean + 0.1 * std * noise_m,
                             "var": var * (0.8 + 0.45 * noise_v) + 1e-3}
    net.params = params
    net.states = states


def serving_inputs(np, rng, rows, hw=None):
    """Seeded `hw`-sized images (default HW); each row gets its own
    brightness and contrast, so distinct rows give distinct outputs."""
    hw = hw or HW
    loc = rng.uniform(-1.0, 1.0, size=(rows, 1, 1, 1))
    scale = rng.uniform(0.5, 2.0, size=(rows, 1, 1, 1))
    return (loc + scale * rng.normal(size=(rows, hw, hw, 3))).astype(
        np.float32)


def row_separation(np, probs):
    """min over pairs of distinct rows of max |log p_i - log p_j|: what an
    exchange of two rows would move the served-vs-direct gap by."""
    lp = log_probs(np, probs)
    return min(float(np.abs(lp[i + 1:] - lp[i]).max(axis=1).min())
               for i in range(len(lp) - 1))


def serving_pool(np, hw):
    """The serving request pool of phases 4 and 5j: POOL_PER_SIZE seeded
    requests of each of SERVE_SIZES rows, `hw`-sized images."""
    rng = np.random.default_rng(7)
    return [serving_inputs(np, rng, s, hw) for s in SERVE_SIZES
            for _ in range(POOL_PER_SIZE)]


def serving_phase(torch, np, pc, net):
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    pool = serving_pool(np, HW)
    errors = []

    def client(t, seed, out, n=None, deadline=None):
        order = np.random.default_rng(seed + t)
        try:
            while (n is None or len(out[t]) < n) and (
                    deadline is None or time.perf_counter() < deadline):
                i = int(order.integers(len(pool)))
                t0 = time.perf_counter()
                y = pi.output(pool[i])
                out[t].append((i, t0, time.perf_counter(), y))
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    def run(seed, **kw):
        out = [[] for _ in range(SERVE_THREADS)]
        threads = [threading.Thread(target=client, args=(t, seed, out),
                                    kwargs=kw)
                   for t in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [r for per_thread in out for r in per_thread]

    pi = ParallelInference(net, batch_limit=32, queue_limit=256,
                           default_timeout_s=300.0, max_wait_ms=2.0)
    try:
        log(f"serving: warmed buckets {pi.stats()['warmed_buckets']}")
        run(1000, n=len(SERVE_SIZES))          # warm-up, outside the window
        b0 = pi.stats()["batches_dispatched"]
        pc.reset_launch_counts()
        t_start = time.perf_counter()
        records = run(100, deadline=t_start + SERVE_S)
        counts = dict(pc.LAUNCHES)
        fwd_routes = {k: dict(v) for k, v in pc.FORWARD_ROUTES.items()}
        st = pi.stats()
        forwards = st["batches_dispatched"] - b0
    finally:
        pi.shutdown()
    if errors:
        fail(f"serving raised: {errors[0]!r}")
    wall = max(r[2] for r in records) - t_start
    images = sum(pool[r[0]].shape[0] for r in records)
    lat_ms = np.array([(r[2] - r[1]) * 1e3 for r in records])
    pct = {q: float(np.percentile(lat_ms, q)) for q in (50, 90, 99)}
    log(f"serving: {len(records)} requests, {images} images in "
        f"{wall:.3f} s = {images / wall:.1f} img/s ({SERVE_THREADS} "
        f"closed-loop clients); latency ms p50={pct[50]:.1f} "
        f"p90={pct[90]:.1f} p99={pct[99]:.1f} max={lat_ms.max():.1f}; "
        f"{forwards} forwards, bucket fill {st['bucket_fill']}")
    log(f"serving: launches {counts} over {forwards} forwards, forward "
        f"routes {fwd_routes}")
    if forwards <= 0 or counts["fused_conv1x1"] != 30 * forwards or \
            counts["fused_conv3x3"] != 16 * forwards:
        fail(f"launch counts {counts} != 30/16 per forward x {forwards}")
    # every bf16 forward kernel call of the served path takes the Hopper
    # design
    for name in ("fused_conv1x1", "fused_conv3x3"):
        if fwd_routes[name] != {"wgmma": counts[name], "simple": 0}:
            fail(f"serving: {name} routes {fwd_routes[name]}: not every "
                 f"call took the wgmma route")

    ncls = net.conf.node("output").obj.n_out
    direct = [net.output(x).cpu().numpy() for x in pool]
    worst_abs = worst_logp = 0.0
    for i, _, _, got in records:
        if got.shape != (pool[i].shape[0], ncls) or \
                not np.isfinite(got).all():
            fail(f"bad response shape/values {got.shape}")
        worst_abs = max(worst_abs, float(np.abs(got - direct[i]).max()))
        worst_logp = max(worst_logp, logp_gap(np, got, direct[i]))
    sep = row_separation(np, np.concatenate(direct))
    log(f"serving: every response against direct output: max |log p "
        f"gap| = {worst_logp:.3e} (limit {LOGP_TOL['served']:g}), max "
        f"|p gap| = {worst_abs:.3e}; distinct rows differ by >= "
        f"{sep:.3e} in log p")
    # the kernels give each row the same result in any batch; torch ops
    # (the stem convolution, the head) may pick another algorithm per
    # batch size, which moves bf16 results by a few roundings
    if worst_logp > LOGP_TOL["served"]:
        fail(f"served responses differ from direct output by "
             f"{worst_logp:.3e} in log p")
    if sep <= LOGP_TOL["served"]:
        fail(f"rows of the pool differ by only {sep:.3e} in log p: the "
             f"served-vs-direct check could not tell rows apart")
    return {"img_per_s": images / wall, "requests": len(records),
            "images": images, "wall_s": wall, "clients": SERVE_THREADS,
            "latency_ms_p50": pct[50], "latency_ms_p90": pct[90],
            "latency_ms_p99": pct[99], "latency_ms_max": float(lat_ms.max()),
            "forwards": forwards, "launches": counts,
            "forward_routes": fwd_routes,
            "served_logp_gap": worst_logp, "served_p_gap": worst_abs,
            "row_separation_logp": sep}


def reference_check(torch, np, net):
    """The kernel path (helpers="pallas") against the same network through
    torch convolutions — the fused executor with torch convs ("fused")
    and the per-layer executor ("none") — on 8 seeded images: under the
    bf16 policy, and in f32 (TF32 off), where the f32 kernels must agree
    with the reference to within f32 accumulation-order noise."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    x = serving_inputs(np, np.random.default_rng(11), 8)
    ncls = net.conf.node("output").obj.n_out
    out = {}
    saved = net.conf.helper_mode
    try:
        for cd in (torch.bfloat16, None):
            for mode in ("pallas", "fused", "none"):
                net.conf.helper_mode = mode
                twin = ComputationGraph(net.conf, compute_dtype=cd,
                                        device=DEV)
                twin.params, twin.states = net.params, net.states
                out[(mode, cd)] = o = twin.output(x).float().cpu().numpy()
                if o.shape != (8, ncls) or not np.isfinite(o).all():
                    fail(f"{mode}: bad output {o.shape}")
                if np.abs(o.sum(-1) - 1).max() > 2e-2:
                    fail(f"{mode}: rows do not sum to 1")
    finally:
        net.conf.helper_mode = saved
    d = lambda a, b: logp_gap(np, out[a], out[b])
    bf = torch.bfloat16
    res = {"bf16_vs_fused": d(("pallas", bf), ("fused", bf)),
           "bf16_vs_none": d(("pallas", bf), ("none", bf)),
           "f32_vs_none": d(("pallas", None), ("none", None)),
           "bf16_vs_f32_none": d(("pallas", bf), ("none", None))}
    log("reference, max |log p gap|: " + ", ".join(
        f"{k}={v:.3e}" for k, v in res.items()))
    # bf16 paths round at different points in each of the 53 conv layers;
    # f32 paths differ only in the order of f32 accumulation
    if (max(res["bf16_vs_fused"], res["bf16_vs_none"])
            > LOGP_TOL["bf16_vs_torch"]
            or res["bf16_vs_f32_none"] > LOGP_TOL["bf16_vs_f32"]
            or res["f32_vs_none"] > LOGP_TOL["f32_vs_torch"]):
        fail(f"kernel path disagrees with the torch reference path "
             f"(limits {LOGP_TOL})")
    return res


def forward_times(torch, net, batch):
    """One direct forward at `batch` per helper mode: host clock around
    synchronized eager calls (what a caller waits), and device time of
    the same forward captured in a CUDA graph (no host overhead)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(batch, HW, HW, 3, generator=gen).to(DEV)
    res = {}
    saved = net.conf.helper_mode
    try:
        for mode in ("pallas", "fused", "none"):
            net.conf.helper_mode = mode
            net._fusion_plan = "uninit"
            for _ in range(2):
                net.output(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 5
            for _ in range(n):
                net.output(x)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / n
            res[mode] = {"host_ms": host, "device_ms": time_ms(
                torch, [lambda: net.output(x)], min_calls=1, replays=10)}
    finally:
        net.conf.helper_mode = saved
        net._fusion_plan = "uninit"
    log(f"forward batch {batch}: " + ", ".join(
        f"{m} host {v['host_ms']:.2f} ms, device {v['device_ms']:.2f} ms "
        f"({batch / v['device_ms'] * 1e3:.0f} img/s)"
        for m, v in res.items()))
    return res


# ------------------------------------------------------------ phase 5


def labels_for(torch, gen, batch, ncls):
    cls = torch.randint(0, ncls, (batch,), generator=gen)
    return torch.nn.functional.one_hot(cls, ncls).float().to(DEV)


def twin_of(net, mode, compute_dtype, dtype=None):
    """A fresh ComputationGraph on `net`'s configuration, helper mode
    `mode`, with copies of net's params and BatchNorm states in `dtype`
    (updater state zero, iteration 0)."""
    import copy

    import torch

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    dtype = dtype or torch.float32
    conf = copy.deepcopy(net.conf)
    conf.helper_mode = mode
    twin = ComputationGraph(conf, dtype=dtype, compute_dtype=compute_dtype,
                            device=DEV)
    twin._params = {k: {q: t.detach().to(dtype).clone() for q, t in d.items()}
                    for k, d in net.params.items()}
    twin.states = {k: {q: t.to(dtype).clone() for q, t in d.items()}
                   for k, d in net.states.items()}
    twin._init_updaters()
    return twin


BWD_OUTPUTS = ("dx", "dW", "db", "ds1", "dt1", "dx2", "ds2", "dt2")


def route_errors(torch, pc, args, got, ref):
    """Errors of the kernel backward's outputs `got` against the composed
    backward's `ref` on the same operands `args` (see ROUTE_TOL)."""
    dy, y, dssum, dssq = args[9], args[8], args[10], args[11]
    errs = {}
    for name, a, r in zip(BWD_OUTPUTS, got, ref):
        if (a is None) != (r is None):
            fail(f"routed backward {name}: absent in one route")
        if a is None:
            continue
        r = r.double()
        if name == "db":
            size = pc.ybar_acc(dy, y, dssum, dssq).double().abs().sum(
                (0, 1, 2)).max()
        else:
            size = r.abs().max()
        errs[name] = float((a.double() - r).abs().max()) / max(float(size),
                                                               1e-30)
    return errs


def routed_backward_check(torch, pc, run):
    """`run()` with every 1x1 backward that goes to the dgrad/wgrad
    kernels also computed by the composed backward on the same operands;
    returns the per-call errors (route_errors)."""
    from deeplearning4j_tpu_torch.nn.helpers import fused_ops

    orig, calls = fused_ops._bwd_pallas_1x1, []

    def both(*args):
        got = orig(*args)
        ref = fused_ops._bwd_composed(*args[:13], (1, 1), "VALID", args[13],
                                      int(args[10] is not None), args[14])
        calls.append(route_errors(torch, pc, args, got, ref))
        return got

    fused_ops._bwd_pallas_1x1 = both
    try:
        run()
    finally:
        fused_ops._bwd_pallas_1x1 = orig
    return calls


def update_errors(upd, ref):
    """(per_param, overall) errors of one update against another: max
    |update - update_ref| over the parameter's own largest update (floor
    1e-6), and over the largest update in the network."""
    diffs = [float((a - b).abs().max()) for a, b in zip(upd, ref)]
    sizes = [float(b.abs().max()) for b in ref]
    return (max(d / max(z, 1e-6) for d, z in zip(diffs, sizes)),
            max(diffs) / max(sizes))


def step_check(torch, np, pc, net):
    """One fit_batch on the same weights and batch of BATCH images under
    "pallas" and "fused", in f32 (TF32 off) and bf16: the "pallas" step's
    routed 1x1 backwards against the composed backward on their operands
    (ROUTE_TOL), and the two steps' losses and updates (STEP_TOL)."""
    from deeplearning4j_tpu_torch.util.tree import leaves

    gen = torch.Generator().manual_seed(21)
    x = torch.from_numpy(serving_inputs(np, np.random.default_rng(21),
                                        BATCH)).to(DEV)
    y = labels_for(torch, gen, BATCH, net.conf.node("output").obj.n_out)
    p0 = [t.detach().double() for t in leaves(net.params)]

    def step(mode, compute_dtype):
        twin = twin_of(net, mode, compute_dtype)
        loss = float(twin.fit_batch(([x], [y])))
        upd = [t.double() - t0 for t, t0 in zip(leaves(twin.params), p0)]
        del twin
        torch.cuda.empty_cache()
        if not np.isfinite(loss):
            fail(f"step check {mode}: non-finite loss {loss}")
        return loss, upd

    res = {}
    for cd in (None, torch.bfloat16):
        dtype = "float32" if cd is None else "bfloat16"
        got = {}
        routes = routed_backward_check(
            torch, pc, lambda: got.update(pallas=step("pallas", cd)))
        (lp, up), (lf, uf) = got["pallas"], step("fused", cd)
        worst = {k: max(c[k] for c in routes if k in c)
                 for k in BWD_OUTPUTS if any(k in c for c in routes)}
        gap = abs(lp - lf) / abs(lf)
        per_param, overall = update_errors(up, uf)
        r = {"routed_calls": len(routes), "route_worst": worst,
             "loss_pallas": lp, "loss_fused": lf, "loss_gap": gap,
             "update_per_param": per_param, "update_overall": overall}
        log(f"step check {dtype}, batch {BATCH}: {len(routes)} routed 1x1 "
            f"backwards against the composed backward, worst " + " ".join(
                f"{k}={v:.2e}" for k, v in worst.items())
            + f" (limit {ROUTE_TOL[dtype]:.3g}); pallas vs fused: loss "
            f"{lp:.7f} vs {lf:.7f}, relative gap {gap:.3e} (limit "
            f"{STEP_TOL[dtype]['loss']:g}); update error per parameter "
            f"{per_param:.3e}, overall {overall:.3e} (limit "
            f"{STEP_TOL[dtype].get('overall', 'none')})")
        ok = (len(routes) == 30 and max(worst.values()) <= ROUTE_TOL[dtype]
              and gap <= STEP_TOL[dtype]["loss"]
              and overall <= STEP_TOL[dtype].get("overall", float("inf")))
        if not ok:
            fail(f"step check {dtype}: the pallas train step departs from "
                 f"the composed backward or from fused beyond the limits")
        res[dtype] = r
    return res


def profile_steps(torch, step):
    """`engine_profile` over PROFILE_STEPS calls of `step`."""
    return engine_profile(torch, lambda: [step() for _ in range(PROFILE_STEPS)],
                          PROFILE_STEPS)


def training_run(torch, np, pc, ResNet50):
    """ResNet-50 at TRAIN_BATCH, bf16, nesterovs lr 1e-2 (the flagship
    configuration), one fixed seeded batch: TRAIN_WARMUP steps, then
    TRAIN_STEPS steps timed with CUDA events, under "pallas" and then
    "fused" (cuDNN convolutions). Returns the measurements and the
    "pallas" net (for recording its kernel calls)."""
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(TRAIN_BATCH, HW, HW, 3, generator=gen).to(DEV)
    res, keep = {}, None
    for mode in ("pallas", "fused"):
        net = ResNet50(input_shape=(HW, HW, 3), compute_dtype="bfloat16",
                       helpers=mode).init_model(device=DEV)
        y = labels_for(torch, torch.Generator().manual_seed(32), TRAIN_BATCH,
                       net.conf.node("output").obj.n_out)
        losses = [net.fit_batch(([x], [y])) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pc.reset_launch_counts()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(TRAIN_STEPS + 1)]
        t0 = time.perf_counter()
        events[0].record()
        for i in range(TRAIN_STEPS):
            losses.append(net.fit_batch(([x], [y])))
            events[i + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(pc.LAUNCHES)
        routes = {k: dict(v) for k, v in {**pc.FORWARD_ROUTES,
                                          **pc.BACKWARD_ROUTES}.items()}
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(TRAIN_STEPS)]
        vals = [float(v) for v in losses]
        r = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
             "ms_per_step": float(np.mean(step_ms)),
             "ms_per_step_min": float(np.min(step_ms)),
             "ms_per_step_max": float(np.max(step_ms)),
             "img_per_s": TRAIN_BATCH * TRAIN_STEPS / (sum(step_ms) / 1e3),
             "host_img_per_s": TRAIN_BATCH * TRAIN_STEPS / wall,
             "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches_per_step": {k: v / TRAIN_STEPS
                                   for k, v in counts.items()},
             "launches": counts, "kernel_routes": routes,
             "loss_first": vals[0], "loss_last": vals[-1],
             "losses": vals}
        res[mode] = r
        log(f"train {mode}: batch {TRAIN_BATCH}, {TRAIN_STEPS} steps after "
            f"{TRAIN_WARMUP} warm-up: {r['img_per_s']:.1f} img/s, "
            f"{r['ms_per_step']:.2f} ms/step (CUDA events; min "
            f"{r['ms_per_step_min']:.2f}, max {r['ms_per_step_max']:.2f}), "
            f"host {r['host_img_per_s']:.1f} img/s, peak memory "
            f"{r['max_memory_gib']:.2f} GiB, launches per step "
            f"{r['launches_per_step']}, kernel routes {routes}, loss "
            f"{vals[0]:.4f} -> {vals[-1]:.4f}")
        if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
            fail(f"train {mode}: loss not finite and falling: {vals}")
        want = ({"fused_conv1x1": 30, "fused_conv3x3": 16,
                 "dgrad_conv1x1": 30, "wgrad_conv1x1": 30}
                if mode == "pallas" else {k: 0 for k in counts})
        if counts != {k: v * TRAIN_STEPS for k, v in want.items()}:
            fail(f"train {mode}: launches {counts} != {want} per step x "
                 f"{TRAIN_STEPS}")
        # every bf16 kernel call of the step runs on the Hopper design
        for name in want:
            if routes[name] != {"wgmma": want[name] * TRAIN_STEPS,
                                "simple": 0}:
                fail(f"train {mode}: {name} routes {routes[name]}: not "
                     f"every call took the wgmma route")
        if mode == "pallas":
            prof = profile_steps(torch, lambda: net.fit_batch(([x], [y])))
            prof["idle_share"] = 1.0 - prof["busy_ms"] / r["ms_per_step"]
            r["profile"] = prof
            log(f"train {mode} profile of {PROFILE_STEPS} steps: device busy "
                f"{prof['busy_ms']:.2f} ms per step against "
                f"{r['ms_per_step']:.2f} ms/step unprofiled: idle share "
                f"{prof['idle_share']:.4f} (a profiled step takes "
                f"{prof['profiled_wall_ms']:.1f} ms); top kernels (ms per "
                f"step): " + ", ".join(f"{n} {t:.2f}" for n, t in prof["top"]))
            keep = net
        else:
            del net
        torch.cuda.empty_cache()
    res["pallas_over_fused_ms"] = (res["pallas"]["ms_per_step"]
                                   / res["fused"]["ms_per_step"])
    return res, keep, x


# ------------------------------------------------------------ phase 5b


def train_state(net):
    """Every tensor a train step mutates: params, updater state, BN
    states (reading params drops a net's flat carry; fine at a check)."""
    from deeplearning4j_tpu_torch.util.tree import leaves

    return (leaves(net.params) + leaves(net.updater_states)
            + leaves(net.states))


def bits_equal(torch, a, b):
    """a and b hold the same bits (NaNs included)."""
    raw = lambda t: t.detach().contiguous().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        raw(a), raw(b))


def same_bits(torch, a, b):
    """(equal, tensors compared, tensors that differ) of two nets'
    train states."""
    sa, sb = train_state(a), train_state(b)
    diff = sum(1 for x, y in zip(sa, sb) if not bits_equal(torch, x, y))
    return len(sa) == len(sb) and diff == 0, len(sa), diff


def engine_batches(np, seed, n, batch, ncls, hw=None):
    """n seeded host batches (x f32 NHWC of `hw`-sized images, default HW;
    one-hot y)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = serving_inputs(np, rng, batch, hw)
        y = np.eye(ncls, dtype=np.float32)[rng.integers(0, ncls, batch)]
        out.append((x, y))
    return out


def flagship(ResNet50, mode):
    """The flagship of bench.py:72 at full width: ResNet-50, 224x224x3,
    1000 classes, bf16 policy, nesterovs lr 1e-2; seeded init."""
    return ResNet50(input_shape=(HW, HW, 3), compute_dtype="bfloat16",
                    helpers=mode).init_model(device=DEV)


def group_check(torch, np, ResNet50):
    """From one seeded state at ENGINE_CHECK_BATCH, on GROUP_K seeded
    batches: GROUP_K eager StepProgram.run calls against one
    run_group(GROUP_K) replay, then a second replay after restoring a
    guard snapshot — params, updater state, BN states and the losses bit
    for bit. First two eager runs from the same state must agree; where
    cuDNN's default algorithms make them differ, cudnn.deterministic is
    set for the bitwise checks (returned as `deterministic`)."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard

    data = engine_batches(np, 41, GROUP_K, ENGINE_CHECK_BATCH, 1000)
    xs = np.stack([d[0] for d in data])
    ys = np.stack([d[1] for d in data])

    def eager():
        net = flagship(ResNet50, "pallas")
        prog = StepProgram(net)
        losses = torch.stack([prog.run(x, y) for x, y in data])
        return net, losses

    res = {"deterministic": False}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        e1, l1 = eager()
        e2, l2 = eager()
        torch.cuda.synchronize()
        same, n, diff = same_bits(torch, e1, e2)
        same = same and bits_equal(torch, l1, l2)
        log(f"engine group check: two eager runs of {GROUP_K} steps from "
            f"one seeded state (batch {ENGINE_CHECK_BATCH}, "
            f"cudnn.deterministic={det}): {n} tensors, {diff} differ, "
            f"losses equal {bits_equal(torch, l1, l2)}")
        del e2
        if same:
            res["deterministic"] = det
            break
        if det:
            fail("engine group check: two eager runs from one state differ "
                 "even with cudnn.deterministic")
        log("engine group check: cuDNN's default algorithms are not "
            "bitwise repeatable here; cudnn.deterministic=True for the "
            "engine's bitwise checks only")
        del e1
        torch.cuda.empty_cache()
    g = flagship(ResNet50, "pallas")
    prog = StepProgram(g)
    guard = NonFiniteGuard("skip_step")
    snap = guard.snapshot(g)
    for attempt in ("first replay", "replay after a snapshot restore"):
        if attempt != "first replay":
            guard.restore(g, snap)
        prog.run_group(xs, ys)
        torch.cuda.synchronize()
        same, n, diff = same_bits(torch, e1, g)
        losses_equal = bits_equal(torch, l1, prog.last_step_losses)
        log(f"engine group check, {attempt}: run_group({GROUP_K}) against "
            f"{GROUP_K} eager run() calls: {n} tensors (params, updater "
            f"state, BN states), {diff} differ; losses "
            f"{[float(v) for v in prog.last_step_losses]} equal "
            f"{losses_equal}; iteration {g.iteration}")
        if not (same and losses_equal and g.iteration == GROUP_K):
            fail(f"engine group check ({attempt}): run_group differs from "
                 f"eager steps")
    res.update(tensors=n, captures=prog.group_stats["captures"],
               capture_s=prog.group_stats["capture_s"],
               losses=[float(v) for v in l1])
    if prog.group_stats["captures"] != 1:
        fail("engine group check: the restore forced a recapture")
    del e1, g, prog, snap
    torch.cuda.empty_cache()
    return res


def engine_profile(torch, fn, steps):
    """torch.profiler over `fn()` (advancing `steps` train steps): the
    device's busy ms per step (the sum of the kernels' device times; the
    port runs on one stream, so kernels do not overlap; None when the
    profiler saw no device time), the kernels that take the most device
    time per step, and the profiled wall ms per step. The profiler
    stretches the host's side of a step, so an idle share is taken
    against an unprofiled step's time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only: an operator's own "device time" repeats
    # the time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev(e) > 0]
    top = sorted(kernels, key=dev, reverse=True)[:PROFILE_TOP]
    busy = sum(dev(e) for e in kernels) / 1e3 / steps
    return {"profiled_wall_ms": wall * 1e3 / steps,
            "busy_ms": busy if busy > 0 else None,
            "top": [(e.key[:60], dev(e) / 1e3 / steps) for e in top]}


def timed_steps(torch, prog, kind, call, *, steps, warmup, batch, macs,
                profile_steps, on_start=None, on_end=None):
    """One net's `call` (prog.run, or prog.run_group of GROUP_K steps when
    `kind` is "group"): `warmup` calls (for a group one, which captures),
    then `steps` steps timed by CUDA events around each call, then a
    torch.profiler window. Returns (result, per-step losses): ms/step,
    img/s, host img/s, peak memory allocated and reserved (a captured
    graph's pool is reserved, not allocated), MFU from `macs` per image
    (one FLOP per multiply-add; "mfu_2flops" at two), the device's busy
    ms per step and idle share, and for a group its capture s.
    `on_start()` runs just before the timed calls and `on_end()` just
    after them (before the profiler); on_end's dict joins the result."""
    per_call = GROUP_K if kind == "group" else 1
    calls = steps // per_call
    losses = []

    def record():
        losses.extend(prog.last_step_losses if kind == "group"
                      else [prog.net._score])

    for _ in range(warmup):
        call()
        record()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if on_start is not None:
        on_start()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(calls):
        call()
        record()
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = {} if on_end is None else on_end()
    ms = sum(events[i].elapsed_time(events[i + 1])
             for i in range(calls)) / steps
    img_s = batch / ms * 1e3
    r.update(steps=steps, calls=calls, ms_per_step=ms, img_per_s=img_s,
             host_img_per_s=batch * steps / wall,
             max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             max_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
             mfu=img_s * 3 * macs / BF16_FLOPS_PER_S)
    r["mfu_2flops"] = 2 * r["mfu"]
    if kind == "group":
        r["capture_s"] = prog.group_stats["capture_s"]
    n_prof = max(1, profile_steps // per_call)
    prof = engine_profile(torch, lambda: [call() for _ in range(n_prof)],
                          n_prof * per_call)
    busy = r["busy_ms"] = prof["busy_ms"]
    r["top_kernels"] = prof["top"]
    r["idle_share"] = None if busy is None else 1.0 - busy / ms
    return r, losses


def timed_line(r, kind, batch, steps):
    """The common part of a timed run's log line."""
    busy = r["busy_ms"]
    return (f" {kind}" + (f"({GROUP_K})" if kind == "group" else "")
            + f": batch {batch}, {steps} steps ({r['calls']} calls) after "
            f"warm-up: {r['ms_per_step']:.2f} ms/step (CUDA events), "
            f"{r['img_per_s']:.1f} img/s, host {r['host_img_per_s']:.1f} "
            f"img/s, peak memory {r['max_memory_gib']:.2f} GiB allocated, "
            f"{r['max_reserved_gib']:.2f} GiB reserved (a graph's pool "
            "included), device busy "
            + ("not measured" if busy is None else f"{busy:.2f}")
            + " ms per step, idle share "
            + ("not measured" if busy is None else f"{r['idle_share']:.4f}")
            + f", MFU {r['mfu']:.4f} counting a multiply-add as one FLOP, "
            f"{r['mfu_2flops']:.4f} at two"
            + (f", capture {r['capture_s']:.2f} s (outside the window)"
               if kind == "group" else ""))


def engine_timed(torch, np, pc, ResNet50, mode):
    """StepProgram.run (k=1) and run_group(GROUP_K) under `mode`, each for
    ENGINE_STEPS steps on one fixed seeded batch of TRAIN_BATCH after
    warm-up (and, for the group, capture), on one net: `timed_steps`'
    readings (MFU from the net's layer-shape multiply-adds) and the kernel
    launches per step."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    # the batch lives on the card, as the input pipeline stages it
    ((x, y),) = [(torch.from_numpy(a).to(DEV), torch.from_numpy(b).to(DEV))
                 for a, b in engine_batches(np, 43, 1, TRAIN_BATCH, 1000)]
    net = flagship(ResNet50, mode)
    prog = StepProgram(net)
    xs, ys = torch.stack([x] * GROUP_K), torch.stack([y] * GROUP_K)
    want = ({"fused_conv1x1": 30, "fused_conv3x3": 16, "dgrad_conv1x1": 30,
             "wgrad_conv1x1": 30} if mode == "pallas"
            else {k: 0 for k in pc.LAUNCHES})

    def launches():
        counts = pc.launch_counts()
        return {"launches_per_step": {k: counts[k] / ENGINE_STEPS
                                      for k in pc.LAUNCHES},
                "launches": {k: counts[k] for k in pc.LAUNCHES},
                "counts": counts}

    out, losses = {}, []
    macs = macs_per_image(net)
    for kind in ("run", "group"):
        call = (lambda: prog.run(x, y)) if kind == "run" \
            else (lambda: prog.run_group(xs, ys))
        r, ls = timed_steps(
            torch, prog, kind, call, steps=ENGINE_STEPS,
            warmup=ENGINE_WARMUP if kind == "run" else 1,
            batch=TRAIN_BATCH, macs=macs,
            profile_steps=ENGINE_PROFILE_STEPS,
            on_start=pc.reset_launch_counts, on_end=launches)
        losses.extend(ls)
        counts = r.pop("counts")
        if kind == "group":
            (per_replay,) = prog.group_launches().values() or ({},)
            r["launches_per_replay"] = {k: v for k, v in per_replay.items()
                                        if "/" not in k}
        out[kind] = r
        log(f"engine {mode}" + timed_line(r, kind, TRAIN_BATCH, ENGINE_STEPS)
            + f" (at {macs:.4e} multiply-adds per image, "
            f"the layer shapes'); launches per step "
            f"{r['launches_per_step']}")
        if any(counts[k] != v * ENGINE_STEPS for k, v in want.items()):
            fail(f"engine {mode} {kind}: launches {counts} != {want} per "
                 f"step x {ENGINE_STEPS}")
        for name, n in want.items():
            if n and counts[f"{name}/wgmma"] != n * ENGINE_STEPS:
                fail(f"engine {mode} {kind}: {name} did not take the wgmma "
                     f"route on every call ({counts})")
    vals = [float(v) for v in losses]
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"engine {mode}: loss not finite and falling: {vals}")
    out["loss_first"], out["loss_last"] = vals[0], vals[-1]
    log(f"engine {mode}: loss {vals[0]:.4f} -> {vals[-1]:.4f} over "
        f"{len(vals)} steps")
    del net, prog
    torch.cuda.empty_cache()
    return out


def view_score_reading(torch, net, batch):
    """`ComputationGraph.score(data)` reads views of the live flat carry:
    the eval-mode loss on `batch` over those views against the loss over
    copies of them (the operands a reloaded net has), the first vertex
    whose activation differs, and how many views, and that vertex's
    params, do not start on a 16-byte boundary (fresh allocations start
    on a 512-byte one)."""
    from deeplearning4j_tpu_torch.util.tree import clone, leaves

    views = net._params_view()
    inputs, labels, lmasks, _ = net._batch_tensors([batch[0]], [batch[1]])
    out = {"views_not_16B_aligned": sum(
        1 for t in leaves(views) if t.data_ptr() % 16),
        "views": len(leaves(views))}
    acts = {}
    with torch.no_grad():
        for name, params in (("views", views), ("copies", clone(views))):
            loss, _ = net._loss_fn(params, net.states, inputs, labels,
                                   lmasks, train=False)
            out[f"loss_{name}"] = float(loss)
            acts[name] = net._forward(params, net.states, inputs,
                                      materialize_all=True)[0]
    first = next((n.name for n in net.topo if n.name in acts["views"]
                  and not torch.equal(acts["views"][n.name],
                                      acts["copies"][n.name])), None)
    out["first_differing_vertex"] = first
    if first is not None:
        node = net.conf.node(first)
        out["vertex_kind"] = type(node.obj).__name__
        out["vertex_inputs"] = list(node.inputs)
        out["vertex_param_offsets_mod_16B"] = [
            t.data_ptr() % 16 for t in leaves(views.get(first) or {})]
    log(f"engine score on the flat carry's views against per-layer copies "
        f"(f32, eval mode, batch {len(batch[0])}): {out}")
    return out


def early_stopping_check(torch, np, ResNet50, tmp):
    """EarlyStoppingTrainer end to end on the flagship: ES_BATCHES seeded
    host batches of TRAIN_BATCH through a ListDataSetIterator and the
    input pipeline, DataSetLossCalculator on a held-out batch,
    MaxEpochsTerminationCondition(ES_EPOCHS), NonFiniteGuard("skip_step",
    check_every=1), LocalFileGraphSaver. The best model must verify and,
    reloaded on the same device and compute dtype, score exactly its
    recorded score. Then one batch's features set to NaN: skipped once per
    epoch, ending bit for bit where a run over the clean batches ends."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        InMemoryModelSaver,
        LocalFileGraphSaver,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.observability import metrics as obs
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard
    from deeplearning4j_tpu_torch.util.model_serializer import verify_model

    data = engine_batches(np, 45, ES_BATCHES, TRAIN_BATCH, 1000)
    held = engine_batches(np, 46, 1, TRAIN_BATCH, 1000)
    x_all = np.concatenate([d[0] for d in data])
    y_all = np.concatenate([d[1] for d in data])

    def fit(x, y, saver):
        net = flagship(ResNet50, "pallas")
        guard = NonFiniteGuard("skip_step", check_every=1)
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                MaxEpochsTerminationCondition(ES_EPOCHS)],
            model_saver=saver, score_calculator=DataSetLossCalculator(held))
        trainer = EarlyStoppingTrainer(
            cfg, net, ListDataSetIterator(DataSet(x, y),
                                          batch_size=TRAIN_BATCH),
            guard=guard)
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        return net, guard, trainer, result, time.perf_counter() - t0

    def wait_buckets():
        h = obs.get_registry().snapshot()["histograms"].get(
            "dl4j_pipeline_wait_seconds")
        return {} if h is None else h["buckets"]

    res = {}
    before = wait_buckets()
    net, guard, trainer, result, secs = fit(x_all, y_all,
                                            LocalFileGraphSaver(tmp))
    pipe = trainer._harness.pipeline_stats()
    # batches per wait bucket (upper bound in s) of this run
    waits = {b: n - before.get(b, 0) for b, n in wait_buckets().items()
             if n != before.get(b, 0)}
    best = result.best_model
    path = os.path.join(tmp, "bestModel.zip")
    rescored = best.score(held[0])
    recorded = result.score_vs_epoch[result.best_model_epoch]
    res["trainer"] = {
        "seconds": secs, "epochs": result.total_epochs,
        "score_vs_epoch": result.score_vs_epoch,
        "best_epoch": result.best_model_epoch, "rescored": rescored,
        "verified": verify_model(path), "iteration": net.iteration,
        "pipeline_batches": pipe["batches"],
        "pipeline_wait_ms_per_batch": pipe["wait_s"] * 1e3 / pipe["batches"],
        "pipeline_waits_by_bucket_s": waits,
        "guard": guard.stats()}
    log(f"engine early stopping: {result.total_epochs} epochs of "
        f"{ES_BATCHES} batches of {TRAIN_BATCH} in {secs:.1f} s, "
        f"{result.termination_reason}; score per epoch "
        f"{result.score_vs_epoch}; best epoch {result.best_model_epoch}, "
        f"{os.path.getsize(path)} bytes, verify_model "
        f"{res['trainer']['verified']}, reloaded score {rescored!r} against "
        f"recorded {recorded!r}; pipeline {pipe['batches']} batches, wait "
        f"{res['trainer']['pipeline_wait_ms_per_batch']:.3f} ms per batch "
        f"(batches per wait bucket, upper bound in s: {waits}; a pass "
        f"starts its producer anew each epoch); "
        f"guard {guard.stats()}")
    if not (result.total_epochs == ES_EPOCHS and res["trainer"]["verified"]
            and rescored == recorded and net.iteration
            == ES_EPOCHS * ES_BATCHES and best.device == net.device
            and best.compute_dtype == net.compute_dtype):
        fail("engine early stopping: the trainer did not run to its end, or "
             "the best model does not verify and rescore exactly")
    if net._flat_train is not None:
        res["view_score"] = view_score_reading(torch, net, held[0])
    del net, best, trainer, result
    torch.cuda.empty_cache()
    bad = x_all.copy()
    bad[2 * TRAIN_BATCH:3 * TRAIN_BATCH] = np.nan
    keep = np.r_[0:2 * TRAIN_BATCH, 3 * TRAIN_BATCH:len(x_all)]
    poisoned, pguard, _, presult, _ = fit(bad, y_all, InMemoryModelSaver())
    clean, _, _, cresult, _ = fit(x_all[keep], y_all[keep],
                                  InMemoryModelSaver())
    same, n, diff = same_bits(torch, poisoned, clean)
    res["poisoned"] = {"guard": pguard.stats(), "tensors": n, "differ": diff,
                       "score_vs_epoch": presult.score_vs_epoch,
                       "clean_score_vs_epoch": cresult.score_vs_epoch}
    log(f"engine early stopping with batch 3 of {ES_BATCHES} poisoned (NaN "
        f"features): guard {pguard.stats()}; against a run over the "
        f"{ES_BATCHES - 1} clean batches: {n} tensors, {diff} differ, "
        f"scores {presult.score_vs_epoch} vs {cresult.score_vs_epoch}")
    if not (same and pguard.counters["skipped_steps"] == ES_EPOCHS
            and presult.score_vs_epoch == cresult.score_vs_epoch):
        fail("engine early stopping: the poisoned run did not skip its NaN "
             "batch once per epoch or does not end where the clean run ends")
    del poisoned, clean
    torch.cuda.empty_cache()
    return res


def engine_phase(torch, np, pc, ResNet50, card):
    """Phase 5b: the training engine on the flagship (see the module
    docstring). The bitwise checks run with the cuDNN setting the group
    check found repeatable; the timed runs with PyTorch's default.
    `card`: nvidia-smi's name and power limit, printed beside the
    numbers."""
    import tempfile

    res = {"card": card, "group_check": group_check(torch, np, ResNet50)}
    det = res["group_check"]["deterministic"]
    torch.backends.cudnn.deterministic = False
    for mode in ("pallas", "fused"):
        res[mode] = engine_timed(torch, np, pc, ResNet50, mode)
    cells = [f"{m} {k}: {res[m][k]['ms_per_step']:.2f}, "
             f"{res[m][k]['img_per_s']:.1f}, {res[m][k]['idle_share']}, "
             f"{res[m][k]['mfu']:.4f}"
             for m in ("pallas", "fused") for k in ("run", "group")]
    ratios = [f"{m} group over run "
              f"{res[m]['group']['ms_per_step'] / res[m]['run']['ms_per_step']:.4f}"
              for m in ("pallas", "fused")]
    log(f"engine summary on {card} (ms/step, img/s, idle share, MFU "
        "counting multiply-adds): "
        + "; ".join(cells + ratios))
    torch.backends.cudnn.deterministic = det
    with tempfile.TemporaryDirectory() as tmp:
        res["early_stopping"] = early_stopping_check(torch, np, ResNet50, tmp)
    torch.backends.cudnn.deterministic = False
    return res


# ------------------------------------------------------------ phase 5c


def vgg16(VGG16, compute_dtype="bfloat16"):
    """The zoo's full-width VGG16 (224x224x3, 1000 classes, dropout 0.5 on
    both 4096-wide dense layers' inputs, nesterovs; bench.py:506
    bench_vgg16's model) at VGG16_LR, seeded random weights, as a
    MultiLayerNetwork."""
    return VGG16(input_shape=(HW, HW, 3), learning_rate=VGG16_LR,
                 compute_dtype=compute_dtype).init_model(device=DEV)


def macs_per_image(net):
    """Multiply-adds of one image's forward, from the layer shapes:
    out_h * out_w * kh * kw * c_in * c_out per convolution, n_in * n_out
    per dense and output layer (a layer list's layers, or a graph's layer
    nodes)."""
    total = 0
    pairs = ([(n.obj, net._layer_in_types[n.name]) for n in net.topo
              if n.kind == "layer"]
             if hasattr(net.conf, "network_inputs")
             else zip(net.conf.layers, net.layer_input_types))
    for layer, t in pairs:
        kind = type(layer).__name__
        if kind == "ConvolutionLayer":
            o = layer.output_type(t)
            kh, kw = layer.kernel_size
            total += o.height * o.width * kh * kw * t.channels * o.channels
        elif kind in ("DenseLayer", "OutputLayer"):
            total += layer.n_in * layer.n_out
    return total


def mln_batches(np, seed, n, batch, ncls=1000):
    """n seeded host batches of images scaled by MLN_INPUT_SCALE and
    one-hot labels."""
    return [(x * np.float32(MLN_INPUT_SCALE), y)
            for x, y in engine_batches(np, seed, n, batch, ncls)]


def mln_batch(torch, np, seed, batch, ncls=1000):
    """One seeded batch on the card, as the input pipeline stages it."""
    ((x, y),) = mln_batches(np, seed, 1, batch, ncls)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV)


def mln_inference(torch, np, MultiLayerNetwork, net):
    """VGG16's `output` at MLN_BATCH timed by CUDA events; its log-probs
    against the f32 torch path (the same params, compute_dtype None, TF32
    off); then a few requests through ParallelInference, each against a
    direct `output` of its rows."""
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    x, _ = mln_batch(torch, np, 71, MLN_BATCH)
    for _ in range(3):
        out = net.output(x)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(MLN_OUTPUT_CALLS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(MLN_OUTPUT_CALLS):
        out = net.output(x)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / MLN_OUTPUT_CALLS
    ms = [events[i].elapsed_time(events[i + 1])
          for i in range(MLN_OUTPUT_CALLS)]
    f32 = MultiLayerNetwork(net.conf, device=DEV)
    f32.params, f32.states = net.params, net.states
    ref = f32.output(x)
    got = out.cpu().numpy()
    if got.shape != (MLN_BATCH, 1000) or not np.isfinite(got).all():
        fail(f"mln: VGG16 output {got.shape} not finite of shape "
             f"({MLN_BATCH}, 1000)")
    gap = logp_gap(np, got, ref.cpu().numpy())
    res = {"output_ms": float(np.mean(ms)), "output_ms_min": min(ms),
           "output_ms_max": max(ms), "output_host_ms": host_ms,
           "bf16_vs_f32_logp_gap": gap}
    del f32, ref
    rng = np.random.default_rng(72)
    reqs = [serving_inputs(np, rng, s) * np.float32(MLN_INPUT_SCALE)
            for s in MLN_SERVE_SIZES]
    pi = ParallelInference(net, batch_limit=MLN_BATCH, queue_limit=64,
                           default_timeout_s=300.0, max_wait_ms=2.0)
    errors, served = [], [None] * len(reqs)

    def client(i):
        try:
            served[i] = pi.output(reqs[i])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    try:
        warmed = pi.stats()["warmed_buckets"]
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = pi.stats()
    finally:
        pi.shutdown()
    if errors:
        fail(f"mln: ParallelInference raised {errors[0]!r}")
    worst = 0.0
    for r, s in zip(reqs, served):
        direct = net.output(r).cpu().numpy()
        if s.shape != direct.shape or not np.isfinite(s).all():
            fail(f"mln: served response {s.shape} != {direct.shape}")
        worst = max(worst, logp_gap(np, s, direct))
    res.update(served_requests=len(reqs), served_logp_gap=worst,
               warmed_buckets=warmed, batches=st["batches_dispatched"])
    log(f"mln inference: VGG16 output at batch {MLN_BATCH}, bf16 policy: "
        f"{res['output_ms']:.3f} ms per call (CUDA events, mean of "
        f"{MLN_OUTPUT_CALLS}; min {res['output_ms_min']:.3f}, max "
        f"{res['output_ms_max']:.3f}; host {host_ms:.3f} ms), "
        f"{MLN_BATCH / res['output_ms'] * 1e3:.1f} img/s; max |log p gap| "
        f"against the f32 torch path {gap:.4e} (limit "
        f"{MLN_LOGP_TOL['bf16_vs_f32']:g}); ParallelInference: "
        f"{len(reqs)} requests of {MLN_SERVE_SIZES} rows in "
        f"{st['batches_dispatched']} batches (warmed {warmed}), max |log p "
        f"gap| against direct output {worst:.4e} (limit "
        f"{MLN_LOGP_TOL['served']:g})")
    if gap > MLN_LOGP_TOL["bf16_vs_f32"] or worst > MLN_LOGP_TOL["served"]:
        fail("mln: VGG16 log-probs outside their limits")
    return res


def mln_timed(torch, np, VGG16, card):
    """StepProgram.run (eager) and run_group(GROUP_K) (one CUDA-graph
    replay) on one VGG16 with dropout on, each for MLN_STEPS steps on one
    fixed batch of MLN_BATCH after warm-up (and capture): `timed_steps`'
    readings with MFU from VGG16's multiply-adds. Then a second k
    (2 * GROUP_K) captures into the program's one graph pool, a window of
    GROUP_K // 2 steps runs eagerly, and the reserved memory of two
    groups in one pool is read against two pools."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    x, y = mln_batch(torch, np, 73, MLN_BATCH)
    net = vgg16(VGG16)
    macs = macs_per_image(net)
    if not net._has_dropout():
        fail("mln: VGG16 has no dropout")
    prog = StepProgram(net)
    xs, ys = torch.stack([x] * GROUP_K), torch.stack([y] * GROUP_K)
    out, losses = {"macs_per_image": macs, "card": card}, []
    for kind in ("run", "group"):
        call = (lambda: prog.run(x, y)) if kind == "run" \
            else (lambda: prog.run_group(xs, ys))
        r, ls = timed_steps(
            torch, prog, kind, call, steps=MLN_STEPS,
            warmup=MLN_WARMUP if kind == "run" else 1, batch=MLN_BATCH,
            macs=macs, profile_steps=MLN_PROFILE_STEPS)
        losses.extend(ls)
        out[kind] = r
        log("mln VGG16" + timed_line(r, kind, MLN_BATCH, MLN_STEPS)
            + f" ({macs / 1e9:.3f}e9 multiply-adds per image); bf16, "
            f"dropout on [{card}]; top kernels (ms per step): "
            + ", ".join(f"{n} {t:.3f}" for n, t in r["top_kernels"]))
    vals = [float(v) for v in losses]
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"mln VGG16: loss not finite and falling: {vals}")
    out["loss_first"], out["loss_last"] = vals[0], vals[-1]
    log(f"mln VGG16: loss {vals[0]:.4f} -> {vals[-1]:.4f} over {len(vals)} "
        "recorded steps")
    # F2: one graph pool per StepProgram
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    k2 = 2 * GROUP_K
    prog.run_group(torch.stack([x] * k2), torch.stack([y] * k2))
    half = GROUP_K // 2
    prog.run_group(torch.stack([x] * half), torch.stack([y] * half))
    torch.cuda.synchronize()
    pools = {g.graph.pool() for g in prog._groups.values()}
    out["pool"] = {"groups": len(prog._groups), "pools": len(pools),
                   "captures": prog.group_stats["captures"],
                   "eager_windows": prog.group_stats["eager_windows"],
                   "reserved_gib_before": reserved,
                   "reserved_gib_after": torch.cuda.memory_reserved()
                   / 2 ** 30}
    log(f"mln VGG16 graph pool: after run_group({k2}) and "
        f"run_group({half}): {out['pool']}")
    if not (len(prog._groups) == 2 and len(pools) == 1
            and prog.group_stats["eager_windows"] == 1):
        fail("mln: the second k did not capture into the program's one "
             "pool, or the shorter window did not run eagerly")
    # what sharing saves: the two groups (k=GROUP_K, then k2) in one
    # program's pool against the same two in two programs (a pool each,
    # as every group had one before), reserved memory from an emptied
    # cache, on the same net
    del prog
    grow = {}
    for how in ("one pool", "two pools"):
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        progs = [StepProgram(net)]
        if how == "two pools":
            progs.append(StepProgram(net))
        for p, k in zip(progs * 2, (GROUP_K, k2)):
            p.run_group(torch.stack([x] * k), torch.stack([y] * k))
        torch.cuda.synchronize()
        grow[how] = (torch.cuda.memory_reserved() - r0) / 2 ** 30
        del progs, p
    out["pool"]["reserved_growth_gib"] = grow
    log(f"mln VGG16 graph pools: reserved memory grows {grow['one pool']:.3f}"
        f" GiB for run_group({GROUP_K}) and run_group({k2}) in one program "
        f"(one pool) against {grow['two pools']:.3f} GiB in two programs "
        "(a pool each)")
    del net
    torch.cuda.empty_cache()
    return out


def mln_dropout_checks(torch, np, VGG16):
    """Dropout on the card, full-width VGG16 at MLN_CHECK_BATCH: from one
    generator state, GROUP_K eager run() calls against one
    run_group(GROUP_K) replay (params, updater state, losses and the
    generator's state bit for bit); two consecutive replays from the same
    carry draw different masks (their losses differ) unless the
    generator is rewound too (then equal); a guard's skip of a NaN batch
    ends where the run without that batch ends, bit for bit."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard
    from deeplearning4j_tpu_torch.util.tree import clone

    data = mln_batches(np, 74, GROUP_K, MLN_CHECK_BATCH)
    xs = np.stack([d[0] for d in data])
    ys = np.stack([d[1] for d in data])

    def eager():
        net = vgg16(VGG16)
        prog = StepProgram(net)
        return net, torch.stack([prog.run(x, y) for x, y in data])

    res = {"deterministic": False}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        e1, l1 = eager()
        e2, l2 = eager()
        torch.cuda.synchronize()
        same, n, diff = same_bits(torch, e1, e2)
        same = same and bits_equal(torch, l1, l2)
        log(f"mln dropout check: two eager runs of {GROUP_K} VGG16 steps "
            f"(batch {MLN_CHECK_BATCH}, cudnn.deterministic={det}): {n} "
            f"tensors, {diff} differ, losses equal {bits_equal(torch, l1, l2)}")
        del e2
        if same:
            res["deterministic"] = det
            break
        if det:
            fail("mln dropout check: two eager runs from one state differ "
                 "even with cudnn.deterministic")
        del e1
        torch.cuda.empty_cache()
    g = vgg16(VGG16)
    prog = StepProgram(g)
    prog.run_group(xs, ys)
    torch.cuda.synchronize()
    same, n, diff = same_bits(torch, e1, g)
    rng_same = bits_equal(torch, e1._rng_state(), g._rng_state())
    losses_equal = bits_equal(torch, l1, prog.last_step_losses)
    log(f"mln dropout check: run_group({GROUP_K}) against {GROUP_K} eager "
        f"run() calls from one generator state: {n} tensors, {diff} differ; "
        f"losses equal {losses_equal}; generator state equal {rng_same}")
    if not (same and losses_equal and rng_same):
        fail("mln dropout check: the replay differs from the eager steps")
    del e1
    guard = NonFiniteGuard("skip_step")
    snap = guard.snapshot(g)
    prog.run_group(xs, ys)
    l_a = prog.last_step_losses.clone()
    g._set_train_carry(clone(snap["carry"]))   # carry back, generator not
    g.iteration = snap["iteration"]
    prog.run_group(xs, ys)
    l_b = prog.last_step_losses.clone()
    guard.restore(g, snap)                     # carry and generator back
    prog.run_group(xs, ys)
    l_c = prog.last_step_losses.clone()
    torch.cuda.synchronize()
    res.update(tensors=n, replay_losses=[float(v) for v in l_a],
               next_replay_losses=[float(v) for v in l_b],
               captures=prog.group_stats["captures"])
    log(f"mln dropout check: consecutive replays from one carry: losses "
        f"{res['replay_losses']} then {res['next_replay_losses']} (new "
        f"masks); with the generator rewound too, equal "
        f"{bits_equal(torch, l_a, l_c)}")
    if bits_equal(torch, l_a, l_b) or not bits_equal(torch, l_a, l_c) \
            or prog.group_stats["captures"] != 1:
        fail("mln dropout check: consecutive replays drew the same masks, "
             "or a rewound replay differs")
    del g, prog, snap
    torch.cuda.empty_cache()

    x_all = np.concatenate([d[0] for d in data])
    y_all = np.concatenate([d[1] for d in data])
    bad = x_all.copy()
    bad[2 * MLN_CHECK_BATCH:3 * MLN_CHECK_BATCH] = np.nan
    keep = np.r_[0:2 * MLN_CHECK_BATCH, 3 * MLN_CHECK_BATCH:len(x_all)]
    held = mln_batches(np, 75, 1, MLN_CHECK_BATCH)

    def fit(x, y):
        net = vgg16(VGG16)
        guard = NonFiniteGuard("skip_step", check_every=1)
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
            model_saver=InMemoryModelSaver(),
            score_calculator=DataSetLossCalculator(held))
        result = EarlyStoppingTrainer(
            cfg, net, ListDataSetIterator(DataSet(x, y),
                                          batch_size=MLN_CHECK_BATCH),
            guard=guard).fit()
        return net, guard, result

    poisoned, pguard, presult = fit(bad, y_all)
    clean, _, cresult = fit(x_all[keep], y_all[keep])
    torch.cuda.synchronize()
    same, n, diff = same_bits(torch, poisoned, clean)
    rng_same = bits_equal(torch, poisoned._rng_state(), clean._rng_state())
    res["poisoned"] = {"guard": pguard.stats(), "tensors": n, "differ": diff,
                       "generator_equal": rng_same,
                       "score_vs_epoch": presult.score_vs_epoch,
                       "clean_score_vs_epoch": cresult.score_vs_epoch}
    log(f"mln dropout check: EarlyStoppingTrainer over {GROUP_K} batches of "
        f"{MLN_CHECK_BATCH}, batch 3 NaN, 2 epochs, dropout on: guard "
        f"{pguard.stats()}; against the 3 clean batches: {n} tensors, {diff} "
        f"differ, generator state equal {rng_same}, scores "
        f"{presult.score_vs_epoch} vs {cresult.score_vs_epoch}")
    if not (same and rng_same and pguard.counters["skipped_steps"] == 2
            and presult.score_vs_epoch == cresult.score_vs_epoch):
        fail("mln dropout check: the guard's skip with dropout on does not "
             "end where the run without the batch ends")
    del poisoned, clean
    torch.cuda.empty_cache()
    return res


def alexnet_check(torch, np, AlexNet):
    """AlexNet (the zoo's: 11x11 stride-4 "same" conv, LRN, dropout 0.5 on
    the dense layers), full width at 224, bf16 policy, nesterovs at
    ALEXNET_LR: ALEXNET_STEPS train steps on one fixed batch of MLN_BATCH,
    with a finite, falling loss."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    x, y = mln_batch(torch, np, 76, MLN_BATCH)
    net = AlexNet(input_shape=(HW, HW, 3), learning_rate=ALEXNET_LR,
                  compute_dtype="bfloat16").init_model(device=DEV)
    prog = StepProgram(net)
    t0 = time.perf_counter()
    vals = [float(prog.run(x, y)) for _ in range(ALEXNET_STEPS)]
    secs = time.perf_counter() - t0
    log(f"mln AlexNet: {net.num_params()} params, batch {MLN_BATCH}, bf16, "
        f"dropout on: loss {vals} over {ALEXNET_STEPS} steps ({secs:.2f} s "
        "with first-call costs)")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"mln AlexNet: loss not finite and falling: {vals}")
    del net, prog
    torch.cuda.empty_cache()
    return {"losses": vals, "seconds": secs}


def mln_phase(torch, np, pc, card):
    """Phase 5c: MultiLayerNetwork on the card (see the module docstring).
    The kernel launch counters are set to 0 before it and read after it:
    no kernel of csrc/ is on the MLN's path (an MLN has no helper tier)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo.models import VGG16, AlexNet

    pc.reset_launch_counts()
    net = vgg16(VGG16)
    log(f"model: VGG16 (MultiLayerNetwork), {net.num_params()} params, "
        f"{len(net.conf.layers)} layers, bf16 policy, dropout "
        f"{[l.dropout for l in net.conf.layers if l.dropout]}")
    res = {"card": card, "params": net.num_params(),
           "inference": mln_inference(torch, np, MultiLayerNetwork, net)}
    del net
    torch.cuda.empty_cache()
    res["train"] = mln_timed(torch, np, VGG16, card)
    res["dropout"] = mln_dropout_checks(torch, np, VGG16)
    torch.backends.cudnn.deterministic = False
    res["alexnet"] = alexnet_check(torch, np, AlexNet)
    res["launches"] = {k: pc.LAUNCHES[k] for k in pc.LAUNCHES
                       if "/" not in k}
    t = res["train"]
    log(f"mln summary on {card}: VGG16 output {res['inference']['output_ms']:.3f} "
        f"ms at batch {MLN_BATCH}; run {t['run']['ms_per_step']:.2f} and "
        f"run_group({GROUP_K}) {t['group']['ms_per_step']:.2f} ms/step, "
        f"{t['run']['img_per_s']:.1f} and {t['group']['img_per_s']:.1f} "
        f"img/s, idle share {t['run']['idle_share']} and "
        f"{t['group']['idle_share']}, MFU {t['run']['mfu']:.4f} and "
        f"{t['group']['mfu']:.4f} (x2: {t['run']['mfu_2flops']:.4f} and "
        f"{t['group']['mfu_2flops']:.4f}); kernel launches on the MLN path "
        f"{res['launches']}")
    return res


# ------------------------------------------------------------ phase 5d


def tm_data(np, seed, batch):
    """TM_DATA seeded host batches for a `batch_fn` that cycles through
    them (built before any timed window)."""
    data = engine_batches(np, seed, TM_DATA, batch, 1000)
    return data, (lambda step: data[step % TM_DATA])


class LossRecorder:
    """A listener (TrainingMaster calls `iteration_done` after each step,
    or after each group of k) keeping each step's device loss and a CUDA
    event at the end of each call: no host read inside the timed
    window."""

    def __init__(self, torch, prog, k):
        self.torch, self.prog, self.k = torch, prog, k
        self.losses, self.events = [], []

    def iteration_done(self, net, iteration):
        self.losses.extend([net._score] if self.k == 1
                           else self.prog.last_step_losses)
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)


def tm_timed(torch, np, pc, ResNet50, k, steps, batch_fn):
    """TrainingMaster(steps_per_dispatch=k) on a fresh flagship, pipeline
    on: a warm-up fit of max(k, 2) steps (for k > 1 it captures the
    group), then a fit of `steps` more, timed by the host clock with a
    CUDA sync at its end (the producer's start, its pinned copies and the
    first window's wait included), the kernel launches of that fit
    counted from 0, and for k > 1 the steady state between the first and
    the last group's end (CUDA events); then a profiler window of
    TM_PROFILE_STEPS steps for the idle share."""
    from deeplearning4j_tpu_torch.parallel import TrainingMaster

    net = flagship(ResNet50, "pallas")
    tm = TrainingMaster(net, steps_per_dispatch=k)
    prog = tm._harness.program
    rec = LossRecorder(torch, prog, k)
    net.listeners = [rec]
    warm = max(k, 2)
    tm.fit(batch_fn, warm)
    torch.cuda.synchronize()
    rec.events.clear()
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    tm.fit(batch_fn, warm + steps, start_step=warm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pc.launch_counts()
    ms = wall * 1e3 / steps
    r = {"k": k, "steps": steps, "ms_per_step": ms,
         "img_per_s": TRAIN_BATCH / ms * 1e3,
         "launches": {n: counts[n] for n in pc.LAUNCHES},
         "launches_per_step": {n: counts[n] / steps for n in pc.LAUNCHES},
         "wgmma_per_step": {n: counts[f"{n}/wgmma"] / steps
                            for n in pc.LAUNCHES},
         "captures": prog.group_stats["captures"],
         "replays": prog.group_stats["replays"]}
    if k > 1:
        ev = rec.events
        r["steady_ms_per_step"] = ev[0].elapsed_time(ev[-1]) / (
            (len(ev) - 1) * k)
        (per_replay,) = prog.group_launches().values() or ({},)
        r["launches_per_replay"] = {n: v for n, v in per_replay.items()
                                    if "/" not in n}
    at = warm + steps
    prof = engine_profile(
        torch, lambda: tm.fit(batch_fn, at + TM_PROFILE_STEPS, start_step=at),
        TM_PROFILE_STEPS)
    busy = r["busy_ms"] = prof["busy_ms"]
    r["idle_share"] = None if busy is None else 1.0 - busy / ms
    # the loss over the first pass through the TM_DATA batches against
    # the loss over the last pass (the same batches, in another order)
    vals = [float(v) for v in rec.losses]
    first, last = (float(np.mean(vals[:TM_DATA])),
                   float(np.mean(vals[-TM_DATA:])))
    r["loss_first"], r["loss_last"] = first, last
    if not all(np.isfinite(vals)) or not last < first:
        fail(f"tm k={k}: loss not finite and falling: {vals}")
    want = {"fused_conv1x1": 30, "fused_conv3x3": 16, "dgrad_conv1x1": 30,
            "wgrad_conv1x1": 30}
    for name, n in want.items():
        if counts[name] != n * steps or counts[f"{name}/wgmma"] != n * steps:
            fail(f"tm k={k}: {name} launched {counts[name]} times "
                 f"({counts[f'{name}/wgmma']} on wgmma) in {steps} steps, "
                 f"not {n} per step, all on wgmma")
    return net, tm, r


def checkpoint_times(torch, net, tmp):
    """Save and restore of one flagship checkpoint (params, nesterovs
    momentum, BN states; the device-to-host copy, np.savez and sha256
    included), TM_CKPT_REPEATS times each, outside any timed step."""
    from deeplearning4j_tpu_torch.parallel import TrainingMaster

    tm = TrainingMaster(net, checkpoint_dir=tmp)
    step = net.iteration
    saves, restores = [], []
    for _ in range(TM_CKPT_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tm.save_checkpoint(step)
        saves.append(time.perf_counter() - t0)
    for _ in range(TM_CKPT_REPEATS):
        t0 = time.perf_counter()
        tm.load_checkpoint_at(step)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
    nbytes = os.path.getsize(tm._ckpt_path(step))
    return {"save_s": saves, "restore_s": restores, "bytes": nbytes,
            "params": net.num_params()}


def tm_resume_checks(torch, np, ResNet50, tmp):
    """At TM_CHECK_BATCH: (1) resume — 2 * GROUP_K uninterrupted steps
    with checkpoint_every=GROUP_K against a fresh net of the same seed
    that restores step GROUP_K (load_checkpoint_at) and trains on; params,
    updater state, BN states and iteration bit for bit, no recapture;
    (2) torn write — checkpoint.write:truncate on the second save, and
    load_latest_checkpoint falls back to the first; (3) guard — one inner
    step of a GROUP_K group poisoned (train.grad_nonfinite) under
    NonFiniteGuard("skip_step") ends bit for bit where a run without that
    batch ends."""
    from deeplearning4j_tpu_torch.parallel import TrainingMaster
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard, injector

    _, bf = tm_data(np, 47, TM_CHECK_BATCH)
    n = 2 * GROUP_K
    res = {}
    d1, d2 = os.path.join(tmp, "resume"), os.path.join(tmp, "torn")
    a = flagship(ResNet50, "pallas")
    TrainingMaster(a, checkpoint_dir=d1, checkpoint_every=GROUP_K,
                   steps_per_dispatch=GROUP_K).fit(bf, n)
    b = flagship(ResNet50, "pallas")
    tmb = TrainingMaster(b, checkpoint_dir=d1, steps_per_dispatch=GROUP_K)
    tmb.load_checkpoint_at(GROUP_K)
    tmb.fit(bf, n, start_step=GROUP_K)
    torch.cuda.synchronize()
    same, count, diff = same_bits(torch, a, b)
    pb = tmb._harness.program
    res["resume"] = {"tensors": count, "differ": diff,
                     "iteration": b.iteration,
                     "captures": pb.group_stats["captures"],
                     "checkpoints": tmb.list_checkpoints()}
    log(f"tm resume at batch {TM_CHECK_BATCH}: {n} uninterrupted steps "
        f"(checkpoint_every={GROUP_K}) against a fresh net that restores "
        f"step {GROUP_K} and trains to {n}: {res['resume']}")
    if not (same and b.iteration == a.iteration == n):
        fail("tm resume: the resumed run differs from the uninterrupted one")
    del b, tmb
    injector().inject("checkpoint.write", mode="truncate", at_hit=2,
                      truncate_to=64)
    try:
        TrainingMaster(a, checkpoint_dir=d2, checkpoint_every=GROUP_K,
                       steps_per_dispatch=GROUP_K).fit(bf, n, start_step=0)
    finally:
        injector().clear()
    probe = TrainingMaster(a, checkpoint_dir=d2)
    back = probe.load_latest_checkpoint()
    res["torn"] = {"on_disk": probe.list_checkpoints(), "restored": back}
    log(f"tm torn write (checkpoint.write:truncate on the second save): "
        f"{res['torn']}")
    if back != GROUP_K:
        fail("tm torn write: load_latest_checkpoint did not fall back to "
             "the first checkpoint")
    del a, probe
    torch.cuda.empty_cache()
    bad = 1
    g = flagship(ResNet50, "pallas")
    guard = NonFiniteGuard("skip_step", check_every=1)
    tmg = TrainingMaster(g, steps_per_dispatch=GROUP_K, guard=guard)
    injector().inject("train.grad_nonfinite", at_hit=bad + 1)
    try:
        tmg.fit(bf, n)
    finally:
        injector().clear()
    keep = [s for s in range(n) if s != bad]
    c = flagship(ResNet50, "pallas")
    TrainingMaster(c, steps_per_dispatch=GROUP_K).fit(
        lambda s: bf(keep[s]), len(keep))
    torch.cuda.synchronize()
    same, count, diff = same_bits(torch, g, c)
    pg = tmg._harness.program
    res["guard"] = {"poisoned": sorted(tmg._poisoned_steps),
                    "guard": guard.stats(), "tensors": count, "differ": diff,
                    "captures": pg.group_stats["captures"],
                    "eager_windows": pg.group_stats["eager_windows"]}
    log(f"tm guard: step {bad} of the first {GROUP_K}-step group poisoned "
        f"under skip_step, against a run over the {len(keep)} clean "
        f"batches: {res['guard']}")
    if not (same and res["guard"]["poisoned"] == [bad]
            and guard.counters["skipped_steps"] == 1):
        fail("tm guard: the poisoned inner step was not condemned alone, "
             "or the run does not end where the clean run ends")
    del g, c, tmg
    torch.cuda.empty_cache()
    return res


def pw_checks(torch, np, ResNet50, tmp):
    """ParallelWrapper(steps_per_dispatch=GROUP_K) over PW_BATCHES
    batches of TRAIN_BATCH (the TM batches, cycled) against hand-driven
    run_group calls on the same batches from the same state, bit for bit;
    then EarlyStoppingParallelTrainer over ES_PARALLEL_EPOCHS epochs of
    TM_DATA batches of TM_CHECK_BATCH with a LocalFileGraphSaver: the best
    model verifies and, reloaded, rescores exactly."""
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer,
        LocalFileGraphSaver,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.util.model_serializer import verify_model

    res = {}
    data, _ = tm_data(np, 48, TRAIN_BATCH)
    batches = [data[i % TM_DATA] for i in range(PW_BATCHES)]
    a = flagship(ResNet50, "pallas")
    t0 = time.perf_counter()
    ParallelWrapper(a, steps_per_dispatch=GROUP_K).fit(batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    b = flagship(ResNet50, "pallas")
    prog = StepProgram(b)
    for lo in range(0, PW_BATCHES, GROUP_K):
        w = batches[lo:lo + GROUP_K]
        prog.run_group(np.stack([d[0] for d in w]),
                       np.stack([d[1] for d in w]))
    torch.cuda.synchronize()
    same, count, diff = same_bits(torch, a, b)
    res["wrapper"] = {"tensors": count, "differ": diff, "seconds": secs,
                      "iteration": a.iteration}
    log(f"pw: ParallelWrapper(steps_per_dispatch={GROUP_K}) over "
        f"{PW_BATCHES} batches of {TRAIN_BATCH} against hand-driven "
        f"run_group calls: {res['wrapper']}")
    if not (same and a.iteration == b.iteration == PW_BATCHES):
        fail("pw: ParallelWrapper differs from hand-driven run_group")
    del a, b, prog
    torch.cuda.empty_cache()
    small, _ = tm_data(np, 49, TM_CHECK_BATCH)
    held = engine_batches(np, 50, 1, TM_CHECK_BATCH, 1000)
    net = flagship(ResNet50, "pallas")
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(ES_PARALLEL_EPOCHS)],
        model_saver=LocalFileGraphSaver(tmp),
        score_calculator=DataSetLossCalculator(held))
    t0 = time.perf_counter()
    result = EarlyStoppingParallelTrainer(cfg, net, small).fit()
    secs = time.perf_counter() - t0
    best = result.best_model
    rescored = best.score(held[0])
    recorded = result.score_vs_epoch[result.best_model_epoch]
    path = os.path.join(tmp, "bestModel.zip")
    res["es_parallel"] = {"seconds": secs, "epochs": result.total_epochs,
                          "score_vs_epoch": result.score_vs_epoch,
                          "best_epoch": result.best_model_epoch,
                          "rescored": rescored, "verified": verify_model(path),
                          "iteration": net.iteration}
    log(f"pw early stopping (EarlyStoppingParallelTrainer): "
        f"{res['es_parallel']}")
    if not (result.total_epochs == ES_PARALLEL_EPOCHS
            and res["es_parallel"]["verified"] and rescored == recorded
            and net.iteration == ES_PARALLEL_EPOCHS * TM_DATA):
        fail("pw early stopping: the trainer did not run to its end, or the "
             "best model does not verify and rescore exactly")
    del net, best
    torch.cuda.empty_cache()
    return res


def tm_phase(torch, np, pc, ResNet50, card, group_ms, det):
    """Phase 5d: TrainingMaster, checkpoints, ParallelWrapper and
    EarlyStoppingParallelTrainer on the flagship (see the module
    docstring). `group_ms`: phase 5b's run_group(GROUP_K) ms/step;
    `det`: the cuDNN setting phase 5b's group check found repeatable,
    used for the bitwise checks only."""
    import tempfile

    torch.backends.cudnn.deterministic = False
    data, bf = tm_data(np, 44, TRAIN_BATCH)
    res = {"card": card}
    net, tm, res["k4"] = tm_timed(torch, np, pc, ResNet50, GROUP_K,
                                  TM_STEPS, bf)
    with tempfile.TemporaryDirectory() as tmp:
        res["checkpoint"] = checkpoint_times(torch, net, tmp)
    del net, tm
    torch.cuda.empty_cache()
    net, tm, res["k1"] = tm_timed(torch, np, pc, ResNet50, 1, TM_K1_STEPS,
                                  bf)
    del net, tm, data, bf
    torch.cuda.empty_cache()
    for kind in ("k4", "k1"):
        r = res[kind]
        r["over_run_group"] = r["ms_per_step"] / group_ms
        log(f"tm {kind}: TrainingMaster(steps_per_dispatch={r['k']}) at "
            f"batch {TRAIN_BATCH}, {r['steps']} steps after warm-up: "
            f"{r['ms_per_step']:.2f} ms/step (host clock, sync at the end), "
            f"{r['img_per_s']:.1f} img/s, {r['over_run_group']:.4f}x phase "
            f"5b's run_group({GROUP_K}) {group_ms:.2f} ms/step"
            + (f", steady {r['steady_ms_per_step']:.2f} ms/step (CUDA "
               "events between group ends)" if "steady_ms_per_step" in r
               else "")
            + ", device busy "
            + ("not measured" if r["busy_ms"] is None
               else f"{r['busy_ms']:.2f} ms per step, idle share "
               f"{r['idle_share']:.4f}")
            + f"; launches per step {r['launches_per_step']} (wgmma "
            f"{r['wgmma_per_step']})"
            + (f", per replay {r['launches_per_replay']}"
               if "launches_per_replay" in r else "")
            + f"; loss {r['loss_first']:.4f} -> {r['loss_last']:.4f} (mean "
            f"over the first and the last pass through the {TM_DATA} "
            "batches); "
            f"captures {r['captures']} [{card}]")
    c = res["checkpoint"]
    log(f"tm checkpoint of the flagship ({c['params']} params, nesterovs, "
        f"BN states): {c['bytes']} bytes; save s {c['save_s']}, restore s "
        f"{c['restore_s']} [{card}]")
    torch.backends.cudnn.deterministic = det
    with tempfile.TemporaryDirectory() as tmp:
        res.update(tm_resume_checks(torch, np, ResNet50, tmp))
    with tempfile.TemporaryDirectory() as tmp:
        res.update(pw_checks(torch, np, ResNet50, tmp))
    torch.backends.cudnn.deterministic = False
    return res


# ------------------------------------------------------------ phase 5e


def obs_hooks(torch, tm_cls, net, tr, storage, **kw):
    """A TrainingMaster on `net` with every hook of the observability
    slice: the tracer, the default phase profiler, a StepWatchdog and a
    Supervisor (attached for its counters), TelemetryListener,
    StatsListener and ScoreIterationListener on net.listeners."""
    from deeplearning4j_tpu_torch.observability import TelemetryListener
    from deeplearning4j_tpu_torch.optimize import ScoreIterationListener
    from deeplearning4j_tpu_torch.resilience import StepWatchdog, Supervisor
    from deeplearning4j_tpu_torch.stats import StatsListener

    sup = Supervisor(max_restarts=0)
    tm = tm_cls(net, steps_per_dispatch=GROUP_K, tracer=tr,
                phase_profiler=True, supervisor=sup,
                watchdog=StepWatchdog(timeout_s=OBS_WATCHDOG_S), **kw)
    net.listeners += [
        TelemetryListener(frequency=OBS_STEPS, tracer=tr),
        StatsListener(storage, frequency=OBS_STEPS, session_id="flagship"),
        ScoreIterationListener(OBS_STEPS)]
    return tm, sup


def window_events(torch, tm, marks):
    """Time `tm`'s k-windows on the card: a CUDA event recorded after
    each window (the same shim on both arms of phase 5e; with an event
    recorded before a fit, the events of one fit partition its device
    timeline, idle gaps included)."""
    inner = tm._fit_window

    def timed(*a, **kw):
        out = inner(*a, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append(ev)
        return out

    tm._fit_window = timed


def obs_fits(torch, np, pc, ResNet50, tr, storage):
    """The flagship through TrainingMaster(steps_per_dispatch=GROUP_K,
    pipeline_depth=OBS_PIPELINE_DEPTH) at TRAIN_BATCH from one seeded
    state, every hook on (obs_hooks, the fit run by its Supervisor) and
    every hook off: a warm-up fit of OBS_STEPS steps each (the capture;
    StatsListener's first collection, whose one-off device allocations
    took ~0.22 s), then two timed fits of OBS_STEPS steps per arm in the
    order off, on, on, off (host clock, a sync at each end); the
    launches of the hooks-on fits counted from 0; each window's device
    time (window_events) and the on/off ratio of each pair of windows
    (the i-th window of the n-th fit of each arm), whose median and mean
    without the worst pair are the gates; the CostModel's FLOPs of the captured group (register_perf)
    against the same fits' time."""
    from deeplearning4j_tpu_torch.observability import (
        CostModel,
        StepPhaseProfiler,
        get_registry,
    )
    from deeplearning4j_tpu_torch.parallel import TrainingMaster

    _, bf = tm_data(np, 51, TRAIN_BATCH)
    off_net, on_net = (flagship(ResNet50, "pallas") for _ in range(2))
    tm_off = TrainingMaster(off_net, steps_per_dispatch=GROUP_K,
                            pipeline_depth=OBS_PIPELINE_DEPTH)
    tm_on, sup = obs_hooks(torch, TrainingMaster, on_net, tr, storage,
                           pipeline_depth=OBS_PIPELINE_DEPTH)
    for tm in (tm_off, tm_on):
        tm.fit(bf, OBS_STEPS)
    torch.cuda.synchronize()
    marks = {"off": [], "on": []}
    window_events(torch, tm_off, marks["off"])
    window_events(torch, tm_on, marks["on"])
    # the profiler reports the timed fits only (not the capture's window)
    tm_on.phase_profiler = StepPhaseProfiler()
    reg = get_registry()
    secs = {"off": [], "on": []}
    launches = {n: 0 for n in pc.LAUNCHES}
    wgmma = {n: 0 for n in pc.LAUNCHES}
    steps_total, phase_counts = 0.0, {}
    counter = lambda snap: sum(
        snap["counters"].get("dl4j_train_steps_total", {}).values())
    hist = lambda snap: {k: v["count"] for k, v in
                         snap["histograms"].items()
                         if k.startswith("dl4j_train_phase_seconds")}
    at = {"off": OBS_STEPS, "on": OBS_STEPS}
    first_span = tr.stats()["recorded"]
    for arm in ("off", "on", "on", "off"):
        tm = tm_on if arm == "on" else tm_off
        fit = (lambda a, b: sup.run(tm.fit, bf, b, start_step=a)) \
            if arm == "on" else (lambda a, b: tm.fit(bf, b, start_step=a))
        before = reg.snapshot()
        pc.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        marks[arm].append([start])
        fit(at[arm], at[arm] + OBS_STEPS)
        torch.cuda.synchronize()
        secs[arm].append(time.perf_counter() - t0)
        at[arm] += OBS_STEPS
        if arm == "on":
            # the registry, launches: the hooks-on fits only
            after = reg.snapshot()
            steps_total += counter(after) - counter(before)
            hb = hist(before)
            for k, v in hist(after).items():
                phase_counts[k] = phase_counts.get(k, 0) + v - hb.get(k, 0)
            counts = pc.launch_counts()
            for n in pc.LAUNCHES:
                launches[n] += counts[n]
                wgmma[n] += counts[f"{n}/wgmma"]
    steps = 2 * OBS_STEPS
    r = {"steps": steps, "steps_total_delta": steps_total,
         "phase_counts_delta": phase_counts}
    for arm in ("off", "on"):
        r[f"{arm}_ms_per_step"] = sum(secs[arm]) * 1e3 / steps
        r[f"{arm}_s"] = secs[arm]
    r["ratio"] = r["on_ms_per_step"] / r["off_ms_per_step"]
    # per window: device ms between consecutive window-end events
    win = {arm: [[a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
                 for evs in marks[arm]] for arm in marks}
    r["window_ms"] = win
    pairs = [(i, j, on / off)
             for i, (fon, foff) in enumerate(zip(win["on"], win["off"]))
             for j, (on, off) in enumerate(zip(fon, foff))]
    ratios = sorted(q for _, _, q in pairs)
    r["window_ratios"] = [q for _, _, q in pairs]
    r["median_window_ratio"] = (
        float(np.median(ratios)) if ratios else float("nan"))
    r["trimmed_window_ratio"] = (
        float(np.mean(ratios[:-1])) if len(ratios) > 1 else float("nan"))
    # the slowest window of each arm, and where the profiler put the time
    # of the slowest hooks-on window
    slow = {}
    for arm in win:
        flat = [(ms_, i, j) for i, f in enumerate(win[arm])
                for j, ms_ in enumerate(f)]
        if flat:
            slow[arm] = dict(zip(("ms", "fit", "window"), max(flat)))
    r["slowest_window"] = slow
    ms = r["on_ms_per_step"]
    r["img_per_s"] = TRAIN_BATCH / ms * 1e3
    r["macs_per_image"] = macs_per_image(on_net)
    r["mfu_2flops"] = (r["img_per_s"] * 3 * 2 * r["macs_per_image"]
                       / BF16_FLOPS_PER_S)
    r["launches_per_step"] = {n: launches[n] / steps for n in launches}
    r["wgmma_per_step"] = {n: wgmma[n] / steps for n in wgmma}
    r["launches"] = launches
    same, count, diff = same_bits(torch, on_net, off_net)
    r["bitwise"] = {"tensors": count, "differ": diff,
                    "iterations": (on_net.iteration, off_net.iteration)}
    r["phases"] = tm_on.phase_profiler.report()
    # each window's phases (ms), from the profiler's spans
    r["phase_ms"] = {}
    for sp in tr.spans()[first_span:]:
        if sp["name"].startswith("phase:"):
            r["phase_ms"].setdefault(sp["name"][6:], []).append(
                round(sp["dur_us"] / 1e3, 2))
    if "on" in slow:
        k = slow["on"]["fit"] * len(win["on"][0]) + slow["on"]["window"]
        at_k = {p: v[k] for p, v in r["phase_ms"].items() if k < len(v)}
        slow["on"]["phase"] = (max(at_k, key=at_k.get) if at_k else None)
        slow["on"]["phase_ms"] = at_k
    # the cost model: the captured group's FLOPs, counted outside the
    # timed fits, against the hooks-on fits' ms per step
    prog = tm_on._harness.program
    cm = CostModel(device=DEV)
    keys = list(prog.group_launches())
    t0 = time.perf_counter()
    if keys:   # the captured group: GROUP_K steps per call
        per_call = GROUP_K
        entry = prog.register_perf(cm, keys[0])
    else:      # a CPU rehearsal captures nothing: the k=1 step
        per_call = 1
        entry = prog.register_perf(cm, None, *bf(0))
    r["cost_count_s"] = time.perf_counter() - t0
    (key,) = cm.keys()
    perf = cm.perf_report(key, seconds_per_call=ms * per_call / 1e3,
                          items_per_call=per_call * TRAIN_BATCH)
    r["cost"] = {k: perf.get(k) for k in (
        "source", "flops", "bytes_accessed", "arithmetic_intensity",
        "ridge_point", "bound", "mfu", "device_kind", "peak_flops")}
    r["cost"]["flops_per_step"] = entry["flops"] / per_call
    r["resilience"] = tm_on.training_stats()["resilience"]
    # what one StatsListener collection costs (params and update
    # summaries, the host read), outside the timed fits
    (stats,) = [ls for ls in on_net.listeners
                if hasattr(ls, "_collect_summaries")]
    r["stats_collect_ms"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats._collect_summaries(on_net)
        r["stats_collect_ms"].append((time.perf_counter() - t0) * 1e3)
    del off_net, tm_off
    torch.cuda.empty_cache()
    return r, on_net, tm_on


def obs_drill(torch, np, ResNet50, tr, tmp):
    """At TM_CHECK_BATCH: TrainingMaster(steps_per_dispatch=GROUP_K,
    checkpoint_every=GROUP_K) under a Supervisor with a StepWatchdog
    (OBS_DRILL_WATCHDOG_S) and the tracer; a `train.hang` delay of
    OBS_HANG_S at the third window's start is cut by the watchdog
    (SIGUSR1 -> StepHangError), the Supervisor restarts the fit, which
    resumes from the newest checkpoint; the final state against a run
    without the fault, bit for bit. Detection latency: the hang instant
    against the start of the hung window's span."""
    from deeplearning4j_tpu_torch.parallel import TrainingMaster
    from deeplearning4j_tpu_torch.resilience import (
        StepWatchdog,
        Supervisor,
        injector,
    )

    _, bf = tm_data(np, 52, TM_CHECK_BATCH)
    n = OBS_DRILL_STEPS
    clean = flagship(ResNet50, "pallas")
    TrainingMaster(clean, steps_per_dispatch=GROUP_K).fit(bf, n)
    net = flagship(ResNet50, "pallas")
    wd = StepWatchdog(timeout_s=OBS_DRILL_WATCHDOG_S)
    sup = Supervisor(max_restarts=2, initial_backoff_s=0.0)
    tm = TrainingMaster(net, checkpoint_dir=tmp, checkpoint_every=GROUP_K,
                        steps_per_dispatch=GROUP_K, watchdog=wd,
                        supervisor=sup, tracer=tr)
    injector().inject("train.hang", mode="delay", at_hit=3,
                      delay_s=OBS_HANG_S)
    t0 = time.perf_counter()
    try:
        sup.run(tm.fit, bf, n)
    finally:
        injector().clear()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same, count, diff = same_bits(torch, net, clean)
    spans = {s["id"]: s for s in tr.spans()}
    hangs = [s for s in spans.values() if s["name"] == "watchdog_hang"]
    parent = spans.get(hangs[0]["parent_id"]) if hangs else None
    r = {"seconds": secs, "tensors": count, "differ": diff,
         "iteration": net.iteration, "ledger": sup.restart_ledger,
         "watchdog": wd.stats(), "checkpoints": tm.list_checkpoints(),
         "hang_parent": None if parent is None else
         (parent["name"], parent["args"].get("step")),
         "detection_s": None if parent is None else
         (hangs[0]["t0_us"] - parent["t0_us"]) / 1e6}
    log(f"obs drill at batch {TM_CHECK_BATCH}: train.hang delay "
        f"{OBS_HANG_S:.0f} s at the third {GROUP_K}-step window, watchdog "
        f"{OBS_DRILL_WATCHDOG_S:.0f} s, Supervisor: detected after "
        + ("not measured" if r["detection_s"] is None
           else f"{r['detection_s']:.3f} s")
        + f" (hang instant - the hung window's start), parent "
        f"{r['hang_parent']}, restarts "
        f"{[e['error_class'] for e in sup.restart_ledger]}, resumed from "
        f"the newest checkpoint to iteration {net.iteration}; against the "
        f"run without the fault: {count} tensors, {diff} differ; "
        f"{secs:.1f} s")
    if not (same and net.iteration == n and len(hangs) == 1
            and [e["error_class"] for e in sup.restart_ledger]
            == ["StepHangError"]
            and r["hang_parent"] == ("train_group", 2 * GROUP_K)):
        fail(f"obs drill: the hang was not cut once, parented to the hung "
             f"window, and resumed bit for bit: {r}")
    del net, clean, tm
    torch.cuda.empty_cache()
    return r


def obs_serving(torch, np, net, tr):
    """ParallelInference(batch_limit=32) with the tracer on the trained
    flagship: OBS_REQUESTS sequential requests of OBS_SERVE_SIZES rows
    (one in flight, so each request leads its batches and owns its span
    chain; 40 rows split into two batches), each checked against a direct
    output; then SERVE_THREADS closed-loop clients for OBS_IDLE_S: the
    device's idle share while serving. The window's busy time is the sum
    over its batches of each batch shape's kernel time, measured alone
    under torch.profiler once the clients have stopped: profiling while
    several threads launch work crashed the process on the card (a
    segfault inside the window, in 3 of 4 runs)."""
    from deeplearning4j_tpu_torch.observability import get_registry
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    rng = np.random.default_rng(53)
    pool = {n: serving_inputs(np, rng, n)
            for n in sorted(set(OBS_SERVE_SIZES) | set(SERVE_SIZES))}
    sizes = [OBS_SERVE_SIZES[i % len(OBS_SERVE_SIZES)]
             for i in range(OBS_REQUESTS)]
    reg = get_registry()
    before = reg.snapshot()
    n_spans = len(tr.spans())
    pi = ParallelInference(net, batch_limit=32, tracer=tr)
    try:
        for n in sizes:
            out = pi.output(pool[n])
            if out.shape != (n, 1000) or not np.all(np.isfinite(out)):
                fail(f"obs serving: bad response of shape {out.shape}")
        mid = reg.snapshot()
        stop = threading.Event()
        served = [0]

        def client():
            i = 0
            while not stop.is_set():
                pi.output(pool[SERVE_SIZES[i % len(SERVE_SIZES)]])
                served[0] += 1
                i += 1

        # the window's batches, by input shape (the batch thread's calls)
        window, shapes = [False], []
        forward = net.output

        def counted(*xs):
            if window[0]:
                shapes.append(tuple(
                    (type(x).__name__, tuple(x.shape), str(x.dtype),
                     str(getattr(x, "device", "cpu"))) for x in xs))
            return forward(*xs)

        net.output = counted
        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        time.sleep(0.5)   # the clients' first round, outside the window
        torch.cuda.synchronize()
        window[0] = True
        t0 = time.perf_counter()
        time.sleep(OBS_IDLE_S)
        window[0] = False
        window_s = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join()
    finally:
        pi.shutdown()
        net.__dict__.pop("output", None)
    busy_s = 0.0
    for shape in sorted(set(shapes)):
        # a batch of the same kind, shape and dtype (numpy host arrays or
        # tensors on their device); zeros run the same kernels
        xs = [np.zeros(sh, np.dtype(dt)) if kind == "ndarray" else
              torch.zeros(sh, dtype=getattr(torch, dt[len("torch."):]),
                          device=dv)
              for kind, sh, dt, dv in shape]
        p = engine_profile(torch, lambda: [net.output(*xs)
                                           for _ in range(3)], 3)
        if p["busy_ms"] is None:
            busy_s = None
            break
        busy_s += shapes.count(shape) * p["busy_ms"] / 1e3
    spans = tr.spans()[n_spans:]
    reqs = [s for s in spans if s["name"] == "request"][:OBS_REQUESTS]
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)
    chains = 0
    for q in reqs:
        ds = [d for d in kids.get(q["id"], [])
              if d["name"] == "assemble_dispatch"]
        if ds and all(any(c["name"] == "complete_deliver"
                          for c in kids.get(d["id"], [])) for d in ds) \
                and len(ds) == -(-q["args"]["rows"] // 32):
            chains += 1
    delta = lambda name: (sum(mid["counters"].get(name, {}).values())
                          - sum(before["counters"].get(name, {}).values()))
    occ = lambda snap: snap["histograms"].get(
        "dl4j_serving_batch_occupancy", {"count": 0, "sum": 0.0})
    r = {"requests": OBS_REQUESTS, "chains": chains,
         "batches_expected": sum(-(-n // 32) for n in sizes),
         "splits_expected": sum(1 for n in sizes if n > 32),
         "rows": sum(sizes), "concurrent_served": served[0],
         "idle_share": (None if busy_s is None
                        else 1.0 - busy_s / window_s),
         "busy_s": busy_s, "window_s": window_s,
         "window_batches": len(shapes)}
    # the sequential part's counters (read before the concurrent window)
    r["batches_total_delta"] = delta("dl4j_serving_batches_total")
    r["splits_delta"] = delta("dl4j_serving_bucket_splits_total")
    r["occupancy_delta"] = (occ(mid)["count"] - occ(before)["count"],
                            occ(mid)["sum"] - occ(before)["sum"])
    return r


def obs_phase(torch, np, pc, ResNet50, card, det):
    """Phase 5e: every hook of the observability slice on the flagship
    (see the module docstring)."""
    import http.client
    import tempfile

    from deeplearning4j_tpu_torch.observability import (
        Tracer,
        get_registry,
        parse_prometheus,
    )
    from deeplearning4j_tpu_torch.stats import (
        InMemoryStatsStorage,
        UIServer,
        render_html,
    )
    from deeplearning4j_tpu_torch.stats.listener import _named_leaves

    torch.backends.cudnn.deterministic = det
    tr = Tracer(max_spans=200000)
    storage = InMemoryStatsStorage()
    res = {"card": card}
    r, net, tm = obs_fits(torch, np, pc, ResNet50, tr, storage)
    res["fit"] = r
    phases = r["phases"]
    shares = {p: round(v["share"], 4) for p, v in phases["phases"].items()}
    log(f"obs fit: TrainingMaster(steps_per_dispatch={GROUP_K}) at batch "
        f"{TRAIN_BATCH}, {r['steps']} steps per arm (two fits each, order "
        f"off on on off): hooks on {r['on_ms_per_step']:.2f} ms/step "
        f"({r['img_per_s']:.1f} img/s), hooks off "
        f"{r['off_ms_per_step']:.2f} ms/step: whole-window ratio "
        f"{r['ratio']:.4f}, median per-window ratio "
        f"{r['median_window_ratio']:.4f} and mean without the worst pair "
        f"{r['trimmed_window_ratio']:.4f} over {len(r['window_ratios'])} "
        f"window pairs (the gates; the JAX package's bar for its telemetry: "
        f"< 1.02; this run's limit {OBS_RATIO_MAX}); slowest windows "
        f"{r['slowest_window']}; phase shares {shares}, coverage "
        f"{phases['coverage']:.4f} over {phases['steps']} profiler steps "
        f"(one per window), per window (ms) {r['phase_ms']}; one "
        f"StatsListener collection "
        f"{[round(v, 2) for v in r['stats_collect_ms']]} ms; launches per "
        f"step {r['launches_per_step']} (wgmma {r['wgmma_per_step']}); "
        f"hooks on vs off: {r['bitwise']} [{card}]")
    c = r["cost"]
    flops_want = 3 * 2 * r["macs_per_image"] * TRAIN_BATCH
    log(f"obs cost model: {c['flops_per_step']:.4e} FLOPs per step "
        f"(a multiply-add is two) = {c['flops_per_step'] / flops_want:.4f}"
        f" x 3 x 2 x {r['macs_per_image']} x {TRAIN_BATCH} (the net's "
        f"layer-shape multiply-adds); {c['bytes_accessed']:.4e} "
        f"bytes per window (op-by-op traffic of the counted route), "
        f"arithmetic intensity {c['arithmetic_intensity']:.1f} against the "
        f"ridge {c['ridge_point']:.1f}: {c['bound']}-bound; MFU "
        f"{c['mfu']:.4f} against the same fits' mfu_2flops "
        f"{r['mfu_2flops']:.4f} at the layer-shape count; counted in "
        f"{r['cost_count_s']:.1f} s ({c['source']}) [{card}]")
    want = {"fused_conv1x1": 30, "fused_conv3x3": 16, "dgrad_conv1x1": 30,
            "wgrad_conv1x1": 30}
    windows = r["steps"] // GROUP_K
    problems = []
    # the median of the per-window ratios: one host stall (a 1.09 s
    # host-to-device stage once read 1.3960 whole-window, 1.0199 on the
    # rerun) moves one window pair, not the median. The median cannot see
    # a cost in fewer than half the windows (a per-fit hook), so the mean
    # without the worst pair is gated too: it drops the one stall and
    # keeps every periodic cost
    for what in ("median", "trimmed"):
        q = r[f"{what}_window_ratio"]
        if not q <= OBS_RATIO_MAX:
            problems.append(f"hooks-on/off {what} per-window ratio "
                            f"{q:.4f} (whole-window {r['ratio']:.4f})")
    if phases["coverage"] < OBS_COVERAGE_MIN:
        problems.append(f"coverage {phases['coverage']:.4f}")
    if r["bitwise"]["differ"] or len(set(r["bitwise"]["iterations"])) != 1:
        problems.append(f"hooks moved the state {r['bitwise']}")
    for n, v in want.items():
        if r["launches_per_step"][n] != v or r["wgmma_per_step"][n] != v:
            problems.append(f"{n} launches {r['launches_per_step'][n]}")
    if abs(c["flops_per_step"] / flops_want - 1) > OBS_FLOPS_TOL:
        problems.append(f"cost model FLOPs {c['flops_per_step']:.4e}")
    if abs(c["mfu"] / r["mfu_2flops"] - 1) > OBS_FLOPS_TOL:
        problems.append(f"cost model MFU {c['mfu']:.4f}")
    # TrainingMaster counts each window's steps, TelemetryListener one per
    # iteration_done (once per window); the profiler one per window
    if r["steps_total_delta"] != r["steps"] + windows:
        problems.append(f"dl4j_train_steps_total moved "
                        f"{r['steps_total_delta']}")
    if any(v != windows for v in r["phase_counts_delta"].values()
           if v) or not r["phase_counts_delta"]:
        problems.append(f"phase histograms {r['phase_counts_delta']}")
    if problems:
        fail("obs fit: " + "; ".join(problems))

    reps = storage.reports("flagship")
    rep = reps[-1]
    sizes = {n: t.numel() for n, t in _named_leaves(net._params_view())}
    bad = [n for n, h in rep.param_histograms.items()
           if sum(h.counts) != sizes[n]]
    # a conv bias in front of a BatchNorm has a zero gradient up to
    # rounding; weights, gamma and beta must move
    zero = [n for n, v in rep.update_mean_magnitudes.items()
            if not v > 0 and not n.endswith("/b")]
    with tempfile.TemporaryDirectory() as tmp:
        page = render_html(storage, path=os.path.join(tmp, "stats.html"),
                           telemetry=get_registry())
        tm.export_stats_html(os.path.join(tmp, "timeline.html"))
        srv = UIServer(port=0).attach(storage).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=30)
            try:
                conn.request("GET", "/")
                resp = conn.getresponse()
                status, body = resp.status, resp.read()
            finally:
                conn.close()
        finally:
            srv.stop()
    res["stats"] = {"reports": len(reps), "groups": len(sizes),
                    "bad_counts": bad, "zero_updates": zero,
                    "zero_bias_updates": sum(
                        1 for v in rep.update_mean_magnitudes.values()
                        if not v > 0),
                    "page_bytes": len(page), "get_status": status,
                    "get_bytes": len(body)}
    log(f"obs stats: {len(reps)} StatsListener reports of {len(sizes)} "
        f"parameter groups (32-bin histograms and mean |x| of the params "
        f"and of each window's update, summarized on the card); render_html "
        f"{len(page)} bytes; UIServer GET {status}, {len(body)} bytes")
    if bad or zero or not reps or status != 200:
        fail(f"obs stats: {res['stats']}")
    del net, tm
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        res["drill"] = obs_drill(torch, np, ResNet50, tr, tmp)
    torch.backends.cudnn.deterministic = False
    net = flagship(ResNet50, "pallas")
    randomize_batchnorm(torch, net, seed=1)
    res["serving"] = s = obs_serving(torch, np, net, tr)
    del net
    torch.cuda.empty_cache()
    log(f"obs serving: {s['requests']} sequential requests (rows "
        f"{OBS_SERVE_SIZES} in turn) through ParallelInference with the "
        f"tracer: {s['chains']} full span chains (request -> "
        f"assemble_dispatch -> complete_deliver, per batch of the "
        f"request); dl4j_serving_batches_total +{s['batches_total_delta']}"
        f" (expected {s['batches_expected']}), bucket splits "
        f"+{s['splits_delta']} (expected {s['splits_expected']}), "
        f"occupancy (count, rows) +{s['occupancy_delta']} (rows "
        f"{s['rows']}); device idle share while "
        f"{SERVE_THREADS} clients were served for {s['window_s']:.2f} s "
        f"(busy: its {s['window_batches']} batches, each shape's kernels "
        "timed alone under the profiler): "
        + ("not measured" if s["idle_share"] is None
           else f"{s['idle_share']:.4f}")
        + f" ({s['concurrent_served']} requests) [{card}]")
    if (s["chains"] != OBS_REQUESTS
            or s["splits_delta"] != s["splits_expected"]
            or s["batches_total_delta"] != s["batches_expected"]
            or s["occupancy_delta"] != (s["batches_expected"], s["rows"])):
        fail(f"obs serving: {s}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        tr.export_chrome_trace(path)
        nbytes = os.path.getsize(path)
        with open(path) as f:
            doc = json.load(f)
    events = doc["traceEvents"]
    group_steps = sum(e["args"].get("steps", 0) for e in events
                      if e.get("name") == "train_group")
    ran = OBS_STEPS + r["steps"] + OBS_DRILL_STEPS
    hang = [e for e in events if e.get("name") == "watchdog_hang"]
    text = get_registry().prometheus_text()
    flat = parse_prometheus(text)
    res["trace"] = {"events": len(events), "bytes": nbytes,
                    "spans": tr.stats()["recorded"],
                    "train_group_steps": group_steps, "steps_run": ran,
                    "hang_parented": bool(hang)
                    and "parent_id" in hang[0]["args"]}
    res["prometheus"] = {"bytes": len(text), "samples": len(flat)}
    log(f"obs trace: {res['trace']['spans']} spans, Chrome export "
        f"{nbytes} bytes, {len(events)} events; train_group steps "
        f"{group_steps} of {ran} run; hang instant parented "
        f"{res['trace']['hang_parented']}; prometheus_text {len(text)} "
        f"bytes, {len(flat)} samples parsed")
    if group_steps != ran or not res["trace"]["hang_parented"] \
            or not flat or "dl4j_train_steps_total" not in flat:
        fail(f"obs trace/prometheus: {res['trace']}")
    return res


# ------------------------------------------------------------ phase 5f


def text_model(TextGenerationLSTM, compute_dtype="bfloat16", remat=False):
    """The zoo's TextGenerationLSTM at bench_lstm's configuration, seeded
    random weights, on the card."""
    zm = TextGenerationLSTM(num_classes=RNN_VOCAB,
                            input_shape=(RNN_SEQ, RNN_VOCAB),
                            compute_dtype=compute_dtype)
    zm.bptt_remat = remat
    return zm.init_model(device=DEV)


def macs_per_token(net):
    """Multiply-adds of one timestep of one sequence's forward, from the
    layer shapes: 4H x (nIn + H) per LSTM layer (the four gates' input and
    recurrent products), nIn x nOut per output layer."""
    total = 0
    for layer in net.conf.layers:
        kind = type(layer).__name__
        if kind in ("LSTM", "GravesLSTM"):
            total += 4 * layer.n_out * (layer.n_in + layer.n_out)
        elif kind in ("RnnOutputLayer", "OutputLayer", "DenseLayer"):
            total += layer.n_in * layer.n_out
    return total


def rnn_data(torch, np, seed, batch):
    """A seeded learnable character stream on the card: each sequence
    starts at a random character, and each next one is perm[current]
    with probability RNN_FOLLOW, else random. One-hot x [B, T, V] and
    y, the next characters; and the rule `perm`."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(RNN_VOCAB)
    ids = np.empty((batch, RNN_SEQ + 1), np.int64)
    ids[:, 0] = rng.integers(0, RNN_VOCAB, batch)
    follow = rng.random((batch, RNN_SEQ)) < RNN_FOLLOW
    rand = rng.integers(0, RNN_VOCAB, (batch, RNN_SEQ))
    for t in range(RNN_SEQ):
        ids[:, t + 1] = np.where(follow[:, t], perm[ids[:, t]], rand[:, t])
    ids = torch.from_numpy(ids).to(DEV)
    eye = torch.eye(RNN_VOCAB, device=DEV)
    return eye[ids[:, :-1]], eye[ids[:, 1:]], perm


def events_ms(torch, calls, n):
    """ms per call of `calls()` over n calls between CUDA events, after
    one untimed call."""
    calls()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        calls()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def rnn_timed(torch, np, TextGenerationLSTM, batch, remat=False):
    """One TextGenerationLSTM trained through StepProgram.run on one
    seeded batch of `batch` sequences: RNN_WARMUP calls, RNN_STEPS calls
    timed by CUDA events (each a truncated-BPTT batch of six chunks), the
    step of one 50-step chunk timed alone (RNN_CHUNK_CALLS calls of the
    train step the chunks run, from zero carries) and then under the
    profiler (one call: the idle share is its device busy time against
    the unprofiled chunk's; a whole batch's ~35k kernels would keep the
    profiler's host side busy for many seconds); the eval-mode score of
    the first chunk before and after. Returns (result, net, data)."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    net = text_model(TextGenerationLSTM, remat=remat)
    prog = StepProgram(net)
    x, y, perm = rnn_data(torch, np, 71, batch)
    L = net.conf.tbptt_fwd_length
    chunks = -(-RNN_SEQ // L)
    score0 = net.score((x[:, :L], y[:, :L]))
    losses = [prog.run(x, y) for _ in range(RNN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(RNN_STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(RNN_STEPS):
        losses.append(prog.run(x, y))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = sum(events[i].elapsed_time(events[i + 1])
             for i in range(RNN_STEPS)) / RNN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    carries = net._initial_carries(batch)
    xc, yc = x[:, :L], y[:, :L]
    chunk = lambda: net._train_step(xc, yc, rnn_carries=carries)
    chunk_ms = events_ms(torch, chunk, RNN_CHUNK_CALLS)
    prof = engine_profile(torch, chunk, 1)
    score1 = net.score((x[:, :L], y[:, :L]))
    vals = [float(v) for v in losses]
    macs = macs_per_token(net)
    tok_s = batch * RNN_SEQ / ms * 1e3
    busy = prof["busy_ms"]
    r = {"batch": batch, "remat": remat, "chunks": chunks,
         "ms_per_batch": ms, "ms_per_chunk": ms / chunks,
         "ms_per_50_step_chunk": chunk_ms, "tokens_per_s": tok_s,
         "host_tokens_per_s": batch * RNN_SEQ * RNN_STEPS / wall,
         "max_memory_gib": peak, "macs_per_token": macs,
         "mfu": tok_s * 3 * macs / BF16_FLOPS_PER_S,
         "chunk_busy_ms": busy,
         "idle_share": None if busy is None else 1.0 - busy / chunk_ms,
         "top_kernels": prof["top"], "batch_losses": vals,
         "score_first_chunk": (score0, score1),
         "iteration": net.iteration}
    r["mfu_2flops"] = 2 * r["mfu"]
    log(f"rnn train batch {batch}" + (" bptt_remat" if remat else "")
        + f": {ms:.2f} ms per batch of {RNN_SEQ} steps ({chunks} chunks, "
        f"{ms / chunks:.2f} ms per chunk; one 50-step chunk's step alone "
        f"{chunk_ms:.2f} ms; CUDA events), {tok_s:.1f} tokens/s, host "
        f"{r['host_tokens_per_s']:.1f} tokens/s, peak memory {peak:.2f} "
        f"GiB, device busy "
        + ("not measured" if busy is None else f"{busy:.2f} ms per 50-step "
           f"chunk, idle share {r['idle_share']:.4f}")
        + f", MFU {r['mfu']:.5f} at {macs} multiply-adds per token x 3 "
        f"(one FLOP each), {r['mfu_2flops']:.5f} at two; batch losses "
        f"{[round(v, 3) for v in vals]}; first-chunk score "
        f"{score0:.3f} -> {score1:.3f}; top kernels "
        f"{[(k, round(v, 3)) for k, v in prof['top'][:6]]}")
    if not all(np.isfinite(vals + [score0, score1])) or not score1 < score0:
        fail(f"rnn batch {batch}: loss not finite and falling: {vals}, "
             f"first-chunk score {score0} -> {score1}")
    want = chunks * (RNN_WARMUP + RNN_STEPS) + RNN_CHUNK_CALLS + 2
    if net.iteration != want:
        fail(f"rnn batch {batch}: {net.iteration} iterations, not {want}")
    return r, net, (x, y, perm)


def rnn_serving(torch, np, net, perm):
    """Greedy generation at batch 64 through rnn_time_step: a seeded
    RNN_PROMPT-character prompt as one chunk, then RNN_GENERATE single
    steps, each fed the argmax of the last; no host read inside the
    loop. ms per character by CUDA events, and the share of generated
    transitions that follow the training stream's rule."""
    B = RNN_BATCHES[0]
    eye = torch.eye(RNN_VOCAB, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    prompt = torch.randint(0, RNN_VOCAB, (B, RNN_PROMPT), generator=gen,
                           device=DEV)
    net.clear_rnn_state()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e[0].record()
    out = net.rnn_time_step(eye[prompt])
    nxt = out[:, -1].argmax(-1)
    e[1].record()
    chars = [nxt]
    for _ in range(RNN_GENERATE):
        out = net.rnn_time_step(eye[nxt])
        nxt = out.argmax(-1)
        chars.append(nxt)
    e[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = torch.stack(chars, 1).cpu().numpy()
    last = out.float().cpu().numpy()
    if (text.shape != (B, RNN_GENERATE + 1) or last.shape != (B, RNN_VOCAB)
            or not np.isfinite(last).all()
            or not np.allclose(last.sum(-1), 1.0, atol=1e-4)):
        fail(f"rnn generation: shapes {text.shape}, {last.shape} or "
             "non-finite / non-normalized outputs")
    follows = float(np.mean(perm[text[:, :-1]] == text[:, 1:]))
    r = {"batch": B, "prompt": RNN_PROMPT, "generated": RNN_GENERATE,
         "prompt_ms": e[0].elapsed_time(e[1]),
         "ms_per_char": e[1].elapsed_time(e[2]) / RNN_GENERATE,
         "host_ms_per_char": wall * 1e3 / RNN_GENERATE,
         "follows_rule": follows}
    log(f"rnn generate: batch {B}, prompt {RNN_PROMPT} chars as one chunk "
        f"{r['prompt_ms']:.2f} ms, then {RNN_GENERATE} chars at "
        f"{r['ms_per_char']:.3f} ms per char (CUDA events; host clock "
        f"{r['host_ms_per_char']:.3f}), {follows:.3f} of the generated "
        f"transitions follow the training stream's rule")
    return r


def rnn_stream_checks(torch, np, TextGenerationLSTM, net, x):
    """rnn_time_step one step at a time against output() on the first
    RNN_CHECK_STEPS steps of `x` (batch 64): on an f32 twin with the same
    weights (RNN_STREAM_TOL), and the bf16 policy's output() against the
    stream, which runs the f32 params as the JAX package's does
    (RNN_BF16_LOGP_TOL)."""
    from deeplearning4j_tpu_torch.util.tree import clone

    seq = x[:RNN_BATCHES[0], :RNN_CHECK_STEPS]
    twin = text_model(TextGenerationLSTM, compute_dtype=None)
    twin.params = clone(net.params)
    r = {}
    for name, n in (("f32", twin), ("bf16", net)):
        full = n.output(seq).float().cpu().numpy()
        n.clear_rnn_state()
        steps = np.stack([n.rnn_time_step(seq[:, t]).float().cpu().numpy()
                          for t in range(seq.shape[1])], 1)
        r[name] = {"max_abs": float(np.abs(steps - full).max()),
                   "logp_gap": logp_gap(np, full, steps)}
        if name == "f32":
            tol = RNN_STREAM_TOL
            r[name]["within_tol"] = bool(np.all(
                np.abs(steps - full) <= tol["atol"] + tol["rtol"]
                * np.abs(full)))
    log(f"rnn stream vs output over {RNN_CHECK_STEPS} steps at batch "
        f"{seq.shape[0]}: f32 max |diff| {r['f32']['max_abs']:.3e} (limit "
        f"rtol {RNN_STREAM_TOL['rtol']} / atol {RNN_STREAM_TOL['atol']}); "
        f"bf16 policy output vs the f32 stream max |log p - log p_ref| "
        f"{r['bf16']['logp_gap']:.4f} (limit {RNN_BF16_LOGP_TOL}), max "
        f"|diff| {r['bf16']['max_abs']:.3e}")
    if not r["f32"]["within_tol"]:
        fail(f"rnn stream f32: {r['f32']}")
    if not r["bf16"]["logp_gap"] <= RNN_BF16_LOGP_TOL:
        fail(f"rnn stream bf16: {r['bf16']}")
    del twin
    return r


def rnn_yardstick(torch, np):
    """A non-peephole LSTM layer of the port against torch.nn.LSTM
    (cuDNN) on the same weights ([i,f,o,g] -> cuDNN's [i,f,g,o], bias_hh
    zero) at RNN_YARDSTICK_SHAPES [B, T, H]: the f32 outputs, and forward
    and forward+backward ms of both in f32 and bf16 (CUDA events). cuDNN
    appears here only, never on the port's path."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM

    out = []
    for b, t, h in RNN_YARDSTICK_SHAPES:
        layer = LSTM(n_in=h, n_out=h, weight_init="xavier")
        p32 = {k: v.to(DEV) for k, v in layer.init_params(
            torch.Generator().manual_seed(3),
            InputType.recurrent(h, t)).items()}
        order = lambda w: torch.cat([w[..., :2 * h], w[..., 3 * h:],
                                     w[..., 2 * h:3 * h]], -1)
        ref32 = torch.nn.LSTM(h, h, batch_first=True).to(DEV)
        with torch.no_grad():
            ref32.weight_ih_l0.copy_(order(p32["W"]).T)
            ref32.weight_hh_l0.copy_(order(p32["RW"]).T)
            ref32.bias_ih_l0.copy_(order(p32["b"]))
            ref32.bias_hh_l0.zero_()
        ref32.flatten_parameters()
        gen = torch.Generator(device=DEV).manual_seed(4)
        x32 = torch.randn((b, t, h), generator=gen, device=DEV)
        g32 = torch.randn((b, t, h), generator=gen, device=DEV)
        with torch.no_grad():
            err = float((layer.apply(p32, x32)[0]
                         - ref32(x32)[0]).abs().max())
        row = {"shape": (b, t, h), "f32_max_abs_err": err}
        for dt in ("float32", "bfloat16"):
            d = getattr(torch, dt)
            p = {k: v.to(d).requires_grad_() for k, v in p32.items()}
            ref = torch.nn.LSTM(h, h, batch_first=True).to(DEV, d)
            ref.load_state_dict(ref32.state_dict())
            ref.flatten_parameters()
            x, g = x32.to(d), g32.to(d)
            keys = sorted(p)

            def port_fwd():
                with torch.no_grad():
                    layer.apply(p, x)

            def port_fb():
                torch.autograd.grad(layer.apply(p, x)[0],
                                    [p[k] for k in keys], g)

            def ref_fwd():
                with torch.no_grad():
                    ref(x)

            def ref_fb():
                torch.autograd.grad(ref(x)[0], list(ref.parameters()), g)

            n = RNN_YARDSTICK_CALLS
            row[dt] = {"port_fwd_ms": events_ms(torch, port_fwd, n),
                       "port_fwd_bwd_ms": events_ms(torch, port_fb, n),
                       "cudnn_fwd_ms": events_ms(torch, ref_fwd, n),
                       "cudnn_fwd_bwd_ms": events_ms(torch, ref_fb, n)}
        out.append(row)
        log(f"rnn yardstick LSTM [B,T,H]={list(row['shape'])}: f32 max "
            f"|port - cuDNN| {err:.3e} (limit {RNN_YARDSTICK_TOL}); "
            + "; ".join(
                f"{dt} forward port {row[dt]['port_fwd_ms']:.3f} ms vs "
                f"cuDNN {row[dt]['cudnn_fwd_ms']:.3f} ms, forward+backward "
                f"port {row[dt]['port_fwd_bwd_ms']:.3f} vs cuDNN "
                f"{row[dt]['cudnn_fwd_bwd_ms']:.3f} ms"
                for dt in ("float32", "bfloat16")))
        if not err <= RNN_YARDSTICK_TOL:
            fail(f"rnn yardstick {row['shape']}: port vs cuDNN {err}")
    return out


def rnn_golden(torch, np):
    """tests/fixtures/golden_graph.zip (the JAX package's recurrent
    golden graph: two LSTMs, an ElementWiseVertex, a LastTimeStepVertex)
    restored on the card against its committed outputs."""
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_computation_graph,
    )

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures")
    net = restore_computation_graph(os.path.join(fix, "golden_graph.zip"),
                                    device=DEV)
    exp = np.load(os.path.join(fix, "golden_graph_expected.npz"))
    got = net.output(exp["x"]).float().cpu().numpy()
    err = float(np.abs(got - exp["y"]).max())
    log(f"rnn golden_graph.zip on the card: max |output - expected| "
        f"{err:.3e} (limit {RNN_GOLDEN_TOL})")
    if not err <= RNN_GOLDEN_TOL:
        fail(f"rnn golden graph: {err}")
    return {"max_abs_err": err}


def rnn_phase(torch, np, pc, card):
    """Phase 5f: recurrent networks on the card (see the module
    docstring). The kernel launch counters are set to 0 before it and
    read after it: no kernel of csrc/ is on the recurrent path."""
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    pc.reset_launch_counts()
    res = {"card": card, "train": {}, "seconds": {}}
    serve_net = serve_data = None
    for batch, remat in [(b, False) for b in RNN_BATCHES] + [
            (RNN_REMAT_BATCH, True)]:
        t0 = time.perf_counter()
        r, net, data = rnn_timed(torch, np, TextGenerationLSTM, batch,
                                 remat)
        key = "remat" if remat else batch
        res["train"][key] = r
        res["seconds"][key] = time.perf_counter() - t0
        if batch == RNN_BATCHES[0]:
            serve_net, serve_data = net, data
        del net, data
        torch.cuda.empty_cache()
    log(f"model: TextGenerationLSTM (MultiLayerNetwork), "
        f"{serve_net.num_params()} params, bf16 policy, truncated BPTT "
        f"{serve_net.conf.tbptt_fwd_length}")
    for key, run in (
            ("serving", lambda: rnn_serving(torch, np, serve_net,
                                            serve_data[2])),
            ("stream", lambda: rnn_stream_checks(
                torch, np, TextGenerationLSTM, serve_net, serve_data[0])),
            ("yardstick", lambda: rnn_yardstick(torch, np)),
            ("golden", lambda: rnn_golden(torch, np))):
        t0 = time.perf_counter()
        res[key] = run()
        res["seconds"][key] = time.perf_counter() - t0
    del serve_net, serve_data
    torch.cuda.empty_cache()
    counts = pc.launch_counts()
    res["launches"] = {k: counts[k] for k in pc.LAUNCHES}
    t = res["train"]
    log(f"rnn summary on {card}: tokens/s "
        + ", ".join(f"batch {b} {t[b]['tokens_per_s']:.1f} (idle share "
                    f"{t[b]['idle_share']})" for b in RNN_BATCHES)
        + f", batch {RNN_REMAT_BATCH} bptt_remat "
        f"{t['remat']['tokens_per_s']:.1f}; generation "
        f"{res['serving']['ms_per_char']:.3f} ms per char at batch "
        f"{RNN_BATCHES[0]}; kernel launches on the recurrent path "
        f"{res['launches']}; seconds per part "
        f"{ {k: round(v, 1) for k, v in res['seconds'].items()} }")
    if any(res["launches"].values()):
        fail(f"rnn: a csrc/ kernel launched on the recurrent path: "
             f"{res['launches']}")
    return res


# ------------------------------------------------------------ phase 5g


def zoo_net(cls, mode, compute_dtype="bfloat16", hw=None, **kw):
    """A graph-zoo model (zoo defaults: nesterovs lr 1e-2, 1000 classes)
    at `hw` (default: ZOO_HW of its class, its full input size), bf16
    policy, helper mode `mode`, seeded init, on the card."""
    hw = hw or ZOO_HW[cls.__name__]
    return cls(input_shape=(hw, hw, 3), compute_dtype=compute_dtype,
               helpers=mode, **kw).init_model(device=DEV)


def trains_from(net):
    """Names of the graph's nodes whose value depends on a param that
    trains (a layer with params that is not frozen, or any descendant)."""
    from deeplearning4j_tpu_torch.util.tree import leaves

    params = net._params_view()
    out = set()
    for node in net.topo:
        own = (node.kind == "layer" and not node.obj.frozen
               and bool(leaves(params[node.name])))
        if own or any(s in out for s in node.inputs):
            out.add(node.name)
    return out


def path_launches(pc, net, batch, train):
    """Kernel launches of one forward (train False) or one train step of
    the fused graph `net` at `batch`, by kernel and by "kernel/route",
    derived from its layer shapes: a stride-1 1x1 (3x3 SAME) conv of the
    fusion plan launches fused_conv1x1 (fused_conv3x3) on the route
    forward_route gives its shape; in a train step a 1x1 conv also
    launches wgrad_conv1x1 unless it is frozen, and dgrad_conv1x1 when its
    input depends on a param that trains (backward_route)."""
    from deeplearning4j_tpu_torch.nn.helpers.fused_ops import kernel_route

    plan = net._helper_plan()
    dt = net.compute_dtype or net.dtype
    trains = trains_from(net) if train else set()
    counts = {k: 0 for k in pc.launch_counts()}

    def add(name, route):
        counts[name] += 1
        counts[f"{name}/{route}"] += 1

    for name, spec in plan.conv.items():
        node = net.conf.node(name)
        t = net._layer_in_types[name]
        h, w, c, n = t.height, t.width, t.channels, node.obj.n_out
        route = kernel_route(node.obj.kernel_size, spec.stride, spec.padding,
                             (h, w))
        m = batch * h * w
        if route == "conv3x3":
            add("fused_conv3x3", pc.forward_route(dt, m, c, n, width=w))
        elif route == "conv1x1":
            add("fused_conv1x1", pc.forward_route(dt, m, c, n))
            if node.inputs[0] in trains:
                add("dgrad_conv1x1", pc.backward_route(dt, m, c, n))
            if train and not node.obj.frozen:
                add("wgrad_conv1x1", pc.backward_route(dt, m, c, n))
    return counts


def calls_by_route(pc, calls):
    """record_kernel_calls' list counted as path_launches counts: by
    kernel and "kernel/route", each call's route from its shape."""
    counts = {k: 0 for k in pc.launch_counts()}
    for key in calls:
        counts[key[0]] += 1
        counts[f"{key[0]}/{key_route(pc, key)}"] += 1
    return counts


def key_route(pc, key):
    """The route a recorded kernel call (record_kernel_calls' key) takes:
    forward_route or backward_route of its dtype and shape (fresh
    tensors: aligned)."""
    name, shape, dt = key[:3]
    if name == "fused_conv3x3":
        b, h, w, c, n = shape
        return pc.forward_route(dt, b * h * w, c, n, width=w)
    if name == "fused_conv1x1":
        return pc.forward_route(dt, *shape)
    return pc.backward_route(dt, *shape)


def zoo_kernel_checks(torch, pc, calls, label, worst):
    """Every distinct kernel call of `calls` (record_kernel_calls' keys:
    shape and prologue flags) against its plain version on fresh seeded
    inputs: in its own dtype on the route its shape takes, and in f32 on
    "simple"; error max |kernel - plain| / max(max |plain|, 1) over every
    output within TOL. Updates `worst` (max |y|, |dx| or |dW| error per
    kernel) and returns the keys checked per (kernel, dtype, route)."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    r = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    done = {}
    for key in dict.fromkeys(calls):
        for dt in dict.fromkeys((key[2], torch.float32)):
            k = key[:2] + (dt,) + key[3:]
            name, dtype = k[0], str(dt).replace("torch.", "")
            case = forward_case if name.startswith("fused") else backward_case
            _, _, make, kern_f, plain_f, _ = case(torch, pc, r, k)
            a = make()
            pc.reset_launch_counts()
            got, ref = kern_f(a), plain_f(a)
            torch.cuda.synchronize()
            route, want = launched_routes(pc)[name], key_route(pc, k)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            if any((g is None) != (q is None) for g, q in zip(got, ref)):
                fail(f"{label}: {name} {k[1]}: an output is absent in one "
                     "version")
            errs = [norm_err(g, q) for g, q in zip(got, ref) if g is not None]
            abs_err = float((got[0].float() - ref[0].float()).abs().max())
            worst[name] = max(worst.get(name, 0.0), abs_err)
            ok = (route == want and max(errs) <= TOL[dtype]
                  and bool(torch.isfinite(got[0]).all()))
            done.setdefault((name, dtype, route), []).append(k[1])
            if not ok:
                fail(f"{label}: {name} {dtype} {k[1]} flags {k[3:]}: error "
                     f"{max(errs):.2e} (limit {TOL[dtype]:g}), route {route} "
                     f"(want {want})")
            del a, got, ref
    log(f"{label}: distinct kernel calls against their plain versions, "
        "each within TOL: " + ", ".join(
            f"{n} {d} {rt} x{len(v)}" for (n, d, rt), v in done.items()))
    return {f"{n}/{d}/{rt}": len(v) for (n, d, rt), v in done.items()}


def backward_calls(calls):
    """The dgrad/wgrad calls of a recorded train step."""
    return [c for c in calls if c[0] in ("dgrad_conv1x1", "wgrad_conv1x1")]


def route_sums(rows):
    """timing_phase's rows summed per (kernel, route): card, plain,
    library and bound ms over the calls of one forward or step."""
    out = {}
    for row in rows:
        t = out.setdefault(f"{row['name']}/{row['route']}",
                           {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                            "library_ms": 0.0, "bound_ms": 0.0})
        t["calls"] += row["count"]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            t[k] += row["count"] * row[k]
    return out


def zoo_forward_check(torch, np, net, hw, label, type_name):
    """The "pallas" forward of the zoo model `type_name` against the same
    weights through "fused" (cuDNN convolutions) on 8 seeded images, under
    the bf16 policy and in f32: max |log p - log p_ref| within
    ZOO_LOGP_TOL."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    x = serving_inputs(np, np.random.default_rng(13), 8, hw)
    gaps = {}
    saved = net.conf.helper_mode
    try:
        for cd in (torch.bfloat16, None):
            outs = {}
            for mode in ("pallas", "fused"):
                net.conf.helper_mode = mode
                twin = ComputationGraph(net.conf, compute_dtype=cd,
                                        device=DEV)
                twin.params, twin.states = net.params, net.states
                o = outs[mode] = twin.output(x).float().cpu().numpy()
                if not np.isfinite(o).all():
                    fail(f"{label} forward {mode}: non-finite output")
            gaps["float32" if cd is None else "bfloat16"] = logp_gap(
                np, outs["pallas"], outs["fused"])
    finally:
        net.conf.helper_mode = saved
    limits = {"bfloat16": ZOO_LOGP_TOL[type_name],
              "float32": ZOO_LOGP_TOL["float32"]}
    log(f"{label} forward, pallas against fused on 8 images: max |log p - "
        "log p_ref| " + ", ".join(f"{k} {v:.3e} (limit {limits[k]:g})"
                                  for k, v in gaps.items()))
    if any(v > limits[k] for k, v in gaps.items()):
        fail(f"{label}: the pallas forward departs from fused: {gaps}")
    return gaps


def check_launches(label, got, want):
    if got != want:
        fail(f"{label}: launches {got} != derived from the shapes {want}")


def zoo_group_check(torch, np, cls, hw, det):
    """From one seeded state at ZOO_CHECK_BATCH, GROUP_K eager
    StepProgram.run calls against one run_group(GROUP_K) replay, dropout
    on: params, updater state, BN states, losses and the dropout
    generator's state bit for bit (cuDNN as phase 5b found it)."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    data = engine_batches(np, 61, GROUP_K, ZOO_CHECK_BATCH, 1000, hw)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = det
    try:
        e, g = zoo_net(cls, "pallas", hw=hw), zoo_net(cls, "pallas", hw=hw)
        pe, pg = StepProgram(e), StepProgram(g)
        losses = torch.stack([pe.run(x, y) for x, y in data])
        pg.run_group(np.stack([d[0] for d in data]),
                     np.stack([d[1] for d in data]))
        torch.cuda.synchronize()
        same, n, diff = same_bits(torch, e, g)
        ok = (same and bits_equal(torch, losses, pg.last_step_losses)
              and torch.equal(e._rng_state(), g._rng_state()))
    finally:
        torch.backends.cudnn.deterministic = old
    log(f"zoo {cls.__name__} group check, batch {ZOO_CHECK_BATCH}, dropout "
        f"on: run_group({GROUP_K}) against {GROUP_K} eager run() calls: {n} "
        f"tensors, {diff} differ; losses and generator state equal {ok}")
    if not ok:
        fail(f"zoo {cls.__name__}: run_group differs from eager steps")
    del e, g, pe, pg
    torch.cuda.empty_cache()
    return {"tensors": n}


def graph_train(torch, np, pc, net, batch, steps, label, mode="pallas",
                hw=None):
    """`steps` steps of the graph `net` at `batch` through
    run_group(GROUP_K) on one fixed seeded batch on the card
    (timed_steps: ms/step, img/s, MFU from the layer shapes, idle share,
    peak memory, top kernels), launches per step by kernel and route
    against path_launches, a finite loss that falls. Returns (readings,
    the batch)."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    ((x, y),) = [(torch.from_numpy(a).to(DEV), torch.from_numpy(b).to(DEV))
                 for a, b in engine_batches(np, 63, 1, batch, 1000, hw)]
    prog = StepProgram(net)
    xs, ys = torch.stack([x] * GROUP_K), torch.stack([y] * GROUP_K)
    macs = macs_per_image(net)
    r, losses = timed_steps(
        torch, prog, "group", lambda: prog.run_group(xs, ys), steps=steps,
        warmup=1, batch=batch, macs=macs,
        profile_steps=ZOO_PROFILE_STEPS, on_start=pc.reset_launch_counts,
        on_end=lambda: {"counts": pc.launch_counts()})
    counts = r["launches"] = r.pop("counts")
    r["launches_per_step"] = {k: v / steps for k, v in counts.items() if v}
    vals = [float(v) for v in losses]
    r.update(macs_per_image=macs, loss_first=vals[0], loss_last=vals[-1])
    log(f"{label} {mode}" + timed_line(r, "group", batch, steps)
        + f" ({macs / 1e9:.4f}e9 multiply-adds per image); launches per "
        f"step {r['launches_per_step']}; loss {vals[0]:.4f} -> "
        f"{vals[-1]:.4f}; top kernels (ms per step): " + ", ".join(
            f"{n} {t:.3f}" for n, t in r["top_kernels"]))
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"{label} {mode}: loss not finite and falling: {vals}")
    want = (path_launches(pc, net, batch, True) if mode == "pallas"
            else {k: 0 for k in counts})
    check_launches(f"{label} {mode}", counts,
                   {k: v * steps for k, v in want.items()})
    del prog
    return r, (x, y)


def zoo_train(torch, np, pc, cls, hw, steps, label, mode="pallas"):
    """`steps` steps of `cls` at ZOO_BATCH through run_group(GROUP_K)
    (graph_train). Returns (readings, the net, the batch)."""
    net = zoo_net(cls, mode, hw=hw)
    r, batch = graph_train(torch, np, pc, net, ZOO_BATCH, steps, label, mode,
                           hw)
    return r, net, batch


def zoo_googlenet(torch, np, pc, GoogLeNet, det, worst):
    """GoogLeNet at full width (ZOO_HW, 1000 classes, bf16, "pallas", zoo
    defaults, batch ZOO_BATCH): the forward against "fused"; its kernel
    calls (a batch-BATCH forward, a batch-ZOO_BATCH train step) counted
    against the shapes and each distinct one against its plain version on
    both routes; every routed 1x1 backward of a batch-ZOO_CHECK_BATCH step
    against the composed backward; the replay check; ZOO_STEPS timed steps
    under "pallas" and "fused"; the kernel calls timed (card, plain,
    library, bound), summed per route."""
    hw = ZOO_HW["GoogLeNet"]
    out = {}
    net = zoo_net(GoogLeNet, "pallas")
    randomize_batchnorm(torch, net, seed=3, hw=hw)
    out["logp_gap"] = zoo_forward_check(torch, np, net, hw, "zoo GoogLeNet",
                                        "GoogLeNet")
    x32 = torch.from_numpy(serving_inputs(np, np.random.default_rng(14),
                                          BATCH, hw)).to(DEV)
    fcalls = record_kernel_calls(torch, pc, lambda: net.output(x32))
    check_launches("zoo GoogLeNet forward", calls_by_route(pc, fcalls),
                   path_launches(pc, net, BATCH, False))
    del net
    torch.cuda.empty_cache()

    train, tnet, (x, y) = zoo_train(torch, np, pc, GoogLeNet, hw, ZOO_STEPS,
                                    "zoo GoogLeNet")
    out["train"] = train
    tcalls = record_kernel_calls(torch, pc,
                                 lambda: tnet.fit_batch(([x], [y])))
    check_launches("zoo GoogLeNet train step", calls_by_route(pc, tcalls),
                   path_launches(pc, tnet, ZOO_BATCH, True))
    out["checked"] = zoo_kernel_checks(torch, pc, fcalls + backward_calls(
        tcalls), "zoo GoogLeNet kernels", worst)
    # the routed 1x1 backwards of one step at ZOO_CHECK_BATCH (bf16)
    twin = twin_of(tnet, "pallas", torch.bfloat16)
    del tnet
    torch.cuda.empty_cache()
    xb, yb = x[:ZOO_CHECK_BATCH], y[:ZOO_CHECK_BATCH]
    routes = routed_backward_check(torch, pc,
                                   lambda: twin.fit_batch(([xb], [yb])))
    want = path_launches(pc, twin, ZOO_CHECK_BATCH, True)["dgrad_conv1x1"]
    route_worst = {k: max(c[k] for c in routes if k in c)
                   for k in BWD_OUTPUTS if any(k in c for c in routes)}
    log(f"zoo GoogLeNet step check, bf16, batch {ZOO_CHECK_BATCH}: "
        f"{len(routes)} routed 1x1 backwards against the composed backward, "
        "worst " + " ".join(f"{k}={v:.2e}" for k, v in route_worst.items())
        + f" (limit {ROUTE_TOL['bfloat16']:.3g})")
    if len(routes) != want or \
            max(route_worst.values()) > ROUTE_TOL["bfloat16"]:
        fail("zoo GoogLeNet: a routed 1x1 backward departs from the "
             "composed backward")
    out["route_worst"] = route_worst
    del twin
    torch.cuda.empty_cache()
    out["group_check"] = zoo_group_check(torch, np, GoogLeNet, hw, det)
    out["fused"], fnet, _ = zoo_train(torch, np, pc, GoogLeNet, hw,
                                      ZOO_STEPS, "zoo GoogLeNet", "fused")
    del fnet
    torch.cuda.empty_cache()
    out["pallas_over_fused_ms"] = (train["ms_per_step"]
                                   / out["fused"]["ms_per_step"])
    out["kernel_calls"] = {"forward": len(fcalls), "step": len(tcalls)}
    for what, cs in (("forward", fcalls), ("step", tcalls)):
        _, rows = timing_phase(torch, pc, cs)
        sums = out[f"{what}_route_sums"] = route_sums(rows)
        for k, t in sums.items():
            log(f"zoo GoogLeNet {what} at batch "
                f"{BATCH if what == 'forward' else ZOO_BATCH}, {k} summed "
                f"over its {t['calls']} calls: {t['ms']:.3f} ms (bound "
                f"{t['bound_ms']:.3f} ms, {t['ms'] / t['bound_ms']:.1f}x; "
                f"plain {t['plain_ms']:.3f} ms; library "
                f"{t['library_ms']:.3f} ms)")
    return out


def embedding_norms(torch, net, x):
    """L2 norms of the "embeddings" vertex's rows under the bf16 policy."""
    from deeplearning4j_tpu_torch.nn.dtype import cast_floating

    with torch.inference_mode():
        cd = net.compute_dtype
        acts, _, _ = net._forward(net._compute_params(), net.states,
                                  {"input": cast_floating(x, cd)})
        return acts["embeddings"].float().norm(dim=1)


def zoo_embedding_net(torch, np, pc, cls, worst):
    """InceptionResNetV1 or FaceNetNN4Small2 at full width (ZOO_HW), as
    GoogLeNet otherwise: the forward against "fused", the kernel calls
    counted and checked on both routes, ZOO_SMALL_STEPS timed steps, the
    embedding rows' norms (1 within EMBED_NORM_TOL) and the center-loss
    centers moving per step."""
    name = cls.__name__
    hw = ZOO_HW[name]
    out = {}
    net = zoo_net(cls, "pallas")
    randomize_batchnorm(torch, net, seed=4, hw=hw)
    out["logp_gap"] = zoo_forward_check(torch, np, net, hw, f"zoo {name}",
                                        name)
    x32 = torch.from_numpy(serving_inputs(np, np.random.default_rng(15),
                                          BATCH, hw)).to(DEV)
    norms = embedding_norms(torch, net, x32)
    out["embedding_norm_err"] = float((norms - 1.0).abs().max())
    log(f"zoo {name}: {BATCH} embedding rows (bf16), max |norm - 1| = "
        f"{out['embedding_norm_err']:.3e} (limit {EMBED_NORM_TOL:g})")
    if out["embedding_norm_err"] > EMBED_NORM_TOL:
        fail(f"zoo {name}: embeddings are not L2-normalized")
    fcalls = record_kernel_calls(torch, pc, lambda: net.output(x32))
    check_launches(f"zoo {name} forward", calls_by_route(pc, fcalls),
                   path_launches(pc, net, BATCH, False))
    del net
    torch.cuda.empty_cache()
    out["train"], tnet, (x, y) = zoo_train(torch, np, pc, cls, hw,
                                           ZOO_SMALL_STEPS, f"zoo {name}")
    head = tnet.conf.network_outputs[0]
    c0 = tnet._params_view()[head]["centers"].clone()
    tcalls = record_kernel_calls(torch, pc,
                                 lambda: tnet.fit_batch(([x], [y])))
    moved = float((tnet._params_view()[head]["centers"] - c0).abs().max())
    log(f"zoo {name}: the center-loss centers move by {moved:.3e} in one "
        "step")
    if not moved > 0:
        fail(f"zoo {name}: the centers did not move")
    check_launches(f"zoo {name} train step", calls_by_route(pc, tcalls),
                   path_launches(pc, tnet, ZOO_BATCH, True))
    out["checked"] = zoo_kernel_checks(torch, pc, fcalls + backward_calls(
        tcalls), f"zoo {name} kernels", worst)
    del tnet
    torch.cuda.empty_cache()
    return out


def zoo_selector(torch, ModelSelector):
    """ModelSelector.select("cnn"): every CNN zoo model built on the card
    at its own full input size (bf16 policy), one forward at batch 1 of
    the right shape and finite."""
    out = {}
    for name, model in ModelSelector.select("cnn",
                                            compute_dtype="bfloat16").items():
        net = model.init_model(device=DEV)
        x = torch.zeros((1,) + tuple(model.input_shape), device=DEV)
        y = net.output(x)
        shape = tuple(y.shape)
        if shape != (1, model.num_classes) or not torch.isfinite(y).all():
            fail(f"zoo select cnn: {name} gave {shape}")
        out[name] = {"input": list(model.input_shape), "output": list(shape),
                     "params": net.num_params()}
        del net
    torch.cuda.empty_cache()
    log("zoo ModelSelector.select('cnn'): " + ", ".join(
        f"{n} {v['input']} -> {v['output']} ({v['params']:,} params)"
        for n, v in out.items()))
    return out


def tl_resnet(torch, np, pc, ResNet50, card, full_ms, det, tmp):
    """TransferLearning.GraphBuilder on the flagship ResNet-50 (bf16,
    "pallas", batch TRAIN_BATCH): everything up to "s4b5_out" frozen,
    nesterovs at 1e-3 (a FineTuneConfiguration). TL_STEPS steps through
    run_group(GROUP_K) on one fixed batch; every frozen param bit for
    bit, the stage-5 and head params moved; launches per step 30/16/5/5
    (derived from the shapes, too); ms/step against phase 5b's full step;
    write_model, then ModelGuesser.load_model_guess on the card: the
    reloaded net scores the same bits."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration,
        TransferLearning,
    )
    from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
    from deeplearning4j_tpu_torch.util.model_serializer import write_model

    src = flagship(ResNet50, "pallas")
    net = (TransferLearning.GraphBuilder(src)
           .fine_tune_configuration(FineTuneConfiguration.Builder()
                                    .updater("nesterovs").learning_rate(1e-3)
                                    .build())
           .set_feature_extractor("s4b5_out").build())
    del src
    frozen = net._frozen()
    before = {k: [t.clone() for t in v.values()]
              for k, v in net.params.items()}
    ((x, y),) = [(torch.from_numpy(a).to(DEV), torch.from_numpy(b).to(DEV))
                 for a, b in engine_batches(np, 65, 1, TRAIN_BATCH, 1000)]
    prog = StepProgram(net)
    xs, ys = torch.stack([x] * GROUP_K), torch.stack([y] * GROUP_K)
    r, losses = timed_steps(
        torch, prog, "group", lambda: prog.run_group(xs, ys), steps=TL_STEPS,
        warmup=1, batch=TRAIN_BATCH, macs=macs_per_image(net),
        profile_steps=ZOO_PROFILE_STEPS, on_start=pc.reset_launch_counts,
        on_end=lambda: {"counts": pc.launch_counts()})
    counts = r["launches"] = r.pop("counts")
    per_step = {k: counts[k] / TL_STEPS for k in pc.LAUNCHES}
    (per_replay,) = prog.group_launches().values() or ({},)
    r.update(launches_per_step=per_step,
             launches_per_replay={k: v for k, v in per_replay.items()
                                  if "/" not in k},
             ratio_to_full_step=r["ms_per_step"] / full_ms,
             frozen_layers=len(frozen))
    vals = [float(v) for v in losses]
    r["loss_first"], r["loss_last"] = vals[0], vals[-1]
    want = {"fused_conv1x1": 30, "fused_conv3x3": 16, "dgrad_conv1x1": 5,
            "wgrad_conv1x1": 5}
    derived = path_launches(pc, net, TRAIN_BATCH, True)
    log(f"tl ResNet-50, frozen through s4b5_out ({len(frozen)} of "
        f"{len(net.params)} layers)" + timed_line(r, "group", TRAIN_BATCH,
                                                   TL_STEPS)
        + f"; {r['ratio_to_full_step']:.3f}x phase 5b's full step "
        f"({full_ms:.2f} ms); launches per step {per_step} (full step "
        f"30/16/30/30), per replay {r['launches_per_replay']}; loss "
        f"{vals[0]:.4f} -> {vals[-1]:.4f} [{card}]")
    if per_step != want or any(derived[k] != v for k, v in want.items()):
        fail(f"tl ResNet-50: launches per step {per_step} (derived "
             f"{derived}) != {want}")
    check_launches("tl ResNet-50", counts,
                   {k: v * TL_STEPS for k, v in derived.items()})
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"tl ResNet-50: loss not finite and falling: {vals}")
    params = net._params_view()
    changed = {k for k, ts in before.items()
               if any(not bits_equal(torch, a, b)
                      for a, b in zip(ts, params[k].values()))}
    trainable = {k for k in before if k not in frozen and before[k]}
    r["frozen_bitwise"] = not (changed & frozen)
    r["moved"] = sorted(changed)
    log(f"tl ResNet-50: frozen params bit for bit {r['frozen_bitwise']}; "
        f"{len(changed)} of {len(trainable)} trainable layers moved")
    if changed & frozen or changed != trainable:
        fail(f"tl ResNet-50: frozen params moved ({sorted(changed & frozen)}"
             f") or trainable ones did not ({sorted(trainable - changed)})")
    path = os.path.join(tmp, "tl_resnet50.zip")
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = det
    try:
        write_model(net, path)
        back = ModelGuesser.load_model_guess(path, device=DEV,
                                             compute_dtype=net.compute_dtype)
        batch = ([x[:ZOO_CHECK_BATCH]], [y[:ZOO_CHECK_BATCH]])
        s0, s1 = net.score(batch), back.score(batch)
    finally:
        torch.backends.cudnn.deterministic = old
    r.update(zip_bytes=os.path.getsize(path), score=s0, reloaded_score=s1)
    log(f"tl ResNet-50: write_model ({r['zip_bytes']} bytes), "
        f"ModelGuesser.load_model_guess on the card ({type(back).__name__}, "
        f"{len(back._frozen())} frozen layers): score {s0!r} against "
        f"{s1!r}")
    if s0 != s1 or back._frozen() != frozen:
        fail("tl ResNet-50: the reloaded net scores other bits")
    del net, back, prog
    torch.cuda.empty_cache()
    return r


def tl_vgg16(torch, np, pc, VGG16, card):
    """BASELINE config 4 without the Keras import: the zoo's VGG16 (bf16,
    phase 5c's input scale and rate) through TransferLearning.Builder,
    frozen through its last pooling layer, the head's width replaced
    (n_out_replace, VGG_TL_CLASSES); frozen-base against full fine-tune
    ms/step at VGG_TL_BATCH through run_group(GROUP_K) (bench_vgg16's two
    numbers). Then TransferLearningHelper: featurize once on the card,
    fit_featurized, against a fit of the frozen net on the same batches:
    the tail's params within TL_HELPER_TOL."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearning,
        TransferLearningHelper,
    )
    from deeplearning4j_tpu_torch.util.tree import leaves

    src = vgg16(VGG16)
    layers = src.conf.layers
    last_pool = max(i for i, l in enumerate(layers)
                    if isinstance(l, SubsamplingLayer))
    head = len(layers) - 1

    def build(freeze):
        b = TransferLearning.Builder(src).n_out_replace(head, VGG_TL_CLASSES)
        return (b.set_feature_extractor(last_pool) if freeze else b).build()

    data = mln_batches(np, 67, GROUP_K, VGG_TL_BATCH, VGG_TL_CLASSES)
    xs = torch.stack([torch.from_numpy(d[0]) for d in data]).to(DEV)
    ys = torch.stack([torch.from_numpy(d[1]) for d in data]).to(DEV)
    out = {"last_pool": last_pool, "classes": VGG_TL_CLASSES}
    for kind in ("frozen", "full"):
        net = build(kind == "frozen")
        prog = StepProgram(net)
        r, losses = timed_steps(
            torch, prog, "group", lambda: prog.run_group(xs, ys),
            steps=VGG_TL_STEPS, warmup=1, batch=VGG_TL_BATCH,
            macs=macs_per_image(net), profile_steps=ZOO_PROFILE_STEPS)
        vals = [float(v) for v in losses]
        r.update(loss_first=vals[0], loss_last=vals[-1],
                 frozen_layers=len(net._frozen()))
        out[kind] = r
        log(f"tl VGG16 {kind}" + timed_line(r, "group", VGG_TL_BATCH,
                                            VGG_TL_STEPS)
            + f"; {r['frozen_layers']} frozen layers; loss {vals[0]:.4f} -> "
            f"{vals[-1]:.4f} [{card}]")
        if not all(np.isfinite(vals)):
            fail(f"tl VGG16 {kind}: non-finite loss {vals}")
        del net, prog
        torch.cuda.empty_cache()
    out["frozen_over_full_ms"] = (out["frozen"]["ms_per_step"]
                                  / out["full"]["ms_per_step"])
    log(f"tl VGG16: frozen base {out['frozen']['ms_per_step']:.2f} ms/step, "
        f"full fine-tune {out['full']['ms_per_step']:.2f} ms/step "
        f"({out['frozen_over_full_ms']:.3f}x) at batch {VGG_TL_BATCH}")
    # featurize once, fit the tail; against the frozen net's own fit
    a, b = build(True), build(True)
    del src
    helper = TransferLearningHelper(a, frozen_up_to=last_pool)
    t0 = time.perf_counter()
    feats = [(helper.featurize(x), y) for x, y in zip(xs, ys)]
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    helper.fit_featurized(feats)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    b.fit(list(zip(xs, ys)))
    tail = slice(last_pool + 1, None)
    errs = [norm_err(p, q) for p, q in zip(leaves(a.params[tail]),
                                           leaves(b.params[tail]))]
    out["helper"] = {"featurize_s": t_feat, "fit_featurized_s": t_fit,
                     "tail_err": max(errs), "batches": len(feats)}
    log(f"tl VGG16 TransferLearningHelper: featurize {len(feats)} batches "
        f"{t_feat:.3f} s, fit_featurized {t_fit:.3f} s; the tail's params "
        f"against the frozen net's fit on the same batches: max error "
        f"{max(errs):.3e} (limit {TL_HELPER_TOL:g})")
    if max(errs) > TL_HELPER_TOL:
        fail("tl VGG16: fit_featurized departs from the frozen net's fit")
    del a, b, helper, feats
    torch.cuda.empty_cache()
    return out


def solver_phase(torch, np, LeNet, card):
    """LeNet at MNIST width (28x28x1, 10 classes; BASELINE config 1), f32,
    SOLVER_BATCH rows: SOLVER_ITERS iterations of each line-search solver
    on one seeded batch, timed by the host clock (a solver reads its
    losses on the host); a finite falling loss."""
    rng = np.random.default_rng(69)
    x = rng.normal(size=(SOLVER_BATCH, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, SOLVER_BATCH)]
    xt, yt = torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV)
    out = {}
    for algo in ("lbfgs", "conjugate_gradient", "line_gradient_descent"):
        model = LeNet()
        conf = model.conf()
        conf.optimization_algo = algo
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        net = MultiLayerNetwork(conf, device=DEV).init()
        net.fit_batch((xt, yt))           # builds the solver
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = [float(net.fit_batch((xt, yt)))
                for _ in range(SOLVER_ITERS)]
        ms = (time.perf_counter() - t0) * 1e3 / SOLVER_ITERS
        out[algo] = {"ms_per_iteration": ms, "losses": vals}
        log(f"solver {algo}: LeNet f32, batch {SOLVER_BATCH}, "
            f"{SOLVER_ITERS} iterations after one: {ms:.2f} ms per "
            f"iteration (host clock), loss {vals[0]:.4f} -> {vals[-1]:.4f} "
            f"[{card}]")
        if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
            fail(f"solver {algo}: loss not finite and falling: {vals}")
        del net
    return out


def pretrain_data(np, seed):
    """PRETRAIN_BATCHES seeded batches of 28x28 binary images, each a few
    lit rows and columns (structure an RBM can model), flattened to 784,
    with one-hot labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PRETRAIN_BATCHES):
        img = np.zeros((PRETRAIN_BATCH, 28, 28), np.float32)
        for i in range(PRETRAIN_BATCH):
            img[i, rng.integers(0, 28, 2), :] = 1.0
            img[i, :, rng.integers(0, 28, 2)] = 1.0
        out.append((img.reshape(PRETRAIN_BATCH, 784),
                    np.eye(10, dtype=np.float32)[
                        rng.integers(0, 10, PRETRAIN_BATCH)]))
    return out


def pretrain_phase(torch, np, card):
    """An MLN of RBM 784->500, AutoEncoder 500->250, VAE 250->(latent 32)
    and a softmax head, `pretrain` for PRETRAIN_EPOCHS epochs of
    PRETRAIN_BATCHES batches of PRETRAIN_BATCH on the card: each layer's
    pretrain loss (recorded per step) falls (the mean of its last 4
    steps under the mean of its first 4)."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM,
        AutoEncoder,
        OutputLayer,
        VariationalAutoencoder,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(71).updater("adam")
            .learning_rate(1e-3).weight_init("xavier").list()
            .layer(RBM(n_out=500))
            .layer(AutoEncoder(n_out=250))
            .layer(VariationalAutoencoder(n_out=32, latent_size=32,
                                          encoder_layer_sizes=(128,),
                                          decoder_layer_sizes=(128,),
                                          reconstruction_distribution=
                                          "bernoulli"))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    net = MultiLayerNetwork(conf, device=DEV).init()
    seen = {}
    for i, layer in enumerate(net.conf.layers[:-1]):
        orig = layer.pretrain_loss

        def rec(p, x, g, orig=orig, i=i):
            v = orig(p, x, g)
            seen.setdefault(i, []).append(v.detach())
            return v

        layer.pretrain_loss = rec
    data = [(torch.from_numpy(a).to(DEV), torch.from_numpy(b).to(DEV))
            for a, b in pretrain_data(np, 72)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(data, epochs=PRETRAIN_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"seconds": wall, "steps_per_layer": PRETRAIN_EPOCHS
           * PRETRAIN_BATCHES}
    for i, vals in seen.items():
        vals = [float(v) for v in vals]
        name = type(net.conf.layers[i]).__name__
        first, last = float(np.mean(vals[:4])), float(np.mean(vals[-4:]))
        out[name] = {"first": vals[0], "last": vals[-1], "first4": first,
                     "last4": last}
        log(f"pretrain {name}: {len(vals)} steps, loss {vals[0]:.4f} -> "
            f"{vals[-1]:.4f} (mean of the first 4 {first:.4f}, of the last "
            f"4 {last:.4f})")
        if not all(np.isfinite(vals)) or not last < first:
            fail(f"pretrain {name}: loss not finite and falling: {vals}")
    log(f"pretrain: {PRETRAIN_EPOCHS} epochs of {PRETRAIN_BATCHES} batches "
        f"of {PRETRAIN_BATCH}, 3 layers, {wall:.2f} s (host clock) [{card}]")
    return out


def zoo_phase(torch, np, pc, card, engine, tmp):
    """Phase 5g: the graph zoo, transfer learning, the solvers and
    pretraining (lines start "zoo ", "tl ", "solver ", "pretrain ").
    Returns the readings, the launches of the zoo path (the three graphs'
    timed "pallas" steps) and of the TL path (the ResNet-50 transfer's
    timed steps), and the per-kernel worst errors of its kernel checks."""
    from deeplearning4j_tpu_torch.zoo import (
        VGG16,
        FaceNetNN4Small2,
        GoogLeNet,
        InceptionResNetV1,
        LeNet,
        ModelSelector,
        ResNet50,
    )

    det = engine["group_check"]["deterministic"]
    worst, out, secs = {}, {}, {}
    parts = [
        ("googlenet", lambda: zoo_googlenet(torch, np, pc, GoogLeNet, det,
                                            worst)),
        ("inceptionresnetv1", lambda: zoo_embedding_net(
            torch, np, pc, InceptionResNetV1, worst)),
        ("facenetnn4small2", lambda: zoo_embedding_net(
            torch, np, pc, FaceNetNN4Small2, worst)),
        ("select_cnn", lambda: zoo_selector(torch, ModelSelector)),
        ("tl_resnet50", lambda: tl_resnet(
            torch, np, pc, ResNet50, card,
            engine["pallas"]["group"]["ms_per_step"], det, tmp)),
        ("tl_vgg16", lambda: tl_vgg16(torch, np, pc, VGG16, card)),
        ("solvers", lambda: solver_phase(torch, np, LeNet, card)),
        ("pretrain", lambda: pretrain_phase(torch, np, card)),
    ]
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        secs[name] = time.perf_counter() - t0
    # the zoo path: the three graphs' timed "pallas" steps; the TL path:
    # the ResNet-50 transfer's
    zoo_launches = {k: sum(out[m]["train"]["launches"][k]
                           for m in ("googlenet", "inceptionresnetv1",
                                     "facenetnn4small2"))
                    for k in pc.launch_counts()}
    tl_launches = out["tl_resnet50"]["launches"]
    out.update(seconds=secs, zoo_launches=zoo_launches,
               tl_launches=tl_launches, worst=worst)
    log(f"zoo phase: launches on the zoo path {zoo_launches}, on the TL "
        f"path {tl_launches}; seconds per part "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out


# ------------------------------------------------------------ phase 5h
# A minimal HDF5 writer (the file format specification's superblock v0,
# version 1 object headers, symbol-table groups, contiguous datasets):
# the script needs no h5py, and phase 5h imports full-width Keras files
# whose weights (553 MB for VGG16) it makes at run time from a seed.
H5_UNDEF = 0xFFFFFFFFFFFFFFFF
H5_INTERNAL_K = 16


def _h5_pad8(b):
    return bytes(b) + b"\0" * (-len(b) % 8)


def _h5_dtype(a):
    """The datatype message of a float32, float64 or int64 array: little
    endian IEEE floats (implied leading mantissa bit, sign bit on top) or
    a signed 64-bit integer."""
    if a.dtype.kind == "i":
        return struct.pack("<B3sIHH", 0x10, b"\x08\0\0", 8, 0, 64)
    n = a.dtype.itemsize
    exp_at, exp_bits, bias = {4: (23, 8, 127), 8: (52, 11, 1023)}[n]
    bits = (0x20 | ((8 * n - 1) << 8)).to_bytes(3, "little")
    return struct.pack("<B3sIHHBBBBI", 0x11, bits, n, 0, 8 * n, exp_at,
                       exp_bits, 0, exp_at, bias)


def _h5_space(shape):
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _h5_msg(mtype, body):
    body = _h5_pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _h5_groups(tree):
    yield tree
    for v in tree["members"].values():
        if isinstance(v, dict):
            yield from _h5_groups(v)


def write_keras_h5(np, path, tree):
    """Write `tree` ({"attrs": {...}, "members": {name: tree | array}})
    as an HDF5 file: the arrays (float32, float64 or int64) as contiguous
    datasets written straight from memory, then the metadata — each group
    one B-tree node over one symbol table node (the leaf K large enough
    for the largest group), a local heap of names, and a version 1 object
    header with its attributes. An attribute is a str (a variable-length
    UTF-8 string in the global heap, as Keras writes model_config), a
    list of str (fixed-length null-padded strings, as Keras 2 wrote
    layer_names) or a numpy array. Returns the dataset bytes written."""
    groups = list(_h5_groups(tree))
    leaf_k = max(4, max((len(g["members"]) + 1) // 2 for g in groups))
    strings = [v.encode() for g in groups for v in g["attrs"].values()
               if isinstance(v, str)]
    arrays = [a for g in groups for a in g["members"].values()
              if not isinstance(a, dict)]
    with open(path, "wb") as f:
        f.write(b"\0" * 96)                    # the superblock, at the end
        data_at = {}
        for a in arrays:
            f.write(b"\0" * (-f.tell() % 64))
            data_at[id(a)] = f.tell()
            np.ascontiguousarray(a).tofile(f)
        f.write(b"\0" * (-f.tell() % 8))
        base, meta = f.tell(), bytearray()

        def alloc(b):
            addr = base + len(meta)
            meta.extend(_h5_pad8(b))
            return addr

        # the global heap collection: every variable-length string, from
        # index 1, then the free-space object (its size counts its header)
        objs = b"".join(struct.pack("<HH4xQ", i, 1, len(s)) + _h5_pad8(s)
                        for i, s in enumerate(strings, 1))
        size = max(4096, 16 + len(objs) + 16)
        free = size - 16 - len(objs)
        gcol = alloc(b"GCOL" + struct.pack("<B3xQ", 1, size) + objs
                     + struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16))

        def attr(name, value):
            if isinstance(value, str):
                raw = value.encode()
                dt = (struct.pack("<B3sI", 0x19, b"\x01\x01\0", 16)
                      + struct.pack("<B3sIHH", 0x10, b"\0\0\0", 1, 0, 8))
                space = _h5_space(())
                data = struct.pack("<IQI", len(raw), gcol,
                                   strings.index(raw) + 1)
            elif isinstance(value, list):
                enc = [s.encode() for s in value]
                n = max([len(s) for s in enc] + [1])
                dt = struct.pack("<B3sI", 0x13, b"\x01\0\0", n)
                space = _h5_space((len(enc),))
                data = b"".join(s.ljust(n, b"\0") for s in enc)
            else:
                a = np.ascontiguousarray(value)
                dt, space, data = _h5_dtype(a), _h5_space(a.shape), a.tobytes()
            nb = name.encode() + b"\0"
            return _h5_msg(0x000C, struct.pack(
                "<BxHHH", 1, len(nb), len(dt), len(space)) + _h5_pad8(nb)
                + _h5_pad8(dt) + _h5_pad8(space) + data)

        def header(msgs):
            body = b"".join(msgs)
            return alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                     len(body)) + body)

        def group(t):
            """Write group `t` bottom up: (header, B-tree, local heap)."""
            names = sorted(t["members"], key=str.encode)
            entries = []
            for name in names:
                v = t["members"][name]
                if isinstance(v, dict):
                    hdr, bt, hp = group(v)
                    entries.append((name, hdr, 1, struct.pack("<QQ", bt, hp)))
                else:
                    hdr = header([
                        _h5_msg(0x0001, _h5_space(v.shape)),
                        _h5_msg(0x0003, _h5_dtype(v)),
                        _h5_msg(0x0005, bytes([2, 1, 2, 0])),
                        _h5_msg(0x0008, struct.pack("<BBQQ", 3, 1,
                                                    data_at[id(v)], v.nbytes))])
                    entries.append((name, hdr, 0, b"\0" * 16))
            heap_data, offsets = bytearray(8), {}
            for name in names:
                offsets[name] = len(heap_data)
                heap_data.extend(_h5_pad8(name.encode() + b"\0"))
            # free-list offset 1: the library's "no free block"
            heap = alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                               1, alloc(heap_data)))
            child = last = 0
            if names:
                child = alloc(
                    b"SNOD" + struct.pack("<BxH", 1, len(names))
                    + b"".join(struct.pack("<QQI4x", offsets[n], h, c) + s
                               for n, h, c, s in entries)
                    + b"\0" * (40 * (2 * leaf_k - len(names))))
                last = offsets[names[-1]]
            btree = alloc(b"TREE" + struct.pack(
                "<BBHQQQQQ", 0, 0, 1 if names else 0, H5_UNDEF, H5_UNDEF, 0,
                child, last) + b"\0" * (32 * H5_INTERNAL_K - 16))
            return (header([_h5_msg(0x0011, struct.pack("<QQ", btree, heap))]
                           + [attr(k, v) for k, v in t["attrs"].items()]),
                    btree, heap)

        root, btree, heap = group(tree)
        f.write(meta)
        eof = f.tell()
        f.seek(0)
        f.write(b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", leaf_k, H5_INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, H5_UNDEF, eof, H5_UNDEF)
                + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
    return sum(a.nbytes for a in arrays)


def keras_h5_tree(np, model_config, weights):
    """The tree `write_keras_h5` writes for a whole-model Keras file, in
    tf.keras 2's layout: the model_config JSON text on the root,
    model_weights with a layer_names attribute and one group per layer,
    its weights at <layer>/<layer>/<weight>:0 and named in its
    weight_names attribute ("<layer>/<weight>:0"; an empty float64 array
    where it has none). `weights`: {layer: {weight: array}} for every
    layer, in order."""
    mw = {"attrs": {"layer_names": list(weights), "backend": "tensorflow",
                    "keras_version": "2.15.0"}, "members": {}}
    for layer, ws in weights.items():
        names = [f"{layer}/{w}:0" for w in ws]
        mw["members"][layer] = {
            "attrs": {"weight_names": names if names else np.zeros(0)},
            "members": ({layer: {"attrs": {}, "members": {
                f"{w}:0": a for w, a in ws.items()}}} if ws else {})}
    return {"attrs": {"model_config": model_config,
                      "backend": "tensorflow", "keras_version": "2.15.0"},
            "members": {"model_weights": mw}}


def keras_config(name, hw=224):
    """The committed tf.keras model_config JSON text of
    tests/fixtures/torch/keras_<name>_config.json; for an `hw` other than
    the configurations' 224, its input layer's image size replaced (a CPU
    rehearsal's smaller image)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "torch", f"keras_{name}_config.json")
    with open(path) as f:
        text = f.read()
    if hw == 224:
        return text
    cfg = json.loads(text)

    def rescale(v, old):
        # the tensor shapes Keras 3 records on a Flatten's inbound node
        if isinstance(v, dict):
            if isinstance(v.get("shape"), list) and len(v["shape"]) == 4:
                v["shape"][1:3] = [d * hw // old for d in v["shape"][1:3]]
            for u in v.values():
                rescale(u, old)
        elif isinstance(v, list):
            for u in v:
                rescale(u, old)

    for layer in cfg["config"]["layers"]:
        if layer["class_name"] == "InputLayer":
            old = layer["config"]["batch_shape"][1]
            layer["config"]["batch_shape"][1:3] = [hw, hw]
        elif layer["class_name"] == "Flatten":
            rescale(layer["inbound_nodes"], old)
    return json.dumps(cfg)


def keras_weights(np, text, seed):
    """Seeded weights for every layer of a Keras model_config, in its
    order and with Keras's weight names: convolution and dense kernels
    He-normal (std sqrt(2 / fan_in)), zero biases; BatchNormalization
    gamma 1, beta 0, moving mean 0, moving variance 1. Shapes come from
    the port's import of the configuration alone."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.h5")
        write_keras_h5(np, path, {"attrs": {"model_config": text},
                                  "members": {}})
        conf = KerasModelImport.import_keras_model_configuration(path)
    conf.resolve_shapes()
    rng = np.random.default_rng(seed)
    out = {}
    for lc in json.loads(text)["config"]["layers"]:
        name, cls, c = lc["config"]["name"], lc["class_name"], lc["config"]
        ws = out[name] = {}
        if cls in ("Conv2D", "Dense"):
            layer = conf.node(name).obj
            shape = ((*layer.kernel_size, layer.n_in, layer.n_out)
                     if cls == "Conv2D" else (layer.n_in, layer.n_out))
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            ws["kernel"] = (rng.standard_normal(shape, np.float32)
                            * np.float32(std))
            if c.get("use_bias", True):
                ws["bias"] = np.zeros(shape[-1], np.float32)
        elif cls == "BatchNormalization":
            n = conf.node(name).obj.n_out
            ws.update(gamma=np.ones(n, np.float32), beta=np.zeros(n, np.float32),
                      moving_mean=np.zeros(n, np.float32),
                      moving_variance=np.ones(n, np.float32))
    return out


KERAS_PARAM = {"kernel": "W", "bias": "b", "gamma": "gamma", "beta": "beta"}
KERAS_STATE = {"moving_mean": "mean", "moving_variance": "var"}


def keras_bits_check(torch, net, weights):
    """(weights compared, weights that differ): every array written into
    the file against the imported net's param or BN state."""
    n = bad = 0
    params = net.params
    for layer, ws in weights.items():
        for w, a in ws.items():
            got = (params[layer][KERAS_PARAM[w]] if w in KERAS_PARAM
                   else net.states[layer][KERAS_STATE[w]])
            n += 1
            bad += not bits_equal(torch, got.cpu(), torch.from_numpy(a))
    return n, bad


def keras_import(torch, np, name, seed, tmp):
    """Write the Keras file of `name` (its committed config, seeded
    weights) into `tmp`, import it on the card and check every weight bit
    for bit. Returns (net, readings)."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport

    text = keras_config(name, HW)
    weights = keras_weights(np, text, seed)
    path = os.path.join(tmp, f"keras_{name}.h5")
    t0 = time.perf_counter()
    nbytes = write_keras_h5(np, path, keras_h5_tree(np, text, weights))
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_model_and_weights(
        path, device=DEV, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n, bad = keras_bits_check(torch, net, weights)
    r = {"file_bytes": os.path.getsize(path), "weight_bytes": nbytes,
         "write_s": write_s, "import_s": secs,
         "import_gb_per_s": os.path.getsize(path) / secs / 1e9,
         "params": net.num_params(), "weights_checked": n,
         "weights_differ": bad}
    log(f"keras {name}: {r['file_bytes']} bytes written in {write_s:.2f} s "
        f"by the script's HDF5 writer; import_keras_model_and_weights onto "
        f"the card in {secs:.3f} s ({r['import_gb_per_s']:.3f} GB/s of file), "
        f"{r['params']} params; {n} weights against what was written: {bad} "
        "differ")
    if bad or not n:
        fail(f"keras {name}: imported weights differ from the file's")
    os.remove(path)
    return net, r


def unit_activations(torch, net, x):
    """Rescale each weight layer of the graph `net` in turn (topological
    order) so that on the batch `x` its relu outputs have a second moment
    of 1/2 (unit-variance pre-activations) and the output layer's logits
    a unit spread: a seeded random VGG16's max pools would otherwise
    grow the activations tenfold and saturate the softmax."""
    names = [n.name for n in net.topo if n.kind == "layer"
             and "W" in net.params[n.name]]
    out_name = net.conf.network_outputs[0]
    with torch.no_grad():
        for name in names:
            params = net.params
            acts = net.feed_forward(x)
            if name == out_name:
                feats = acts[net.conf.node(name).inputs[0]].float()
                s = float((feats @ params[name]["W"]
                           + params[name]["b"]).std())
            else:
                s = float((2.0 * acts[name].float().pow(2).mean()).sqrt())
            params[name] = {k: v / s for k, v in params[name].items()}
            net.params = params


def keras_fixtures(torch, np):
    """The seven committed Keras fixtures read by the port's HDF5 reader
    (without h5py) and imported onto the card in f32, against
    their expected outputs at KERAS_TOL."""
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures")
    out = {}
    for name in KERAS_FIXTURES:
        path = os.path.join(fix, name + ".h5")
        exp = np.load(path.replace(".h5", "_expected.npz"))
        net = KerasModelImport.import_keras_model_and_weights(path,
                                                              device=DEV)
        got = net.output(exp["x"]).float().cpu().numpy()
        err = float(np.abs(got - exp["y"]).max())
        ok = bool(np.allclose(got, exp["y"], **KERAS_TOL))
        out[name] = {"type": type(net).__name__, "max_abs_err": err, "ok": ok}
        if not ok:
            fail(f"keras fixture {name}: output departs from Keras's "
                 f"(max abs error {err:.3e})")
    log("keras fixtures: " + ", ".join(
        f"{k} {v['type']} max abs error {v['max_abs_err']:.2e}"
        for k, v in out.items()) + f", each within rtol {KERAS_TOL['rtol']:g}"
        f" / atol {KERAS_TOL['atol']:g}")
    return out


def vgg_images(torch, np, seed, batch):
    """A seeded batch of 0-255 images (float32) and one-hot labels of
    1000 classes, on the card."""
    rng = np.random.default_rng(seed)
    hw = HW
    x = rng.uniform(0, 255, (batch, hw, hw, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)]
    return torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV)


def keras_vgg16(torch, np, card, seed, tmp):
    """BASELINE config 4: canonical Keras VGG16 (relu convolutions)
    imported from a whole-model .h5, VGG16ImagePreProcessor on 0-255
    images (no scaling), frozen through block5_pool against full
    fine-tune at KERAS_VGG_BATCH through run_group(GROUP_K) on one fixed
    batch; then the fine-tuned net written with its normalizer and read
    back, and the evaluations on the card against the CPU."""
    from deeplearning4j_tpu_torch.datasets import VGG16ImagePreProcessor
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.eval import (
        Evaluation,
        EvaluationCalibration,
        ROCMultiClass,
    )
    from deeplearning4j_tpu_torch.nn.transferlearning import TransferLearning
    from deeplearning4j_tpu_torch.util.model_serializer import (
        read_normalizer,
        restore_computation_graph,
        write_model,
    )

    net, out = keras_import(torch, np, "vgg16", seed, tmp)
    pre = VGG16ImagePreProcessor()
    x, y = vgg_images(torch, np, seed + 1, KERAS_VGG_BATCH)
    x = pre.transform(x)
    unit_activations(torch, net, pre.transform(
        vgg_images(torch, np, seed + 3, 8)[0]))
    xs, ys = torch.stack([x] * GROUP_K), torch.stack([y] * GROUP_K)
    macs = macs_per_image(net)
    frozen = (TransferLearning.GraphBuilder(net)
              .set_feature_extractor("block5_pool").build())
    names = sorted(frozen._frozen())
    before = {k: [t.clone() for t in frozen.params[k].values()]
              for k in names}
    for kind, model in (("frozen", frozen), ("full", net)):
        prog = StepProgram(model)
        r, losses = timed_steps(
            torch, prog, "group", lambda: prog.run_group(xs, ys),
            steps=KERAS_VGG_STEPS, warmup=1, batch=KERAS_VGG_BATCH,
            macs=macs, profile_steps=ZOO_PROFILE_STEPS)
        vals = [float(v) for v in losses]
        r.update(loss_first=vals[0], loss_last=vals[-1],
                 frozen_layers=len(model._frozen()))
        out[kind] = r
        log(f"keras VGG16 {kind}" + timed_line(r, "group", KERAS_VGG_BATCH,
                                               KERAS_VGG_STEPS)
            + f"; {r['frozen_layers']} frozen layers; loss {vals[0]:.4f} -> "
            f"{vals[-1]:.4f} [{card}]")
        if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
            fail(f"keras VGG16 {kind}: loss not finite and falling: {vals}")
        del prog
    same = all(bits_equal(torch, t, u) for k in names
               for t, u in zip(before[k], frozen.params[k].values()))
    convs = sum(1 for k in names if frozen.params[k])
    log(f"keras VGG16 frozen: {len(names)} frozen layers ({convs} with "
        f"params) bit for bit after {KERAS_VGG_STEPS + GROUP_K} steps: {same}")
    if not same or convs != 13:
        fail("keras VGG16: a frozen param moved, or the frozen prefix is not "
             "the 13 convolutions")
    del frozen, before
    torch.cuda.empty_cache()
    out["frozen_over_full_ms"] = (out["frozen"]["ms_per_step"]
                                  / out["full"]["ms_per_step"])
    # the fine-tuned net with its normalizer, written and read back
    held_x, held_y = vgg_images(torch, np, seed + 2, KERAS_VGG_BATCH)
    held_x = pre.transform(held_x)
    path = os.path.join(tmp, "vgg16_tuned.zip")
    t0 = time.perf_counter()
    write_model(net, path, normalizer=pre)
    write_s = time.perf_counter() - t0
    back = restore_computation_graph(path, device=DEV,
                                     compute_dtype=torch.bfloat16)
    norm = read_normalizer(path)
    probs = net.output(held_x)
    same_out = bits_equal(torch, probs, back.output(held_x))
    same_score = net.score((held_x, held_y)) == back.score((held_x, held_y))
    same_mean = (type(norm) is VGG16ImagePreProcessor
                 and np.array_equal(np.asarray(norm.mean, np.float32),
                                    pre.mean))
    out["zip"] = {"bytes": os.path.getsize(path), "write_s": write_s,
                  "same_output": same_out, "same_score": same_score,
                  "same_normalizer": same_mean}
    log(f"keras VGG16 write_model(normalizer=VGG16ImagePreProcessor): "
        f"{out['zip']['bytes']} bytes in {write_s:.2f} s; restored: output "
        f"bit for bit {same_out}, score equal {same_score}, read_normalizer "
        f"mean equal {same_mean}")
    if not (same_out and same_score and same_mean):
        fail("keras VGG16: the restored net or normalizer differs")
    os.remove(path)
    del back
    # the evaluations on the card's outputs against the CPU copies
    evals = {}
    for cls, kw in ((Evaluation, {}), (ROCMultiClass, {"device": DEV}),
                    (EvaluationCalibration, {"device": DEV})):
        a = cls(**kw)
        b = cls(**({"device": "cpu"} if kw else {}))
        a.eval(held_y, probs)
        b.eval(held_y.cpu(), probs.cpu())
        if cls is Evaluation:
            va, vb = a.accuracy(), b.accuracy()
            ok = (va == vb and np.array_equal(a.confusion.matrix,
                                              b.confusion.matrix))
        elif cls is ROCMultiClass:
            va, vb = a.average_auc(), b.average_auc()
            ok = va == vb
        else:
            va, vb = (a.expected_calibration_error(),
                      b.expected_calibration_error())
            ok = all(np.array_equal(u, v)
                     for c in range(a.num_classes)
                     for u, v in zip(a.reliability_info(c)[1:],
                                     b.reliability_info(c)[1:])) \
                and abs(va - vb) <= 1e-12 * max(abs(vb), 1e-300)
        evals[cls.__name__] = {"card": va, "cpu": vb, "equal": ok}
        if not ok:
            fail(f"keras VGG16: {cls.__name__} on the card {va!r} != on the "
                 f"CPU {vb!r}")
    out["evals"] = evals
    log("keras VGG16 held batch: " + ", ".join(
        f"{k} {v['card']:.6g} (card) == {v['cpu']:.6g} (CPU copies)"
        for k, v in evals.items()))
    del net
    torch.cuda.empty_cache()
    return out


def keras_resnet50(torch, np, pc, card, seed, tmp, zoo_ms, worst):
    """Keras ResNet50 (tf.keras.applications, weights=None: convolutions
    with bias, BN epsilon 1.001e-5, a ZeroPadding2D stem, the stage
    stride on the first 1x1 and the shortcut) imported with seeded
    weights, helpers="pallas", bf16: the forward against "fused" (bf16
    and f32), its kernel calls at batch BATCH and of a train step at
    KERAS_RESNET_BATCH counted by kernel and route against path_launches
    and each distinct one against its plain version (TOL), then
    KERAS_RESNET_STEPS steps through run_group(GROUP_K) beside the zoo
    flagship's phase 5b ms/step."""
    net, out = keras_import(torch, np, "resnet50", seed + 10, tmp)
    net.conf.helper_mode = "pallas"
    hw = HW
    randomize_batchnorm(torch, net, seed=seed + 11, hw=hw)
    out["logp_gap"] = zoo_forward_check(torch, np, net, hw, "keras ResNet50",
                                        "KerasResNet50")
    x32 = torch.from_numpy(serving_inputs(np, np.random.default_rng(15),
                                          BATCH, hw)).to(DEV)
    fcalls = record_kernel_calls(torch, pc, lambda: net.output(x32))
    check_launches("keras ResNet50 forward", calls_by_route(pc, fcalls),
                   path_launches(pc, net, BATCH, False))
    train, (x, y) = graph_train(torch, np, pc, net, KERAS_RESNET_BATCH,
                                KERAS_RESNET_STEPS, "keras ResNet50", hw=hw)
    out["train"] = train
    tcalls = record_kernel_calls(torch, pc,
                                 lambda: net.fit_batch(([x], [y])))
    check_launches("keras ResNet50 train step", calls_by_route(pc, tcalls),
                   path_launches(pc, net, KERAS_RESNET_BATCH, True))
    out["checked"] = zoo_kernel_checks(torch, pc, fcalls + backward_calls(
        tcalls), "keras ResNet50 kernels", worst)
    out["kernel_calls"] = {"forward": len(fcalls), "step": len(tcalls)}
    out["zoo_ms_per_step"] = zoo_ms
    out["over_zoo_ms"] = train["ms_per_step"] / zoo_ms
    log(f"keras ResNet50: {train['ms_per_step']:.2f} ms/step against the zoo "
        f"ResNet-50's {zoo_ms:.2f} (phase 5b, run_group({GROUP_K})): "
        f"{out['over_zoo_ms']:.3f}x [{card}]")
    del net
    torch.cuda.empty_cache()
    return out


def csv_data(torch, np, card, seed, tmp):
    """The native host library is available; a seeded numeric CSV of
    CSV_ROWS rows x CSV_COLS columns (the last a class label) parsed by
    CSVRecordReader.to_matrix (the C++ path) and by the NumPy fallback,
    equal bit for bit, rows/s of each; then RecordReaderDataSetIterator's
    batches of CSV_BATCH staged on the card."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    log(f"data: native host library available {ok} (build and load "
        f"{build_s:.2f} s)")
    if not ok:
        fail("data: the port's native host library did not build or load")
    rng = np.random.default_rng(seed + 20)
    feats = rng.normal(size=(CSV_ROWS, CSV_COLS - 1)) * 10.0
    labels = rng.integers(0, 10, CSV_ROWS)
    path = os.path.join(tmp, "data.csv")
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([feats, labels]), delimiter=",",
               fmt=["%.6g"] * (CSV_COLS - 1) + ["%d"])
    gen_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    reader = CSVRecordReader(path)
    t0 = time.perf_counter()
    m = reader.to_matrix()
    native_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        raw = f.read()
    t0 = time.perf_counter()
    ref = native.parse_csv_fallback(raw)
    numpy_s = time.perf_counter() - t0
    same = m is not None and bits_equal(torch, torch.from_numpy(m),
                                        torch.from_numpy(ref))
    it = RecordReaderDataSetIterator(reader, batch_size=CSV_BATCH,
                                     label_index=CSV_COLS - 1,
                                     num_classes=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = batches = 0
    for ds in it:
        xb = torch.from_numpy(ds.features).to(DEV, non_blocking=True)
        yb = torch.from_numpy(ds.labels).to(DEV, non_blocking=True)
        rows += xb.shape[0]
        batches += 1
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t0
    out = {"rows": CSV_ROWS, "cols": CSV_COLS, "bytes": size,
           "generate_s": gen_s, "native_s": native_s, "numpy_s": numpy_s,
           "native_rows_per_s": CSV_ROWS / native_s,
           "numpy_rows_per_s": CSV_ROWS / numpy_s, "bit_equal": same,
           "iterator_s": iter_s, "iterator_rows_per_s": rows / iter_s,
           "batches": batches, "last_batch": list(xb.shape) + list(yb.shape)}
    log(f"data: CSV {CSV_ROWS} x {CSV_COLS} ({size} bytes, written in "
        f"{gen_s:.2f} s): to_matrix (C++) {native_s:.3f} s = "
        f"{out['native_rows_per_s']:.0f} rows/s, NumPy fallback "
        f"{numpy_s:.3f} s = {out['numpy_rows_per_s']:.0f} rows/s, bit for "
        f"bit {same}; RecordReaderDataSetIterator: {batches} batches of "
        f"{CSV_BATCH} on the card in {iter_s:.3f} s "
        f"({out['iterator_rows_per_s']:.0f} rows/s) [{card}]")
    if not same or rows != CSV_ROWS:
        fail("data: the C++ CSV path departs from the NumPy fallback, or "
             "the iterator lost rows")
    os.remove(path)
    return out


def lenet_mnist(torch, np, card):
    """BASELINE config 1: LeNet on MnistDataSetIterator (no file on this
    machine: the seeded synthetic stand-in), LENET_STEPS steps at
    LENET_BATCH through run_group(GROUP_K), each group GROUP_K distinct
    batches; the mean loss of the last group under the first's."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.datasets import fetchers
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.zoo import LeNet

    found = os.path.exists(os.path.join(fetchers.data_dir(),
                                        "mnist_train_images.gz"))
    it = MnistDataSetIterator(LENET_BATCH, num_examples=LENET_BATCH
                              * LENET_STEPS)
    batches = list(it)
    xs = torch.from_numpy(np.stack([b.features for b in batches])).to(DEV)
    ys = torch.from_numpy(np.stack([b.labels for b in batches])).to(DEV)
    net = LeNet().init_model(device=DEV)
    prog = StepProgram(net)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(0, LENET_STEPS, GROUP_K):
        prog.run_group(xs[g:g + GROUP_K], ys[g:g + GROUP_K])
        losses.extend(float(v) for v in prog.last_step_losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first = float(np.mean(losses[:GROUP_K]))
    last = float(np.mean(losses[-GROUP_K:]))
    out = {"local_file": found, "steps": LENET_STEPS, "batch": LENET_BATCH,
           "seconds": wall, "loss_first_group": first,
           "loss_last_group": last, "losses": losses}
    log(f"data: LeNet on MnistDataSetIterator ({'local file' if found else 'synthetic stand-in'}), "
        f"{LENET_STEPS} steps at batch {LENET_BATCH} through "
        f"run_group({GROUP_K}) in {wall:.2f} s (host clock, captures "
        f"included); mean loss of the first group {first:.4f} -> of the last "
        f"{last:.4f} [{card}]")
    if not all(np.isfinite(losses)) or not last < first:
        fail(f"data: LeNet on MNIST: loss not finite and falling: {losses}")
    return out


def keras_phase(torch, np, pc, card, seed, engine):
    """Phase 5h: Keras import and data (lines start "keras " and "data:").
    Returns the readings, the launches of its path (the Keras ResNet50's
    timed steps) and the per-kernel worst errors of its kernel checks."""
    worst, out, secs = {}, {}, {}
    zoo_ms = engine["pallas"]["group"]["ms_per_step"]
    with tempfile.TemporaryDirectory() as tmp:
        parts = [
            ("fixtures", lambda: keras_fixtures(torch, np)),
            ("vgg16", lambda: keras_vgg16(torch, np, card, seed, tmp)),
            ("resnet50", lambda: keras_resnet50(torch, np, pc, card, seed,
                                                tmp, zoo_ms, worst)),
            ("csv", lambda: csv_data(torch, np, card, seed, tmp)),
            ("lenet_mnist", lambda: lenet_mnist(torch, np, card)),
        ]
        for name, run in parts:
            t0 = time.perf_counter()
            out[name] = run()
            secs[name] = time.perf_counter() - t0
    launches = out["resnet50"]["train"]["launches"]
    out.update(seconds=secs, launches=launches, worst=worst)
    log(f"keras phase: launches on the Keras path {launches}; seconds per "
        "part " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out


# ------------------------------------------------------------ phase 5i


def decode_requests(rng, n, prompt, new, vocab):
    """`n` requests from `rng`: prompts of prompt[0]..prompt[1] tokens
    and new[0]..new[1] new tokens (bench_serving.py:1183's draw)."""
    return [([rng.randrange(vocab)
              for _ in range(rng.randrange(prompt[0], prompt[1] + 1))],
             rng.randrange(new[0], new[1] + 1)) for _ in range(n)]


def decode_engine_run(torch, prog, reqs, prefills, journal=None):
    """Every request submitted at once to a fresh DecodeEngine, driven
    by step_once until all finish (host clock; the last step read its
    tokens, so the card is idle at the end). Returns the tokens, the
    seconds, the engine and this run's program dispatches (the
    program's tally counts every caller)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(program=prog, queue_limit=len(reqs),
                       max_prefills_per_step=prefills, journal=journal)
    before = prog.trace_stats()["dispatches"]
    t0 = time.perf_counter()
    handles = [eng.submit(p, mx) for p, mx in reqs]
    while any(not h.done for h in handles):
        eng.step_once()
    dt = time.perf_counter() - t0
    disp = {k: v - before[k]
            for k, v in prog.trace_stats()["dispatches"].items()}
    return [h.result(timeout_s=0) for h in handles], dt, eng, disp


def decode_naive_run(prog, reqs):
    """The naive arm: sequential_decode per request on one pool."""
    from deeplearning4j_tpu_torch.serving import sequential_decode

    kv = prog.init_kv()
    outs = []
    t0 = time.perf_counter()
    for p, mx in reqs:
        kv, toks = sequential_decode(prog, p, mx, kv=kv)
        outs.append(toks)
    return outs, time.perf_counter() - t0


def decode_loop_run(prog, reqs):
    """The engine as a server runs it: its own loop thread (`start()`),
    every request submitted at once, each result awaited, `stop()`."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(program=prog, queue_limit=len(reqs),
                       max_prefills_per_step=DECODE_PREFILLS)
    t0 = time.perf_counter()
    eng.start()
    try:
        handles = [eng.submit(p, mx) for p, mx in reqs]
        outs = [h.result(timeout_s=120.0) for h in handles]
    finally:
        eng.stop()
    return outs, time.perf_counter() - t0, eng.stats()["steps"]


def decode_profile(torch, fn):
    """torch.profiler over `fn()`: the device's busy ms (the sum of the
    kernels' device times; one stream) and the number of kernels run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev(e) > 0]
    busy = sum(dev(e) for e in kernels) / 1e3
    return {"busy_ms": busy if busy > 0 else None,
            "kernels": sum(e.count for e in kernels)}


def decode_idle_window(torch, prog, reqs, skip, n):
    """The idle share of a window of engine steps: the same engine run
    twice (its schedule is host data, so steps skip..skip+n are the same
    steps), once timing the window on the host clock, once under the
    profiler. Each step ends with its one read, so the card is idle at
    the window's ends."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    out = {}
    for profiled in (False, True):
        eng = DecodeEngine(program=prog, queue_limit=len(reqs),
                           max_prefills_per_step=DECODE_PREFILLS)
        for p, mx in reqs:
            eng.submit(p, mx)
        for _ in range(skip):
            eng.step_once()
        torch.cuda.synchronize()
        steps0 = eng.stats()["steps"]
        window = lambda: [eng.step_once() for _ in range(n)]
        if profiled:
            out.update(decode_profile(torch, window))
        else:
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3
            out["decode_steps"] = eng.stats()["steps"] - steps0
        eng.stop()
    out["idle_share"] = (None if out["busy_ms"] is None
                         else 1.0 - out["busy_ms"] / out["wall_ms"])
    return out


def decode_full_tables(np, prog, pos):
    """Every slot decoding at logical position `pos` over its own pages:
    the inputs of one full decode step and of one chunk at `pos`."""
    from deeplearning4j_tpu_torch.engine.decode_program import SCRATCH_PAGE

    s, c, ps = prog.max_slots, prog.window, prog.page_size
    pps = prog.pages_per_slot
    cp = np.full((s, c), SCRATCH_PAGE, np.int32)
    co = np.zeros((s, c), np.int32)
    wp = np.zeros(s, np.int32)
    wo = np.zeros(s, np.int32)
    for slot in range(s):
        table = [1 + slot * pps + r for r in range(pps)]
        cp[slot], co[slot] = prog.window_cells(table, pos)
        wp[slot] = table[(pos // ps) % pps]
        wo[slot] = pos % ps
    tok = np.arange(s, dtype=np.int32) % prog.model.vocab_size
    posv = np.full(s, pos, np.int32)
    step = (tok, posv, cp, co, wp, wo)
    start = (pos // ps) * ps
    ccp, cco = prog.window_cells(list(range(1, pps + 1)), start - 1)
    chunk = ([int(t) for t in tok] * ps)[:ps], start, ccp, cco, 1
    return step, chunk


def decode_dispatch_ms(torch, np, prog, pos, n):
    """ms per decode dispatch and per chunk dispatch at `pos` (CUDA
    events around n back-to-back calls, after one; the host builds the
    next call while the card runs, as in the engine) and the host wall
    ms of a decode dispatch with its one read of the tokens."""
    from deeplearning4j_tpu_torch.engine.decode_program import host_outputs

    kv = prog.init_kv()
    step, chunk = decode_full_tables(np, prog, pos)
    r = {"pos": pos,
         "step_ms": events_ms(torch, lambda: prog.step(kv, *step), n),
         "chunk_ms": events_ms(
             torch, lambda: prog.prefill_chunk(kv, *chunk), n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        host_outputs(*prog.step(kv, *step)[1:])
    r["step_host_ms"] = (time.perf_counter() - t0) * 1e3 / n
    p = decode_profile(torch, lambda: [prog.step(kv, *step)
                                       for _ in range(n)])
    r["launches_per_step"] = p["kernels"] / n
    r["step_busy_ms"] = None if p["busy_ms"] is None else p["busy_ms"] / n
    p = decode_profile(torch, lambda: [prog.prefill_chunk(kv, *chunk)
                                       for _ in range(n)])
    r["launches_per_chunk"] = p["kernels"] / n
    del kv
    return r


def decode_bench(torch, np, prog, reqs, card, tmp):
    """bench_serving.py:1183 bench_decode on the card: the naive and the
    engine arm, two interleaved reps each, then the journal arm against
    none, two interleaved reps each; every arm's tokens identical."""
    from deeplearning4j_tpu_torch.serving import GenerationJournal

    n1, dn1 = decode_naive_run(prog, reqs)
    e1, de1, eng, disp = decode_engine_run(torch, prog, reqs,
                                           DECODE_PREFILLS)
    n2, dn2 = decode_naive_run(prog, reqs)
    e2, de2, _, _ = decode_engine_run(torch, prog, reqs, DECODE_PREFILLS)
    if not (n1 == e1 == n2 == e2):
        fail("decode bench: the engine's tokens differ from the naive "
             "per-request arm's")
    lo, dlo, lsteps = decode_loop_run(prog, reqs)
    if lo != n1:
        fail("decode bench: the engine's loop thread served other tokens "
             "than the naive arm's")
    tokens = sum(len(t) for t in n1)
    st = eng.stats()
    r = {"tokens": tokens, "naive_s": [dn1, dn2], "engine_s": [de1, de2],
         "naive_tok_s": tokens / min(dn1, dn2),
         "engine_tok_s": tokens / min(de1, de2),
         "decode_steps": st["steps"], "dispatches": disp,
         "mean_slot_occupancy": tokens / max(st["steps"], 1)}
    r["ratio"] = r["engine_tok_s"] / r["naive_tok_s"]
    r["loop_thread"] = {"s": dlo, "tok_s": tokens / dlo,
                        "decode_steps": lsteps}
    r["idle"] = decode_idle_window(torch, prog, reqs, DECODE_IDLE_SKIP,
                                   DECODE_IDLE_STEPS)
    r["dispatch"] = decode_dispatch_ms(torch, np, prog, 100, DECODE_TIMED)
    d = r["dispatch"]
    log(f"decode bench: {len(reqs)} requests, {tokens} tokens; naive "
        f"{r['naive_tok_s']:.1f} tok/s, engine {r['engine_tok_s']:.1f} "
        f"tok/s: {r['ratio']:.3f}x; {r['decode_steps']} decode steps, mean "
        f"slot occupancy {r['mean_slot_occupancy']:.2f} of "
        f"{prog.max_slots}; dispatches {r['dispatches']}; all four arm-reps "
        f"token-identical; served by the engine's loop thread (start, "
        f"submit, result, stop) {r['loop_thread']['tok_s']:.1f} tok/s in "
        f"{dlo:.3f} s, {lsteps} decode steps, tokens identical [{card}]")
    log(f"decode dispatch at position {d['pos']} (all {prog.max_slots} "
        f"slots): {d['step_ms']:.3f} ms per decode dispatch (host wall "
        f"with its one read {d['step_host_ms']:.3f}, device busy "
        f"{d['step_busy_ms']}), {d['chunk_ms']:.3f} ms per chunk "
        f"dispatch; PyTorch kernel launches {d['launches_per_step']:.1f} "
        f"per decode step, {d['launches_per_chunk']:.1f} per chunk; engine "
        f"idle share {r['idle']['idle_share']} over engine steps "
        f"{DECODE_IDLE_SKIP}-{DECODE_IDLE_SKIP + DECODE_IDLE_STEPS} "
        f"({r['idle']['decode_steps']} decode dispatches; busy "
        f"{r['idle']['busy_ms']} ms of {r['idle']['wall_ms']:.1f}, "
        f"{r['idle']['kernels']} kernels) [{card}]")
    outs, secs, jstats = {"off": [], "on": []}, {"off": [], "on": []}, None
    for arm in ("on", "off", "on", "off"):
        d = os.path.join(tmp, f"journal-{len(secs['on'])}") \
            if arm == "on" else None
        j = GenerationJournal(d, fsync_interval_s=0.05) if d else None
        try:
            o, dt, _, _ = decode_engine_run(torch, prog, reqs,
                                            DECODE_PREFILLS, journal=j)
        finally:
            if j is not None:
                jstats = j.stats()
                j.close()
        outs[arm].append(o)
        secs[arm].append(dt)
    if not all(o == n1 for arm in outs.values() for o in arm):
        fail("decode journal: the journaled tokens differ from the "
             "journal-free arm's")
    r["journal"] = {"off_tok_s": tokens / min(secs["off"]),
                    "on_tok_s": tokens / min(secs["on"]),
                    "off_s": secs["off"], "on_s": secs["on"],
                    "records": jstats["records"],
                    "fsyncs": jstats["fsyncs"]}
    jr = r["journal"]
    log(f"decode journal: GenerationJournal(fsync_interval_s=0.05) "
        f"{jr['on_tok_s']:.1f} tok/s against none {jr['off_tok_s']:.1f}: "
        f"{jr['on_tok_s'] / jr['off_tok_s']:.3f}x; {jr['records']} records, "
        f"{jr['fsyncs']} fsyncs per run; tokens identical [{card}]")
    return r, n1


def decode_drain(eng, handles, limit=20000):
    steps = 0
    while any(not h.done for h in handles):
        eng.step_once()
        steps += 1
        if steps > limit:
            fail("decode drill: the engine made no progress")
    return [h.result(timeout_s=0) for h in handles]


def decode_drills(torch, np, prog, seed, tmp):
    """The paged drills at bench width, each against sequential_decode on
    the same program, bit for bit."""
    from deeplearning4j_tpu_torch.resilience.faults import injector
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        GenerationJournal,
        sequential_decode,
    )

    rng = random.Random(seed + 1)
    vocab, ps = prog.model.vocab_size, prog.page_size
    oracle = lambda p, mx: sequential_decode(prog, p, mx)[1]
    res, bad = {}, []

    def check(name, got, want, **facts):
        res[name] = dict(facts, requests=len(want),
                         bitwise=got == want)
        if got != want:
            bad.append(name)

    # shared prefix: a two-page system prompt + unique tails
    system = [rng.randrange(vocab) for _ in range(2 * ps)]
    reqs = [(system + [rng.randrange(vocab)
                       for _ in range(rng.randrange(3, 13))], 12)
            for _ in range(8)]
    eng = DecodeEngine(program=prog, queue_limit=64,
                       max_prefills_per_step=DECODE_PREFILLS)
    got = decode_drain(eng, [eng.submit(p, mx) for p, mx in reqs])
    st = eng.stats()
    unshared = sum(len(prog.chunk_starts(len(p))) for p, _ in reqs)
    check("prefix", got, [oracle(p, mx) for p, mx in reqs],
          prefix_requests_hit=st["prefix_requests_hit"],
          prefix_page_hits=st["prefix_hits"],
          chunks=st["prefill_chunks"],
          skipped_chunks=unshared - st["prefill_chunks"])
    if not (st["prefix_requests_hit"] > 0
            and unshared - st["prefill_chunks"] > 0):
        bad.append("prefix (no hit or no skipped chunk)")
    # copy-on-write: a prompt with a partial last page, twice
    prompt = [rng.randrange(vocab) for _ in range(ps + 11)]
    eng = DecodeEngine(program=prog)
    a = decode_drain(eng, [eng.submit(prompt, 16)])
    cow_a = eng.stats()["cow_copies"]
    b = decode_drain(eng, [eng.submit(prompt, 16)])
    want = oracle(prompt, 16)
    check("cow", a + b, [want, want], cow_copies=eng.stats()["cow_copies"],
          cow_after_first=cow_a)
    if not eng.stats()["cow_copies"] > cow_a >= 1:
        bad.append("cow (no copy)")
    # ring wrap: generation past max_ctx
    prompt = [rng.randrange(vocab) for _ in range(20)]
    n_new = prog.window + 30
    eng = DecodeEngine(program=prog)
    got = decode_drain(eng, [eng.submit(prompt, n_new)])
    check("ring_wrap", got, [oracle(prompt, n_new)],
          ctx_wraps=eng.stats()["ctx_wraps"])
    if eng.stats()["ctx_wraps"] < 1:
        bad.append("ring_wrap (no wrap)")
    # an eviction storm through the serving.slot_evict fault point
    reqs = decode_requests(rng, 12, (4, 40), (8, 30), vocab)
    inj = injector()
    for at in (3, 6, 9, 12, 15):
        inj.inject("serving.slot_evict", mode="raise", at_hit=at, times=1)
    try:
        eng = DecodeEngine(program=prog, queue_limit=64,
                           max_prefills_per_step=DECODE_PREFILLS)
        got = decode_drain(eng, [eng.submit(p, mx) for p, mx in reqs])
    finally:
        inj.clear()
    check("eviction_storm", got, [oracle(p, mx) for p, mx in reqs],
          evictions=eng.stats()["evictions"])
    if eng.stats()["evictions"] != 5:
        bad.append("eviction_storm (evictions)")
    # a decode.nonfinite quarantine and replay
    reqs = decode_requests(rng, 8, (4, 40), (8, 30), vocab)
    inj.inject("decode.nonfinite", mode="raise", at_hit=4, times=1)
    inj.inject("decode.nonfinite", mode="raise", at_hit=9, times=1)
    try:
        eng = DecodeEngine(program=prog, queue_limit=64,
                           max_prefills_per_step=DECODE_PREFILLS)
        got = decode_drain(eng, [eng.submit(p, mx) for p, mx in reqs])
    finally:
        inj.clear()
    st = eng.stats()
    check("quarantine", got, [oracle(p, mx) for p, mx in reqs],
          quarantines=st["quarantines"], replays=st["replays"])
    if st["quarantines"] != 2 or st["replays"] < 2:
        bad.append("quarantine (counts)")
    # the loop thread wedged by decode.hang: the StepWatchdog tears the
    # engine down and restarts it, every live request replayed
    reqs = decode_requests(rng, 6, (4, 40), (8, 30), vocab)
    inj.inject("decode.hang", mode="delay", delay_s=1.5, at_hit=5, times=1)
    eng = DecodeEngine(program=prog, queue_limit=64,
                       max_prefills_per_step=DECODE_PREFILLS,
                       watchdog_timeout_s=0.25, max_engine_restarts=3)
    eng.start()
    try:
        got = [h.result(timeout_s=60.0)
               for h in [eng.submit(p, mx) for p, mx in reqs]]
    finally:
        eng.stop()
        inj.clear()
    st = eng.stats()
    check("watchdog_restart", got, [oracle(p, mx) for p, mx in reqs],
          engine_restarts=st["engine_restarts"], replays=st["replays"])
    if st["engine_restarts"] != 1:
        bad.append("watchdog_restart (restarts)")
    # a resume_tokens continuation
    prompt = [rng.randrange(vocab) for _ in range(30)]
    full = oracle(prompt, 24)
    eng = DecodeEngine(program=prog)
    got = decode_drain(eng, [eng.submit(prompt, 24,
                                        resume_tokens=full[:9])])
    check("resume", got, [full])
    # cold recovery from the journal of an engine stopped mid-generation
    reqs = [(p, 20) for p, _ in decode_requests(rng, 5, (4, 40), (8, 8),
                                                vocab)]
    d = os.path.join(tmp, "drill-journal")
    j1 = GenerationJournal(d, fsync_interval_s=0)
    eng1 = DecodeEngine(program=prog, journal=j1)
    for i, (p, mx) in enumerate(reqs):
        eng1.submit(p, mx, request_id=f"drill-{i}")
    for _ in range(6):
        eng1.step_once()
    eng1.stop()                       # the journal stays open: a kill
    j2 = GenerationJournal(d, fsync_interval_s=0)
    airborne = sum(1 for v in j2.live().values() if v["tokens"])
    eng2 = DecodeEngine(program=prog, journal=j2)
    recovered = eng2.stats()["journal"]["recovered"]
    got = decode_drain(eng2, [eng2.submit(p, mx, request_id=f"drill-{i}")
                              for i, (p, mx) in enumerate(reqs)])
    check("cold_recovery", got, [oracle(p, mx) for p, mx in reqs],
          recovered=recovered, airborne=airborne,
          live_after=len(j2.live()))
    j2.close()
    j1.close()
    if recovered != len(reqs) or not airborne or res["cold_recovery"][
            "live_after"]:
        bad.append("cold_recovery (counts)")
    return res, bad


def decode_capturing_pair(torch, cfg, seed, slots, page):
    """The same seeded CausalTransformer on the card and on the CPU, each
    with a DecodeProgram of its own, built at its first call while
    `nn.attention.lm_logits` records their logits (`caps["card"]`,
    `caps["cpu"]`; these two programs only, so no other run reads its
    logits back); `restore()` puts the module's function back."""
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.nn import attention
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    caps, orig, owner = {"card": [], "cpu": []}, attention.lm_logits, {}

    def lm_rec(x, e):
        out = orig(x, e)
        caps[owner[e.data_ptr()]].append(out.cpu().numpy().copy())
        return out

    progs = {}
    for name, where in (("card", DEV), ("cpu", "cpu")):
        m = CausalTransformer(**cfg, seed=seed, device=where).init()
        owner[m.params["tok_emb"].data_ptr()] = name
        progs[name] = DecodeProgram(m, max_slots=slots, page_size=page)
    attention.lm_logits = lm_rec

    def restore():
        attention.lm_logits = orig

    return progs["card"], progs["cpu"], caps, restore


def decode_versus_cpu(torch, np, card_prog, cpu_prog, caps, seed, pos):
    """One chunk and one decode step on the card against the same calls
    of the port on the CPU, same weights and inputs: a pool of seeded
    cells, a chunk into slot 0's page at the page start below `pos`,
    then every slot decoding at `pos` over its own pages. The largest
    |card - CPU| of the pool after each and of the step's logits, and
    the tokens compared where the CPU's top-1 margin is wide."""
    from deeplearning4j_tpu_torch.engine.decode_program import host_outputs

    gen = torch.Generator(device=DEV).manual_seed(seed)
    kv = torch.randn(card_prog.kv_shape, generator=gen, device=DEV)
    kv.mul_(DECODE_POOL_STD)
    kc = kv.cpu()
    step, chunk = decode_full_tables(np, card_prog, pos)
    toks, start, ccp, cco, _ = chunk
    chunk = (toks, start, ccp, cco,
             1 + (start // card_prog.page_size) % card_prog.pages_per_slot)

    def pool_err():
        # scratch (page 0) excepted: its bytes are racy by design
        return float((kv[:, :, 1:] - kc[:, :, 1:].to(DEV)).abs().max())

    card_prog.prefill_chunk(kv, *chunk)
    cpu_prog.prefill_chunk(kc, *chunk)
    r = {"pos": pos, "chunk_pool_err": pool_err()}
    for v in caps.values():
        v.clear()
    _, nxt, ok = card_prog.step(kv, *step)
    nxt, ok = host_outputs(nxt, ok)
    _, nc, okc = cpu_prog.step(kc, *step)
    nc, okc = host_outputs(nc, okc)
    r["step_pool_err"] = pool_err()
    (lg,), (lc,) = caps["card"], caps["cpu"]
    r["logits_err"] = float(np.max(np.abs(lg.astype(np.float64) - lc)))
    top = np.sort(lc, axis=1)
    wide = (top[:, -1] - top[:, -2]) > DECODE_CPU_MARGIN
    r["wide_slots"] = int(wide.sum())
    r["tokens_equal_wide"] = bool((nxt[wide] == nc[wide]).all())
    r["finite"] = bool(ok.all() and okc.all())
    del kv, kc
    return r


def decode_tokens_versus_cpu(np, cpu_prog, caps, reqs, want):
    """The card's greedy tokens for `reqs` (`want`: its sequential_decode
    run in the bench) against the CPU's sequential_decode, on the
    requests whose CPU top-1 margin exceeds DECODE_CPU_MARGIN at every
    step (the oracle decodes in slot 0)."""
    from deeplearning4j_tpu_torch.serving import sequential_decode

    wide = equal = 0
    for (p, mx), w in zip(reqs, want):
        caps["cpu"].clear()
        toks = sequential_decode(cpu_prog, p, mx)[1]
        margins = [float(np.diff(np.sort(lg[0])[-2:])[0])
                   for lg in caps["cpu"]]
        if min(margins) > DECODE_CPU_MARGIN:
            wide += 1
            equal += toks == w
    for v in caps.values():
        v.clear()
    return {"requests": len(reqs), "wide": wide, "equal": equal}


def decode_cpu_check(torch, np, cfg, seed, slots, page, pos, card,
                     what, reqs=(), want=()):
    """decode_versus_cpu (and, given requests and the card's tokens for
    them, decode_tokens_versus_cpu) on a fresh card/CPU pair; logs a
    line and fails on a disagreement."""
    t0 = time.perf_counter()
    card_prog, cpu_prog, caps, restore = decode_capturing_pair(
        torch, cfg, seed, slots, page)
    try:
        r = decode_versus_cpu(torch, np, card_prog, cpu_prog, caps, seed,
                              pos)
        if reqs:
            r["tokens"] = decode_tokens_versus_cpu(np, cpu_prog, caps,
                                                   reqs, want)
    finally:
        restore()
    r["seconds"] = time.perf_counter() - t0
    log(f"decode {what} card vs CPU (the port on the CPU, held to JAX by "
        f"tests/test_torch_decode_parity.py; same seeded weights and "
        f"pool): {r}; tolerance {DECODE_CPU_TOL} [{card}]")
    errs = [r["chunk_pool_err"], r["step_pool_err"], r["logits_err"]]
    if not max(errs) <= DECODE_CPU_TOL:
        fail(f"decode {what}: the card differs from the CPU by "
             f"{max(errs)} > {DECODE_CPU_TOL}")
    if not (r["finite"] and r["tokens_equal_wide"] and r["wide_slots"]):
        fail(f"decode {what}: the card's step tokens differ from the "
             f"CPU's: {r}")
    t = r.get("tokens")
    if t and (t["wide"] < DECODE_CPU_WIDE_MIN or t["equal"] != t["wide"]):
        fail(f"decode {what}: greedy tokens against the CPU: {t}")
    del card_prog, cpu_prog
    torch.cuda.empty_cache()
    return r


def decode_gpt2(torch, np, seed, card):
    """GPT-2-small width (openai-community/gpt2's config, seeded weights):
    GPT2_REQUESTS requests through the engine, the oracle on
    GPT2_ORACLE of them, dispatch times beside the per-step bound."""
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.serving import sequential_decode
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # what earlier phases still hold
    model = CausalTransformer(**GPT2, seed=seed, device=DEV).init()
    prog = DecodeProgram(model, max_slots=GPT2_SLOTS, page_size=GPT2_PAGE)
    prog.warmup(prog.init_kv())
    r = {"params": model.num_params(), "pool_bytes": prog.kv_bytes,
         "build_s": time.perf_counter() - t0}
    builds = model._jit_cache.trace_counts()
    reqs = decode_requests(random.Random(seed), GPT2_REQUESTS, GPT2_PROMPT,
                           GPT2_NEW, model.vocab_size)
    outs, dt, eng, disp = decode_engine_run(torch, prog, reqs,
                                            GPT2_PREFILLS)
    st = eng.stats()
    del eng
    tokens = sum(len(t) for t in outs)
    r.update(tokens=tokens, engine_s=dt, tok_s=tokens / dt,
             decode_steps=st["steps"], dispatches=disp,
             prompt_tokens=sum(len(p) for p, _ in reqs),
             mean_slot_occupancy=tokens / max(st["steps"], 1))
    if len(outs) != GPT2_REQUESTS or any(
            len(o) != mx for o, (_, mx) in zip(outs, reqs)):
        fail("decode gpt2: a request did not finish with its tokens")
    kv = prog.init_kv()
    want = []
    for p, mx in reqs[:GPT2_ORACLE]:
        kv, toks = sequential_decode(prog, p, mx, kv=kv)
        want.append(toks)
    del kv
    r["oracle_bitwise"] = outs[:GPT2_ORACLE] == want
    pos = GPT2_BOUND_LIVE - 1
    r["dispatch"] = decode_dispatch_ms(torch, np, prog, pos, GPT2_TIMED)
    weights = prog.step_bytes() - (prog.max_slots * prog.window
                                   * model.n_layers * 2 * model.d_model * 4)
    live_bytes = (prog.max_slots * GPT2_BOUND_LIVE * model.n_layers * 2
                  * model.d_model * 4)
    r["weights_bytes"] = weights
    r["live_kv_bytes"] = live_bytes
    r["step_bound_ms"] = (weights + live_bytes) / HBM_BYTES_PER_S * 1e3
    r["peak_allocated"] = torch.cuda.max_memory_allocated() - base
    r["allocated_before"] = base
    r["builds_unchanged"] = model._jit_cache.trace_counts() == builds
    r["seconds"] = time.perf_counter() - t0
    d = r["dispatch"]
    log(f"decode gpt2: CausalTransformer({GPT2}), {r['params']} params, f32, "
        f"DecodeProgram(max_slots={GPT2_SLOTS}, page_size={GPT2_PAGE}), pool "
        f"{r['pool_bytes'] / 1e9:.3f} GB; {GPT2_REQUESTS} requests "
        f"({r['prompt_tokens']} prompt tokens, {tokens} new): "
        f"{r['tok_s']:.1f} tok/s in {dt:.2f} s, {r['decode_steps']} decode "
        f"steps (occupancy {r['mean_slot_occupancy']:.2f}), dispatches "
        f"{r['dispatches']}; peak memory {r['peak_allocated'] / 1e9:.3f} GB "
        f"above the {base / 1e9:.3f} GB held before this part; "
        f"engine = oracle on {GPT2_ORACLE}: {r['oracle_bitwise']} [{card}]")
    log(f"decode gpt2 dispatch, all {GPT2_SLOTS} slots at {GPT2_BOUND_LIVE} "
        f"live cells: {d['step_ms']:.3f} ms per decode step (host wall "
        f"{d['step_host_ms']:.3f}, device busy {d['step_busy_ms']}) against "
        f"a bound of {r['step_bound_ms']:.3f} ms (weights "
        f"{weights / 1e9:.3f} GB + live K/V {live_bytes / 1e9:.3f} GB at "
        f"3.35 TB/s; {d['step_ms'] / r['step_bound_ms']:.1f}x); "
        f"{d['chunk_ms']:.3f} ms per chunk; launches "
        f"{d['launches_per_step']:.1f} per step, "
        f"{d['launches_per_chunk']:.1f} per chunk; phase part "
        f"{r['seconds']:.1f} s [{card}]")
    if not r["oracle_bitwise"]:
        fail("decode gpt2: the engine's tokens differ from the oracle's")
    if not r["builds_unchanged"]:
        fail("decode gpt2: a program was rebuilt after warm-up")
    del prog, model
    torch.cuda.empty_cache()
    return r


def decode_phase(torch, np, pc, card, seed):
    """Phase 5i: the decode-serving path (lines start "decode "). The
    kernel launch counters are set to 0 before it and read after it: no
    kernel of csrc/ is on the decode path."""
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    pc.reset_launch_counts()
    res, secs = {"card": card}, {}
    t0 = time.perf_counter()
    model = CausalTransformer(**DECODE_BENCH, device=DEV).init()
    prog = DecodeProgram(model, max_slots=DECODE_SLOTS,
                         page_size=DECODE_PAGE)
    prog.warmup(prog.init_kv())
    builds = model._jit_cache.trace_counts()
    reqs = decode_requests(random.Random(seed), DECODE_REQUESTS,
                           DECODE_PROMPT, DECODE_NEW, model.vocab_size)
    log(f"decode model: CausalTransformer(vocab 512, d 128, 8 heads, 4 "
        f"layers, ctx 128, seed 7), {model.num_params()} params, f32, "
        f"DecodeProgram(max_slots={DECODE_SLOTS}, page_size={DECODE_PAGE}): "
        f"pool {prog.kv_bytes / 1e6:.2f} MB; builds after warm-up {builds}")
    with tempfile.TemporaryDirectory() as tmp:
        res["bench"], card_tokens = decode_bench(torch, np, prog, reqs,
                                                 card, tmp)
        res["bench_tokens"] = card_tokens
        secs["bench"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["drills"], bad = decode_drills(torch, np, prog, seed, tmp)
        secs["drills"] = time.perf_counter() - t0
    after = model._jit_cache.trace_counts()
    log(f"decode drills: {res['drills']}; build counts after warm-up "
        f"{builds}, after the bench and drills {after} (a call off a "
        f"key's shapes would add one) [{card}]")
    if bad:
        fail(f"decode drills: {bad}")
    if after != builds:
        fail(f"decode: a program was rebuilt after warm-up: {after}")
    del prog, model
    t0 = time.perf_counter()
    cfg = {k: v for k, v in DECODE_BENCH.items() if k != "seed"}
    res["cpu"] = decode_cpu_check(
        torch, np, cfg, DECODE_BENCH["seed"], DECODE_SLOTS, DECODE_PAGE, 100,
        card, "bench", reqs=reqs[:DECODE_CPU_REQUESTS],
        want=card_tokens[:DECODE_CPU_REQUESTS])
    secs["cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["gpt2"] = decode_gpt2(torch, np, seed, card)
    secs["gpt2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["gpt2_cpu"] = decode_cpu_check(torch, np, GPT2, seed, GPT2_SLOTS,
                                       GPT2_PAGE, GPT2_BOUND_LIVE - 1, card,
                                       "gpt2")
    secs["gpt2_cpu"] = time.perf_counter() - t0
    counts = pc.launch_counts()
    res["launches"] = {k: counts[k] for k in pc.LAUNCHES}
    res["seconds"] = secs
    log(f"decode phase: kernel launches on the decode path "
        f"{res['launches']}; seconds per part "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    if any(res["launches"].values()):
        fail(f"decode: a csrc/ kernel launched on the decode path: "
             f"{res['launches']}")
    return res


# ------------------------------------------------------------ phase 5j


def control_load_worker(cmd_q, out_q, stop, running):
    """The load generator's process (phase 5j): CPU only, importing the
    port's client and numpy, so client-side encoding never holds the
    serving process's GIL. Runs each command `cmd_q` brings (a dict,
    `control_load_run`) and puts its result on `out_q`; None ends it."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import numpy as np

    from deeplearning4j_tpu_torch.parallel import serving as wire

    out_q.put("ready")
    while True:
        cmd = cmd_q.get()
        if cmd is None:
            return
        try:
            out_q.put(control_load_run(np, wire, cmd, stop, running))
        except BaseException as e:   # noqa: BLE001 - reported by the parent
            out_q.put({"error": repr(e)})


def control_load_run(np, wire, cmd, stop, running):
    """Closed-loop clients on one wire: `cmd` has url, wire ("npz" or
    "json"), threads, sizes (request rows drawn from the pool), seconds
    (None: until `stop`), hw, and refs {version: [log p of each pool
    entry]} — each response is held against its claimed version's
    reference (gap, at most LOGP_TOL["served"]) and every other
    version's (far: more than that)."""
    pool = serving_pool(np, cmd["hw"])
    idx = [i for i, x in enumerate(pool) if x.shape[0] in cmd["sizes"]]
    refs = cmd["refs"]
    tol = LOGP_TOL["served"]
    req_bytes, resp_bytes = {}, {}
    for i in idx:
        if cmd["wire"] == "npz":
            req_bytes[i] = len(wire.encode_npz_request(pool[i], {}))
            resp_bytes[i] = len(wire.encode_npz_response(
                np.zeros((pool[i].shape[0], refs["v1"][i].shape[1]),
                         np.float32), {"model": cmd["model"],
                                       "version": "v1"}))
        else:
            req_bytes[i] = len(json.dumps({"inputs": pool[i].tolist()}))
            resp_bytes[i] = len(json.dumps({
                "outputs": np.exp(refs["v1"][i]).astype(np.float32)
                .tolist(), "model": cmd["model"], "version": "v1"}))
    records, errors, mixed = [], [], []
    gaps = {"own": 0.0, "other": float("inf")}
    lock = threading.Lock()
    t_start = time.perf_counter()
    deadline = (None if cmd["seconds"] is None
                else t_start + cmd["seconds"])

    def client(t):
        c = wire.ModelClient(cmd["url"], timeout=120.0, wire=cmd["wire"])
        order = np.random.default_rng(1000 + t)
        while not stop.is_set() and (deadline is None
                                     or time.perf_counter() < deadline):
            i = idx[int(order.integers(len(idx)))]
            t0 = time.perf_counter()
            try:
                r = c.predict(pool[i], model=cmd["model"])
            except Exception as e:   # noqa: BLE001 - counted, must be 0
                with lock:
                    errors.append(repr(e))
                continue
            t1 = time.perf_counter()
            got = np.asarray(r["outputs"], np.float32)
            v = r["version"]
            lp = np.log(np.maximum(got.astype(np.float64), 1e-30))
            own = float(np.abs(lp - refs[v][i]).max()) \
                if v in refs and got.shape == refs[v][i].shape \
                else float("inf")
            other = min([float(np.abs(lp - ref[i]).max())
                         for u, ref in refs.items() if u != v]
                        or [float("inf")])
            with lock:
                records.append((i, t0, t1, v))
                gaps["own"] = max(gaps["own"], own)
                gaps["other"] = min(gaps["other"], other)
                if own > tol or other <= tol:
                    mixed.append((v, own, other))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(cmd["threads"])]
    for th in threads:
        th.start()
    running.set()
    for th in threads:
        th.join()
    running.clear()
    wall = max([r[2] for r in records] or [t_start]) - t_start
    lat = sorted((r[2] - r[1]) * 1e3 for r in records)
    images = sum(pool[r[0]].shape[0] for r in records)
    versions = {}
    for r in records:
        versions[r[3]] = versions.get(r[3], 0) + 1
    n = max(len(records), 1)
    return {"wire": cmd["wire"], "threads": cmd["threads"],
            "requests": len(records), "images": images, "wall_s": wall,
            "req_per_s": len(records) / max(wall, 1e-9),
            "img_per_s": images / max(wall, 1e-9),
            "latency_ms_p50": float(np.percentile(lat, 50)) if lat else None,
            "latency_ms_p99": float(np.percentile(lat, 99)) if lat else None,
            "request_bytes": sum(req_bytes[r[0]] for r in records) / n,
            "response_bytes": sum(resp_bytes[r[0]] for r in records) / n,
            "errors": len(errors), "first_errors": errors[:3],
            "mixed": len(mixed), "first_mixed": mixed[:3],
            "worst_own_gap": gaps["own"], "least_other_gap": gaps["other"],
            "versions": versions}


class ControlLoad:
    """The parent's handle on the load generator process (spawned, so
    the child starts a fresh interpreter and never touches the card)."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.cmd_q, self.out_q = ctx.Queue(), ctx.Queue()
        self.stop, self.running = ctx.Event(), ctx.Event()
        self.proc = ctx.Process(target=control_load_worker, daemon=True,
                                args=(self.cmd_q, self.out_q, self.stop,
                                      self.running))
        self.proc.start()
        if self.out_q.get(timeout=300) != "ready":
            fail("control: the load generator process did not start")

    def run(self, cmd, timeout=600):
        self.cmd_q.put(cmd)
        return self.result(timeout)

    def start(self, cmd):
        """Start clients that run until `finish()`; returns once they
        are running."""
        self.stop.clear()
        self.cmd_q.put(dict(cmd, seconds=None))
        if not self.running.wait(timeout=120):
            fail("control: the load generator's clients never started")

    def finish(self, timeout=600):
        self.stop.set()
        try:
            return self.result(timeout)
        finally:
            self.stop.clear()

    def result(self, timeout):
        r = self.out_q.get(timeout=timeout)
        if "error" in r:
            fail(f"control: the load generator raised {r['error']}")
        return r

    def close(self):
        if self.proc is None:
            return
        self.stop.set()
        self.cmd_q.put(None)
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
        self.proc = None


def control_wait(cond, what, timeout_s=120.0):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            fail(f"control: {what} did not happen within {timeout_s:g} s")
        time.sleep(0.005)


def control_served(registry, model, version):
    """Requests the version's ParallelInference has completed."""
    return registry.entry(model).versions[version].pi.stats()[
        "requests_completed"]


def control_launch_delta(pc, before):
    now = pc.launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def control_resnet(torch, ResNet50, seed, bn_seed):
    """Full-width ResNet-50 (HW, 1000 classes, bf16, "pallas") with
    seeded weights and BatchNorm statistics, as phase 4 builds it."""
    net = ResNet50(input_shape=(HW, HW, 3), compute_dtype="bfloat16",
                   helpers="pallas", seed=seed).init_model(device=DEV)
    randomize_batchnorm(torch, net, seed=bn_seed)
    return net


def control_twin(torch, ResNet50, proto, dev):
    """Another instance of `proto` (same weights, its own tensors) on
    `dev`: a fleet replica's own ResNet-50."""
    from deeplearning4j_tpu_torch.util.tree import tree_map

    net = ResNet50(input_shape=(HW, HW, 3), compute_dtype="bfloat16",
                   helpers="pallas").init_model(device=dev)
    net.params = tree_map(lambda t: t.detach().clone().to(dev),
                          proto.params)
    net.states = tree_map(lambda t: t.detach().clone().to(dev),
                          proto.states)
    return net


def control_refs(np, net, pool):
    return [log_probs(np, net.output(x).float().cpu().numpy())
            for x in pool]


def control_server(torch, np, pc, net, load, pool, refs, phase4, card):
    """(a): ModelServer at full width on both wires."""
    from deeplearning4j_tpu_torch.parallel.serving import ModelServer

    t0 = time.perf_counter()
    server = ModelServer(net, model_name="resnet50", batch_limit=32,
                         queue_limit=256, device=DEV).start()
    url = f"http://127.0.0.1:{server.port}"
    log(f"control server: ModelServer({url}, batch_limit=32) warmed "
        f"buckets {server.pi.stats()['warmed_buckets']} in "
        f"{time.perf_counter() - t0:.1f} s")
    base = {"url": url, "model": "resnet50", "hw": HW,
            "refs": {"v1": refs}}
    # warm-up round of both wires, outside the windows
    load.run(dict(base, wire="npz", threads=SERVE_THREADS,
                  sizes=SERVE_SIZES, seconds=1.0))
    load.run(dict(base, wire="json", threads=CONTROL_JSON_THREADS,
                  sizes=(1,), seconds=0.5))
    b0 = server.pi.stats()["batches_dispatched"]
    pc.reset_launch_counts()
    res = {"npz": load.run(dict(base, wire="npz", threads=SERVE_THREADS,
                                sizes=SERVE_SIZES,
                                seconds=CONTROL_NPZ_S)),
           "json": load.run(dict(base, wire="json",
                                 threads=CONTROL_JSON_THREADS, sizes=(1,),
                                 seconds=CONTROL_JSON_S))}
    counts = pc.launch_counts()
    forwards = server.pi.stats()["batches_dispatched"] - b0
    res.update(launches=counts, forwards=forwards, url=url)
    for w in ("npz", "json"):
        r = res[w]
        log(f"control server {w}: {r['threads']} clients (a child "
            f"process), {r['requests']} requests, {r['images']} images in "
            f"{r['wall_s']:.3f} s = {r['req_per_s']:.1f} req/s, "
            f"{r['img_per_s']:.1f} img/s; latency ms p50="
            f"{r['latency_ms_p50']:.1f} p99={r['latency_ms_p99']:.1f}; "
            f"bytes per request {r['request_bytes']:.0f} in, "
            f"{r['response_bytes']:.0f} out; max |log p gap| "
            f"{r['worst_own_gap']:.3e} (limit {LOGP_TOL['served']:g}); "
            f"errors {r['errors']} [{card}]")
        if r["errors"] or r["mixed"] or r["requests"] == 0:
            fail(f"control server {w}: {r['errors']} errors "
                 f"{r['first_errors']}, {r['mixed']} responses off their "
                 f"reference {r['first_mixed']}")
    log(f"control server: npz {res['npz']['img_per_s']:.1f} img/s against "
        f"phase 4's in-process {phase4['img_per_s']:.1f} img/s "
        f"({res['npz']['img_per_s'] / phase4['img_per_s']:.3f}x); p50 "
        f"{res['npz']['latency_ms_p50']:.1f} ms against "
        f"{phase4['latency_ms_p50']:.1f}; launches {counts} over "
        f"{forwards} forwards [{card}]")
    for name, per in (("fused_conv1x1", 30), ("fused_conv3x3", 16)):
        if forwards <= 0 or counts[name] != per * forwards or \
                counts[f"{name}/wgmma"] != counts[name]:
            fail(f"control server: {name} launched {counts[name]} times "
                 f"({counts[f'{name}/wgmma']} wgmma) over {forwards} "
                 f"forwards, not {per} each on wgmma")
    return server, res


def control_swap(torch, np, pc, ResNet50, server, load, pool, refs, tmp,
                 card):
    """(b): hot swap under npz load — a verified v2 upload with
    activate, a corrupted upload (409), rollback, swap to v2 again."""
    from deeplearning4j_tpu_torch.parallel.serving import ModelClient
    from deeplearning4j_tpu_torch.resilience import ServingError
    from deeplearning4j_tpu_torch.util import model_serializer

    t0 = time.perf_counter()
    net2 = control_resnet(torch, ResNet50, seed=124, bn_seed=2)
    zp = os.path.join(tmp, "resnet50_v2.zip")
    model_serializer.write_model(net2, zp)
    del net2
    t_write = time.perf_counter() - t0
    ref_net = model_serializer.restore_computation_graph(zp, device=DEV)
    refs2 = control_refs(np, ref_net, pool)
    del ref_net
    torch.cuda.empty_cache()
    bad = os.path.join(tmp, "bad.zip")
    with open(bad, "wb") as f:
        f.write(b"corrupted upload bytes")
    with open(bad + ".sha256", "w") as f:
        f.write("0" * 64)
    reg, m = server.registry, "resnet50"
    admin = ModelClient(f"http://127.0.0.1:{server.port}", timeout=300.0)
    steps = {}
    before = pc.launch_counts()
    load.start({"url": f"http://127.0.0.1:{server.port}", "model": m,
                "hw": HW, "wire": "npz", "threads": SERVE_THREADS,
                "sizes": SERVE_SIZES, "refs": {"v1": refs, "v2": refs2}})
    try:
        n = control_served(reg, m, "v1")
        control_wait(lambda: control_served(reg, m, "v1")
                     >= n + CONTROL_SWAP_WAIT, "v1 traffic")
        t = time.perf_counter()
        admin.put_version(m, "v2", zp, activate=True)
        steps["put_s"] = time.perf_counter() - t
        try:
            admin.put_version(m, "vbad", bad)
            fail("control swap: the corrupted upload was accepted")
        except ServingError as e:
            steps["corrupt_status"] = e.status
            if e.status != 409:
                fail(f"control swap: the corrupted upload answered "
                     f"{e.status}, not 409")
        for target, op in (("v2", None), ("v1", "rollback"),
                           ("v2", "swap")):
            if op is not None:
                t = time.perf_counter()
                (admin.rollback(m) if op == "rollback"
                 else admin.swap(m, "v2"))
                steps[f"{op}_s"] = time.perf_counter() - t
            n = control_served(reg, m, target)
            control_wait(lambda: control_served(reg, m, target)
                         >= n + CONTROL_SWAP_WAIT, f"{target} traffic")
    finally:
        res = load.finish()
    routes = control_launch_delta(pc, before)
    res.update(steps=steps, launches=routes, zip_write_s=t_write,
               zip_bytes=os.path.getsize(zp),
               v2_compute_dtype=str(
                   reg.entry(m).versions["v2"].net.compute_dtype
                   or reg.entry(m).versions["v2"].net.dtype))
    log(f"control swap: {res['requests']} requests under "
        f"{SERVE_THREADS} npz clients, versions {res['versions']}; PUT v2 "
        f"(restore + warm-up + flip) {steps['put_s']:.3f} s, corrupted "
        f"upload {steps['corrupt_status']}, rollback "
        f"{steps['rollback_s']:.3f} s, swap {steps['swap_s']:.3f} s; "
        f"errors {res['errors']}, mixed {res['mixed']} (own gap <= "
        f"{res['worst_own_gap']:.3e}, other >= "
        f"{res['least_other_gap']:.3e}); v2 computes in "
        f"{res['v2_compute_dtype']} (a zip carries no compute dtype); "
        f"launches by route {routes} [{card}]")
    if res["errors"] or res["mixed"]:
        fail(f"control swap: {res['errors']} failed "
             f"{res['first_errors']}, {res['mixed']} mixed "
             f"{res['first_mixed']}")
    if set(res["versions"]) != {"v1", "v2"}:
        fail(f"control swap: versions served {res['versions']}")
    for name in ("fused_conv1x1", "fused_conv3x3"):
        if routes[f"{name}/simple"] <= 0 or routes[f"{name}/wgmma"] <= 0:
            fail(f"control swap: {name} routes {routes}: v1 (bf16) must "
                 f"take wgmma and v2 (f32) simple")
    return res, zp, refs2


def control_soak(torch, np, net, card):
    """(c): tenant admission at 2x capacity, in process through
    registry.entry().lease(), admission and pi.output (bench_serving.py
    bench_soak's path and tenant mix)."""
    from deeplearning4j_tpu_torch.resilience import (
        OverloadedError,
        QuotaExceededError,
    )
    from deeplearning4j_tpu_torch.serving import (
        AdmissionController,
        ModelRegistry,
        TenantConfig,
    )

    rng = np.random.default_rng(16)
    x = serving_inputs(np, rng, CONTROL_SOAK_ROWS)
    ref = log_probs(np, net.output(x).float().cpu().numpy())
    reg = ModelRegistry(device=DEV, batch_limit=32, queue_limit=64,
                        max_wait_ms=1.0)
    reg.register("resnet50", net)
    entry = reg.entry("resnet50")

    def predict(tenant, admission):
        with entry.lease() as (_, pi):
            prio = None
            if admission is not None:
                prio = admission.admit(tenant, "resnet50",
                                       pi.queue_depth(),
                                       pi.queue_limit).priority
            out = pi.output(x, priority=prio)
        return float(np.abs(log_probs(np, out) - ref).max())

    def closed_loop(clients, seconds):
        stop, n, lock = threading.Event(), [0], threading.Lock()

        def worker():
            while not stop.is_set():
                predict("gold", None)
                with lock:
                    n[0] += 1

        ts = [threading.Thread(target=worker) for _ in range(clients)]
        for t in ts:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in ts:
            t.join(timeout=60.0)
        return n[0] / seconds

    def open_loop(rates, seconds, admission):
        per = {t: {"ok": 0, "shed_quota": 0, "shed_pressure": 0,
                   "dropped": 0, "lat": [], "gap": 0.0} for t in rates}
        lock = threading.Lock()
        t_start = time.perf_counter()
        t_stop = t_start + seconds

        def one(tenant):
            t0 = time.perf_counter()
            try:
                gap = predict(tenant, admission)
            except QuotaExceededError as e:
                key = ("shed_pressure" if "pressure" in str(e)
                       else "shed_quota")
                with lock:
                    per[tenant][key] += 1
                return
            except OverloadedError:
                with lock:
                    per[tenant]["shed_pressure"] += 1
                return
            except Exception:   # noqa: BLE001 - counted, must be 0
                with lock:
                    per[tenant]["dropped"] += 1
                return
            with lock:
                per[tenant]["ok"] += 1
                per[tenant]["lat"].append(time.perf_counter() - t0)
                per[tenant]["gap"] = max(per[tenant]["gap"], gap)

        def generator(tenant, n_threads, i):
            interval = n_threads / rates[tenant]
            t_next = t_start + (i + 1) * interval / n_threads
            while True:
                now = time.perf_counter()
                if now >= t_stop:
                    return
                if t_next > now:
                    time.sleep(min(t_next - now, t_stop - now))
                    continue
                one(tenant)
                t_next += interval

        ts = []
        for tenant, rate in rates.items():
            n = min(16, max(2, int(rate / 60) + 1))
            ts += [threading.Thread(target=generator, args=(tenant, n, i))
                   for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=seconds + 120.0)
        return per

    def pct(lat, q):
        return float(np.percentile(np.array(lat) * 1e3, q)) if lat else None

    try:
        closed_loop(16, 0.5)
        capacity = closed_loop(16, CONTROL_CAPACITY_S)
        target = 2.0 * capacity
        admission = AdmissionController(
            {name: TenantConfig(name, priority=prio,
                                rate=(None if r is None
                                      else max(1.0, r * capacity)),
                                burst=burst)
             for name, _, prio, r, burst in CONTROL_SOAK_MIX},
            shed_thresholds=CONTROL_SHED_THRESHOLDS)
        rates = {name: w * target for name, w, *_ in CONTROL_SOAK_MIX}
        base = open_loop({"gold": rates["gold"]}, CONTROL_BASELINE_S,
                         admission)["gold"]
        per = open_loop(rates, CONTROL_SOAK_S, admission)
    finally:
        reg.shutdown()
    sheds = {t: d["shed_quota"] + d["shed_pressure"] for t, d in per.items()}
    total_shed = max(1, sum(sheds.values()))
    res = {"capacity_req_s": capacity, "target_req_s": target,
           "rows": CONTROL_SOAK_ROWS,
           "gold_unloaded_p50_ms": pct(base["lat"], 50),
           "gold_unloaded_p99_ms": pct(base["lat"], 99),
           "tenants": {t: {k: d[k] for k in ("ok", "shed_quota",
                                             "shed_pressure", "dropped")}
                       for t, d in per.items()}}
    for t, d in per.items():
        res["tenants"][t].update(p50_ms=pct(d["lat"], 50),
                                 p99_ms=pct(d["lat"], 99),
                                 shed_share=sheds[t] / total_shed,
                                 worst_logp_gap=d["gap"])
        log(f"control soak {t}: offered {rates[t]:.1f} req/s, ok {d['ok']}, "
            f"shed by quota {d['shed_quota']}, by pressure "
            f"{d['shed_pressure']}, dropped {d['dropped']}; p50 "
            f"{res['tenants'][t]['p50_ms']} ms, p99 "
            f"{res['tenants'][t]['p99_ms']} ms; share of sheds "
            f"{res['tenants'][t]['shed_share']:.3f} [{card}]")
    log(f"control soak: capacity {capacity:.1f} req/s of "
        f"{CONTROL_SOAK_ROWS} rows (closed loop, gold only, 16 clients), "
        f"open loop at {target:.1f} req/s for {CONTROL_SOAK_S:g} s; gold "
        f"p99 {res['tenants']['gold']['p99_ms']} ms loaded against "
        f"{res['gold_unloaded_p99_ms']} ms unloaded (p50 "
        f"{res['gold_unloaded_p50_ms']}) [{card}]")
    gold = per["gold"]
    if gold["shed_quota"] or gold["shed_pressure"] or gold["dropped"] \
            or gold["ok"] == 0:
        fail(f"control soak: gold lost requests: {res['tenants']['gold']}")
    if any(d["dropped"] for d in per.values()):
        fail(f"control soak: requests dropped: {res['tenants']}")
    if any(d["gap"] > LOGP_TOL["served"] for d in per.values()):
        fail("control soak: a response differs from direct output")
    if not sheds["bronze"] > max(sheds["silver"], sheds["gold"]):
        fail(f"control soak: bronze's share of the sheds is not the "
             f"largest: {sheds}")
    return res


def control_fleet(torch, np, ResNet50, net, zp, refs2, tmp, card):
    """(d): three in-process ModelServer replicas behind a
    ReplicaRouter and a FleetController(min=max=3): a canary-first
    rollout of v2, a poisoned rollout of v3 (breach, rollback,
    hold-down), a replica kill with backfill, under router clients."""
    from deeplearning4j_tpu_torch.observability import get_registry
    from deeplearning4j_tpu_torch.parallel.serving import ModelServer
    from deeplearning4j_tpu_torch.resilience import (
        RolloutHeldError,
        ServingError,
        injector,
    )
    from deeplearning4j_tpu_torch.serving import (
        FleetController,
        LocalReplica,
        ReplicaRouter,
        SLOPolicy,
    )
    from deeplearning4j_tpu_torch.util import model_serializer

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if DEV == "cuda" else torch.device(DEV)
    servers, m = [], "resnet50"

    def spawn():
        # builds on the indexed device: the controller may call it from
        # any thread
        srv = ModelServer(control_twin(torch, ResNet50, net, dev),
                          model_name=m, batch_limit=CONTROL_FLEET_BATCH,
                          queue_limit=64, device=dev).start()
        servers.append(srv)
        return LocalReplica(f"http://127.0.0.1:{srv.port}", srv.registry,
                            server=srv)

    rng = np.random.default_rng(8)
    x = serving_inputs(np, rng, CONTROL_FLEET_ROWS)
    refs = {"v1": log_probs(np, net.output(x).float().cpu().numpy())}
    ref2 = model_serializer.restore_computation_graph(zp, device=DEV)
    refs["v2"] = refs["v3"] = log_probs(
        np, ref2.output(x).float().cpu().numpy())
    del ref2
    zp3 = os.path.join(tmp, "resnet50_v3.zip")
    shutil.copyfile(zp, zp3)
    shutil.copyfile(zp + ".sha256", zp3 + ".sha256")
    handles = [spawn() for _ in range(CONTROL_FLEET)]
    router = ReplicaRouter([h.name for h in handles], timeout=120.0)
    controller = FleetController(
        handles, router=router, slo=SLOPolicy.parse(CONTROL_SLO),
        replica_factory=spawn, min_replicas=CONTROL_FLEET,
        max_replicas=CONTROL_FLEET, autoscale_interval_s=1e9,
        cooldown_s=1e9, holddown_s=600.0)
    build_s = time.perf_counter() - t0
    stop, lock = threading.Event(), threading.Lock()
    phase = ["clean"]
    stats = {"ok": 0, "failed": [], "poisoned": 0, "mixed": [],
             "versions": {}}

    def client():
        while not stop.is_set():
            try:
                r = router.predict(x, model=m)
            except ServingError as e:
                with lock:
                    poisoned = phase[0] != "clean" and (
                        e.status, e.error_class) == (500,
                                                     "FaultInjectedError")
                    if poisoned:
                        stats["poisoned"] += 1
                    else:
                        stats["failed"].append(repr(e))
                if poisoned:
                    time.sleep(0.005)   # no busy spin on instant 500s
                continue
            except Exception as e:   # noqa: BLE001 - counted, must be 0
                with lock:
                    stats["failed"].append(repr(e))
                continue
            v = r["version"]
            lp = log_probs(np, np.asarray(r["outputs"], np.float32))
            gap = float(np.abs(lp - refs[v]).max()) if v in refs \
                else float("inf")
            with lock:
                stats["ok"] += 1
                stats["versions"][v] = stats["versions"].get(v, 0) + 1
                if gap > LOGP_TOL["served"]:
                    stats["mixed"].append((v, gap))

    def served():
        with lock:
            return stats["ok"]

    threads = [threading.Thread(target=client)
               for _ in range(CONTROL_FLEET_CLIENTS)]
    reg = get_registry()
    rollout_names = ("dl4j_rollout_total", "dl4j_rollout_rollbacks_total",
                     "dl4j_rollout_holddowns_total",
                     "dl4j_fleet_replica_deaths_total")
    res = {"build_s": build_s}
    try:
        for t in threads:
            t.start()
        n = served()
        control_wait(lambda: served() >= n + 20, "fleet traffic")
        t = time.perf_counter()
        rep = controller.rollout(m, "v2", path=zp)
        res["rollout_v2"] = {"outcome": rep["outcome"],
                             "flipped": len(rep["flipped"]),
                             "seconds": time.perf_counter() - t}
        if rep["outcome"] != "completed":
            fail(f"control fleet: the v2 rollout did not complete: {rep}")
        n = served()
        control_wait(lambda: served() >= n + 20, "traffic on v2")
        with lock:
            phase[0] = "poison"
        injector().inject("rollout.canary_poison", mode="raise",
                          times=10 ** 9)
        t = time.perf_counter()
        try:
            rep = controller.rollout(m, "v3", path=zp3)
        finally:
            injector().clear("rollout.canary_poison")
            with lock:
                phase[0] = "after"
        res["rollout_v3"] = {"outcome": rep["outcome"],
                             "flipped": len(rep["flipped"]),
                             "breach": (rep["breach"] or {}).get("reason"),
                             "detection_s": rep["detection_s"],
                             "seconds": time.perf_counter() - t}
        if rep["outcome"] != "rolled_back":
            fail(f"control fleet: the poisoned v3 rollout was not rolled "
                 f"back: {rep}")
        actives = [h.active_version(m) for h in controller.replicas]
        if actives != ["v2"] * CONTROL_FLEET:
            fail(f"control fleet: after the rollback the replicas serve "
                 f"{actives}")
        try:
            controller.rollout(m, "v3", path=zp3)
            fail("control fleet: the held-down v3 rolled out again")
        except RolloutHeldError as e:
            res["holddown_failures"] = e.failures
        n = served()
        control_wait(lambda: served() >= n + 20, "traffic after rollback")
        with lock:
            failed_before_kill = len(stats["failed"])
        injector().inject("serving.replica_kill", mode="raise", times=1)
        t = time.perf_counter()
        victim = controller.replicas[0].name
        controller.tick()
        res["kill"] = {"seconds": time.perf_counter() - t,
                       "victim": victim, "members": router.urls()}
        if victim in router.urls() or len(router.urls()) != CONTROL_FLEET:
            fail(f"control fleet: the kill left {router.urls()}")
        n = served()
        control_wait(lambda: served() >= n + 20, "traffic after backfill")
        with lock:
            res["kill"]["failed"] = len(stats["failed"]) - \
                failed_before_kill
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120.0)
        controller.stop()
        for s in servers:
            s.stop()
        injector().clear()
    snap = reg.snapshot()
    res["counters"] = {k: {lab: v for lab, v in snap["counters"].get(
        k, {}).items()} for k in rollout_names}
    res["detection_hist"] = snap["histograms"].get(
        "dl4j_rollout_detection_seconds", {}).get("count")
    res.update(ok=stats["ok"], failed=len(stats["failed"]),
               poisoned=stats["poisoned"], mixed=len(stats["mixed"]),
               versions=stats["versions"])
    log(f"control fleet: {CONTROL_FLEET} replicas (batch_limit "
        f"{CONTROL_FLEET_BATCH}) built in {build_s:.1f} s, "
        f"{CONTROL_FLEET_CLIENTS} router clients of {CONTROL_FLEET_ROWS} "
        f"rows: v2 rollout {res['rollout_v2']['outcome']} in "
        f"{res['rollout_v2']['seconds']:.2f} s; poisoned v3 "
        f"{res['rollout_v3']['outcome']} in "
        f"{res['rollout_v3']['seconds']:.2f} s (breach "
        f"{res['rollout_v3']['breach']}, detection "
        f"{res['rollout_v3']['detection_s']:.2f} s), held down "
        f"(failures {res['holddown_failures']}); replica kill + backfill "
        f"{res['kill']['seconds']:.2f} s, {res['kill']['failed']} failed "
        f"[{card}]")
    log(f"control fleet: {stats['ok']} responses {stats['versions']}, "
        f"{len(stats['failed'])} failed, {len(stats['mixed'])} mixed, "
        f"{stats['poisoned']} poisoned 500s while the fault was armed; "
        f"counters {res['counters']} [{card}]")
    if stats["failed"] or stats["mixed"]:
        fail(f"control fleet: failed {stats['failed'][:3]}, mixed "
             f"{stats['mixed'][:3]}")
    return res


def control_generate(clients, reqs, model="decoder"):
    """Each request once through `clients` (one thread each, taking
    requests in turn); returns (tokens per request, seconds)."""
    outs = [None] * len(reqs)
    errors, nxt, lock = [], [0], threading.Lock()

    def worker(c):
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(reqs):
                return
            p, mx = reqs[i]
            try:
                outs[i] = c.generate(p, max_new_tokens=mx, model=model,
                                     timeout_s=300.0)["tokens"]
            except Exception as e:   # noqa: BLE001 - reported below
                errors.append(repr(e))

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(c,)) for c in clients]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        fail(f"control decode: generate raised {errors[:3]}")
    return outs, time.perf_counter() - t0


def control_decode(torch, np, seed, decode, oracle, card, tmp):
    """(e): decode over HTTP — phase 5i's bench over both wires, 429,
    migration, a cold restart from the journal, GPT-2-small width."""
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )
    from deeplearning4j_tpu_torch.resilience import (
        Retry,
        ServingError,
        injector,
    )
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        ReplicaRouter,
        sequential_decode,
    )
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    res = {}
    model = CausalTransformer(**DECODE_BENCH, device=DEV).init()
    prog = DecodeProgram(model, max_slots=DECODE_SLOTS,
                         page_size=DECODE_PAGE)
    prog.warmup(prog.init_kv())
    reqs = decode_requests(random.Random(seed), DECODE_REQUESTS,
                           DECODE_PROMPT, DECODE_NEW, model.vocab_size)
    tokens = sum(len(t) for t in oracle)

    def server(eng, **kw):
        return ModelServer(decode_engine=eng, model_name="decoder",
                           device=DEV, **kw).start()

    def url(s):
        return f"http://127.0.0.1:{s.port}"

    # bench width, both wires
    srv = server(DecodeEngine(program=prog, queue_limit=DECODE_REQUESTS,
                              max_prefills_per_step=DECODE_PREFILLS))
    try:
        for w in ("npz", "json"):
            clients = [ModelClient(url(srv), timeout=300.0, wire=w)
                       for _ in range(CONTROL_DECODE_CLIENTS)]
            outs, dt = control_generate(clients, reqs)
            res[w] = {"s": dt, "tok_s": tokens / dt,
                      "equal": outs == oracle}
            log(f"control decode {w}: {DECODE_REQUESTS} requests through "
                f"{CONTROL_DECODE_CLIENTS} ModelClient.generate threads, "
                f"{tokens} tokens in {dt:.3f} s = {tokens / dt:.1f} tok/s "
                f"against phase 5i's loop thread "
                f"{decode['bench']['loop_thread']['tok_s']:.1f} tok/s; "
                f"tokens equal to the oracle: {res[w]['equal']} [{card}]")
            if outs != oracle:
                fail(f"control decode {w}: tokens differ from the oracle")
    finally:
        srv.stop()

    # 429 + Retry-After from an over-subscribed engine
    eng = DecodeEngine(program=prog, queue_limit=0)
    srv = server(eng)
    try:
        held = [eng.submit([1, 2, 3], 100) for _ in range(DECODE_SLOTS)]
        c = ModelClient(url(srv), retry=Retry(max_attempts=1), breaker=None)
        try:
            c.generate([5, 9, 11], max_new_tokens=4, model="decoder")
            fail("control decode: an over-subscribed engine answered 200")
        except ServingError as e:
            res["oversubscribed"] = {"status": e.status,
                                     "retry_after_s": e.retry_after_s}
            if e.status != 429 or not e.retry_after_s:
                fail(f"control decode: over-subscribed engine answered "
                     f"{e.status} (Retry-After {e.retry_after_s})")
        for h in held:
            h.result(timeout_s=300.0)
    finally:
        srv.stop()

    # migration: a replica retiring mid-generation, with and without
    # serving.migrate_fail; then a cold restart from the journal
    prompt, mx = [8, 1, 13, 4], 96
    _, want = sequential_decode(prog, prompt, mx)

    def mid_stream(eng, then):
        control_wait(lambda: eng.stats()["tokens_total"] >= 3,
                     "a generation in flight")
        then()
        injector().clear("decode.hang")

    for drill, fault in (("migration", None), ("migrate_fail", True)):
        ea, eb = DecodeEngine(program=prog), DecodeEngine(program=prog)
        sa, sb = server(ea), server(eb)
        try:
            router = ReplicaRouter([url(sa), url(sb)],
                                   client_factory=lambda u: ModelClient(
                                       u, timeout=300.0, breaker=None,
                                       retry=Retry(max_attempts=1)))
            if fault:
                injector().inject("serving.migrate_fail", times=10)
            injector().inject("decode.hang", mode="delay", delay_s=0.01,
                              times=10 ** 9)
            box = {}
            t = threading.Thread(target=lambda: box.update(
                r=router.generate(prompt, max_new_tokens=mx,
                                  model="decoder", timeout_s=300.0)))
            t.start()
            mid_stream(ea, sa.stop)
            t.join(timeout=300.0)
            r = box.get("r")
            if r is None:
                fail(f"control decode {drill}: the routed generation "
                     f"did not finish")
            res[drill] = {"migrations": r["migrations"],
                          "replays": r["replays"],
                          "equal": r["tokens"] == want}
            log(f"control decode {drill}: replica A retired after 3 "
                f"tokens; {r['migrations']} migrations, {r['replays']} "
                f"replays; tokens equal to the oracle: "
                f"{res[drill]['equal']} [{card}]")
            if r["tokens"] != want or r["migrations"] != (0 if fault
                                                          else 1):
                fail(f"control decode {drill}: {res[drill]}")
        finally:
            injector().clear()
            sa.stop()
            sb.stop()

    jdir = os.path.join(tmp, "journal")
    e1 = DecodeEngine(program=prog)
    s1 = server(e1, journal_dir=jdir)
    c1 = ModelClient(url(s1), timeout=300.0, breaker=None,
                     retry=Retry(max_attempts=1))
    injector().inject("decode.hang", mode="delay", delay_s=0.01,
                      times=10 ** 9)
    t = threading.Thread(target=lambda: _swallow(lambda: c1.generate(
        prompt, max_new_tokens=mx, model="decoder", timeout_s=300.0,
        max_resumes=0, request_id="control-cold-0")))
    t.start()

    def kill():
        try:
            s1._httpd.socket.close()
        except (OSError, AttributeError):
            pass
        s1.stop()

    mid_stream(e1, kill)
    t.join(timeout=300.0)
    e2 = DecodeEngine(program=prog)
    s2 = server(e2, journal_dir=jdir)
    try:
        recovered = e2.stats()["journal"]["recovered"]
        out = ModelClient(url(s2), timeout=300.0, breaker=None).generate(
            prompt, max_new_tokens=mx, model="decoder", timeout_s=300.0,
            request_id="control-cold-0")
        res["cold_restart"] = {"recovered": recovered,
                               "equal": out["tokens"] == want}
        log(f"control decode cold restart: the killed server's journal "
            f"recovered {recovered} generation(s); tokens equal to the "
            f"oracle: {res['cold_restart']['equal']} [{card}]")
        if recovered != 1 or out["tokens"] != want:
            fail(f"control decode cold restart: {res['cold_restart']}")
    finally:
        s2.stop()
    del prog, model
    torch.cuda.empty_cache()

    # GPT-2-small width over the npz wire against the in-process engine
    model = CausalTransformer(**GPT2, seed=seed, device=DEV).init()
    prog = DecodeProgram(model, max_slots=GPT2_SLOTS, page_size=GPT2_PAGE)
    prog.warmup(prog.init_kv())
    reqs = decode_requests(random.Random(seed + 1), CONTROL_GPT2_REQUESTS,
                           CONTROL_GPT2_PROMPT, GPT2_NEW, model.vocab_size)
    inproc, dt_in, _, _ = decode_engine_run(torch, prog, reqs,
                                            GPT2_PREFILLS)
    srv = server(DecodeEngine(program=prog, queue_limit=len(reqs),
                              max_prefills_per_step=GPT2_PREFILLS))
    try:
        outs, dt = control_generate(
            [ModelClient(url(srv), timeout=300.0, wire="npz")
             for _ in reqs], reqs)
    finally:
        srv.stop()
    n_tok = sum(len(t) for t in inproc)
    res["gpt2"] = {"requests": len(reqs), "tokens": n_tok,
                   "http_tok_s": n_tok / dt, "inproc_tok_s": n_tok / dt_in,
                   "equal": outs == inproc}
    log(f"control decode gpt2: {len(reqs)} requests (prompts "
        f"{CONTROL_GPT2_PROMPT[0]}-{CONTROL_GPT2_PROMPT[1]} tokens), "
        f"{n_tok} tokens over the npz wire {n_tok / dt:.1f} tok/s against "
        f"the in-process engine {n_tok / dt_in:.1f} tok/s; tokens equal: "
        f"{res['gpt2']['equal']} [{card}]")
    if outs != inproc:
        fail("control decode gpt2: the served tokens differ from the "
             "in-process engine's")
    del prog, model
    torch.cuda.empty_cache()
    return res


def _swallow(fn):
    """Call `fn`, ignoring what it raises (a drill's kill is the point)."""
    try:
        fn()
    except Exception:   # noqa: BLE001 - the drill kills the server
        pass


def control_phase(torch, np, pc, card, seed, serving, decode,
                  decode_oracle):
    """Phase 5j: the serving control plane (lines start "control ").
    The kernel launch counters are set to 0 before (a)'s measured
    windows and before (b)'s drill and read after each."""
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    res, secs = {}, {}
    t0 = time.perf_counter()
    net = control_resnet(torch, ResNet50, seed=123, bn_seed=1)
    pool = serving_pool(np, HW)
    refs = control_refs(np, net, pool)
    load = ControlLoad()
    secs["setup"] = time.perf_counter() - t0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            server, res["server"] = control_server(
                torch, np, pc, net, load, pool, refs, serving, card)
            secs["server"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                res["swap"], zp, refs2 = control_swap(
                    torch, np, pc, ResNet50, server, load, pool, refs, tmp,
                    card)
            finally:
                server.stop()
            secs["swap"] = time.perf_counter() - t0
            load.close()
            t0 = time.perf_counter()
            res["soak"] = control_soak(torch, np, net, card)
            secs["soak"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["fleet"] = control_fleet(torch, np, ResNet50, net, zp,
                                         refs2, tmp, card)
            secs["fleet"] = time.perf_counter() - t0
            del net
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res["decode"] = control_decode(torch, np, seed, decode,
                                           decode_oracle, card, tmp)
            secs["decode"] = time.perf_counter() - t0
    finally:
        load.close()
    a, b = res["server"]["launches"], res["swap"]["launches"]
    res["launches"] = {k: a[k] for k in pc.LAUNCHES}
    res["launches_by_route"] = {
        k: {r: a[f"{k}/{r}"] + b[f"{k}/{r}"] for r in ("wgmma", "simple")}
        for k in ("fused_conv1x1", "fused_conv3x3")}
    res["seconds"] = secs
    log("control phase: seconds per part " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    return res


# ------------------------------------------------------------ phase 5k


def cluster_worker_argv(out, resume_step, hb, det, wedge, hang_exit_after):
    """The flagship worker's command line (tests/fixtures/torch/
    cluster_worker.py): ResNet-50 at full width, bf16, "pallas", batch
    TRAIN_BATCH, CLUSTER_STEPS steps in GROUP_K-step windows, a
    checkpoint after each, TM_DATA seeded batches."""
    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable,
            os.path.join(here, "tests", "fixtures", "torch",
                         "cluster_worker.py"),
            out, str(resume_step), "--hb", hb, "--model", "resnet50",
            "--device", DEV, "--steps", str(CLUSTER_STEPS),
            "--k", str(GROUP_K), "--batch", str(TRAIN_BATCH),
            "--hw", str(HW), "--classes", "1000", "--data", str(TM_DATA),
            "--timeout", str(CLUSTER_WATCHDOG_S),
            "--hang-exit-after", str(hang_exit_after),
            "--wedge-window", str(CLUSTER_WEDGE_WINDOW if wedge else 0),
            "--wedge", CLUSTER_WEDGE, "--wedge-s", str(CLUSTER_WEDGE_S)]
    return argv + (["--deterministic"] if det else [])


def worker_log_tails(hb_dir):
    tails = []
    for fn in sorted(os.listdir(hb_dir)):
        if fn.endswith(".log"):
            with open(os.path.join(hb_dir, fn), errors="replace") as f:
                tails.append(f"--- {fn}\n" + f.read()[-3000:])
    return "\n".join(tails)


def cluster_run(np, tmp, name, det, wedge=False, hang_exit_after=2):
    """One ClusterSupervisor(nprocs=1) run of the flagship worker: the
    supervisor's stats, the wall time, each generation's report, the
    final state, the wedge's time and the watchdog's records."""
    from deeplearning4j_tpu_torch.resilience import (
        ClusterSupervisor,
        heartbeat_path,
    )

    out = os.path.join(tmp, name)
    hb_dir = os.path.join(out, "hb")

    def command_fn(rank, nprocs, port, resume_step):
        return cluster_worker_argv(out, resume_step,
                                   heartbeat_path(hb_dir, rank), det, wedge,
                                   hang_exit_after)

    env = dict(os.environ)
    env.pop("DL4J_TPU_FAULTS", None)
    cs = ClusterSupervisor(1, command_fn, hb_dir,
                           checkpoint_dir=os.path.join(out, "ckpt"),
                           lease_timeout_s=CLUSTER_LEASE_S,
                           startup_grace_s=CLUSTER_STARTUP_GRACE_S,
                           poll_s=0.1, grace_s=3.0, restart_backoff_s=0.1,
                           env=env)
    t0 = time.time()
    try:
        stats = cs.run(timeout_s=CLUSTER_RUN_S)
    except Exception as e:   # noqa: BLE001 - report the workers' logs
        fail(f"cluster {name}: {type(e).__name__}: {e}\n"
             f"{worker_log_tails(hb_dir)}")
    res = {"stats": stats, "wall_s": time.time() - t0, "gens": {},
           "wedge": None, "watchdog": []}
    for fn in os.listdir(out):
        if fn.startswith("gen-") and fn.endswith(".json"):
            with open(os.path.join(out, fn)) as f:
                res["gens"][int(fn[4:-5])] = json.load(f)
    with np.load(os.path.join(out, "final.npz")) as z:
        res["final"] = {k: z[k] for k in z.files}
    if os.path.exists(os.path.join(out, "wedge.json")):
        with open(os.path.join(out, "wedge.json")) as f:
            res["wedge"] = json.load(f)["time"]
    wlog = os.path.join(out, "watchdog-0.log")
    if os.path.exists(wlog):
        with open(wlog) as f:
            for line in f:
                t, _, msg = line.partition(" ")
                res["watchdog"].append((float(t), msg.strip()))
    return res


def cluster_gen_checks(name, gen):
    """A generation's kernel launches (30/16/30/30 per step, all
    "wgmma") and its capture forensics (one event, k = GROUP_K, from
    the warm-up capture; none in the fit, whose windows replay)."""
    want = {"fused_conv1x1": 30, "fused_conv3x3": 16, "dgrad_conv1x1": 30,
            "wgrad_conv1x1": 30}
    for k, n in want.items():
        if gen["launches_per_step"][k] != n or gen["wgmma_per_step"][k] != n:
            fail(f"cluster {name}: {k} launched "
                 f"{gen['launches_per_step'][k]} times per step "
                 f"({gen['wgmma_per_step'][k]} on wgmma), not {n}, all on "
                 "wgmma")
    ev = gen["capture_events"]
    windows = gen["steps_run"] // GROUP_K
    if not (len(ev) == 1 and ev[0]["k"] == GROUP_K
            and gen["captures_in_fit"] == 0
            and gen["replays"] == 1 + windows):
        fail(f"cluster {name}: capture events {ev}, captures in the fit "
             f"{gen['captures_in_fit']}, replays {gen['replays']} (want one "
             f"event of k={GROUP_K}, none in the fit, {1 + windows} replays)")


def cluster_phase(torch, np, card, det, tm_ms):
    """Phase 5k (a): the flagship under cluster supervision (module
    docstring). `det`: phase 5b's cuDNN setting for bitwise checks;
    `tm_ms`: phase 5d's TrainingMaster ms/step at GROUP_K."""
    res = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        oracle = cluster_run(np, tmp, "oracle", det)
        hang = cluster_run(np, tmp, "hang_exit", det, wedge=True,
                           hang_exit_after=2)
        stale = cluster_run(np, tmp, "stale_lease", det, wedge=True,
                            hang_exit_after=10 ** 6)
    st = oracle["stats"]
    g0 = oracle["gens"].get(0)
    if st["gang_restarts"] != 0 or g0 is None \
            or int(oracle["final"]["iteration"]) != CLUSTER_STEPS:
        fail(f"cluster oracle: {st['ledger']}, generations "
             f"{sorted(oracle['gens'])}")
    cluster_gen_checks("oracle", g0)
    res["oracle"] = {
        "wall_s": oracle["wall_s"], "startup_s": g0["t_ready"] - g0["t_start"],
        "capture_s": g0["capture_s"], "ms_per_step": g0["ms_per_step"],
        "ms_per_step_without_checkpoints":
            g0["ms_per_step_without_checkpoints"],
        "checkpoint_s": g0["checkpoint_s"], "tm_ms_per_step": tm_ms,
        "loss": g0["loss"], "heartbeat": g0["heartbeat"]}
    o = res["oracle"]
    log(f"cluster oracle: ClusterSupervisor(nprocs=1) over the flagship "
        f"worker, {CLUSTER_STEPS} steps (TrainingMaster steps_per_dispatch="
        f"{GROUP_K}, a checkpoint per window, StepWatchdog(heartbeat=..., "
        f"hang_exit_after=2)): wall {o['wall_s']:.2f} s, process start to "
        f"ready {o['startup_s']:.2f} s (of it the group's capture "
        f"{o['capture_s']:.2f} s), {o['ms_per_step']:.2f} ms/step with its "
        f"checkpoints ({o['checkpoint_s']:.2f} s of them), "
        f"{o['ms_per_step_without_checkpoints']:.2f} without, beside phase "
        f"5d's TrainingMaster {tm_ms:.2f} ms/step (no lease, no checkpoints,"
        f" no per-window host read); lease writes {o['heartbeat']}; loss "
        f"{o['loss']:.4f}; launches per step {g0['launches_per_step']} (all "
        f"wgmma); capture events {g0['capture_events']} [{card}]")
    launches = {k: 0.0 for k in g0["launches_per_step"]}
    reasons = {"hang_exit": ("hang_hard", "hang_marker"),
               "stale_lease": ("heartbeat_stale",)}
    for name, run in (("hang_exit", hang), ("stale_lease", stale)):
        st = run["stats"]
        gens = run["gens"]
        ledger = st["ledger"]
        if not (st["gang_restarts"] == 1 and len(ledger) == 1
                and ledger[0]["reason"] in reasons[name]
                and st["resume_steps"] == [2 * GROUP_K]
                and sorted(gens) == [2 * GROUP_K]):
            fail(f"cluster {name}: gang restarts {st['gang_restarts']}, "
                 f"ledger {ledger}, resume steps {st['resume_steps']}, "
                 f"generations that finished {sorted(gens)}")
        g = gens[2 * GROUP_K]
        cluster_gen_checks(name, g)
        same = (sorted(run["final"]) == sorted(oracle["final"])
                and all(np.array_equal(run["final"][k], oracle["final"][k])
                        for k in oracle["final"]))
        if not same:
            diff = [k for k in oracle["final"]
                    if not np.array_equal(run["final"].get(k),
                                          oracle["final"][k])]
            fail(f"cluster {name}: the relaunched run does not end bit for "
                 f"bit where the oracle ends ({len(diff)} arrays differ)")
        r = {"wall_s": run["wall_s"], "reason": ledger[0]["reason"],
             "gang_restarts": st["gang_restarts"],
             "resume_step": st["resume_steps"][0],
             "wedge_to_relaunch_s": g["t_start"] - run["wedge"],
             "relaunch_to_first_step_s": g["t_first_window"] - g["t_start"],
             "arrays_bitwise": len(oracle["final"])}
        detections = [t for t, m in run["watchdog"] if "no heartbeat" in m]
        exits = [t for t, m in run["watchdog"] if "exiting 86" in m]
        if detections:
            r["wedge_to_detection_s"] = detections[0] - run["wedge"]
        if name == "hang_exit":
            if not (detections and exits):
                fail(f"cluster {name}: the watchdog's records show no "
                     f"detection or no hard exit: {run['watchdog']}")
            r["detection_to_exit_s"] = exits[0] - detections[0]
        elif exits:
            fail(f"cluster {name}: the watchdog exited: {run['watchdog']}")
        res[name] = r
        for k in launches:
            launches[k] += g["launches_per_step"][k] * g["steps_run"]
        log(f"cluster {name}: wedge in a CUDA wait (torch.cuda._sleep + "
            f"synchronize) at the start of window {CLUSTER_WEDGE_WINDOW}, "
            f"first generation only; ledger reason {r['reason']}, "
            f"{r['gang_restarts']} gang restart, resumed from step "
            f"{r['resume_step']}; wedge to first watchdog detection "
            + (f"{r['wedge_to_detection_s']:.2f} s" if "wedge_to_detection_s"
               in r else "none")
            + (f", detection to the hard exit {r['detection_to_exit_s']:.2f} s"
               if "detection_to_exit_s" in r else "")
            + f"; wedge to the relaunched process's start "
            f"{r['wedge_to_relaunch_s']:.2f} s, relaunch to its first "
            f"window {r['relaunch_to_first_step_s']:.2f} s; wall "
            f"{r['wall_s']:.2f} s; {r['arrays_bitwise']} state arrays bit "
            f"for bit the oracle's; launches per step "
            f"{g['launches_per_step']} (all wgmma) [{card}]")
    for k in launches:
        launches[k] += g0["launches_per_step"][k] * g0["steps_run"]
    res["launches"] = {k: int(round(v)) for k, v in launches.items()}
    return res


def mnist_shaped(np, n, seed=0):
    """n MNIST-shaped rows (784 wide) and labels, made as the port's
    MNIST stand-in makes them (datasets/fetchers.py): 10 shared class
    templates + noise, clipped to [0, 1]."""
    templates = np.random.default_rng(42).normal(size=(10, 28, 28)) > 1.0
    rng = np.random.default_rng(seed)
    labs = rng.integers(0, 10, n)
    x = (templates[labs] * 0.9
         + rng.normal(scale=0.1, size=(n, 28, 28))).astype(np.float32)
    return np.clip(x, 0, 1).reshape(n, 784), labs


def label_share(torch, emb, labels, k=10):
    """The share of each point's k nearest points in the embedding that
    carry its label (on the card)."""
    from deeplearning4j_tpu_torch.clustering import knn

    e = torch.as_tensor(emb, device=DEV)
    idx, _ = knn(e, e, k + 1, tile=4096)
    lab = torch.as_tensor(labels, device=DEV)
    return float((lab[idx[:, 1:]] == lab[:, None]).float().mean())


def host_copy(t):
    """A host copy of `t` that later in-place updates leave alone."""
    return t.detach().cpu().clone().numpy()


def tsne_step_err(np, a, b):
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def tsne_cpu_worker(job, cfg):
    """The CPU side of phase 5k's t-SNE and k-means checks, in a spawned
    process (CPU only) so the card's work runs on meanwhile: from the
    card's own arrays (files under `job`), the port on the CPU computes
    (b)'s P rows and first iterations, (c)'s kNN rows, sparse P and
    first iterations, and (d)'s k-means. `cfg` carries the sizes (a
    spawned process imports this module afresh)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.clustering import KMeansClustering, knn
    from deeplearning4j_tpu_torch.clustering import tsne as pt

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    ld = lambda name: np.load(os.path.join(job, name))
    out = {}
    x = torch.from_numpy(ld("x.npy"))
    xb = x[:cfg["exact_n"]]
    rows = torch.from_numpy(ld("rows.npy"))
    # (b): P rows (each row's beta search is its own), then iterations
    d2 = pt.pairwise_distance(xb[rows], xb, "sqeuclidean", device="cpu")
    mask = torch.zeros_like(d2, dtype=torch.bool)
    mask[torch.arange(len(rows)), rows] = True
    d2.masked_fill_(mask, 0.0)
    out["b_pc_rows"] = pt._beta_search(d2, mask, cfg["perplexity"],
                                       50).numpy()
    p = torch.from_numpy(ld("b_P.npy"))
    sb = ld("b_states.npz")
    ys, kls = [], []
    t = pt.Tsne(perplexity=cfg["perplexity"], device="cpu")
    for it in range(cfg["exact_steps"]):
        ex, mom = t._schedule(it)
        y, vel = torch.from_numpy(sb["y"][it]), torch.from_numpy(sb["vel"][it])
        g, kl = pt._tsne_grad(y, p, ex)
        vel = mom * vel - t.learning_rate * g
        y = y + vel
        ys.append((y - torch.mean(y, dim=0)).numpy())
        kls.append(float(kl))
    out["b_y"], out["b_kl"] = np.stack(ys), np.asarray(kls)
    del p
    # (c): kNN rows against all rows, the sparse P from the card's
    # neighbours, then iterations
    idx_r, dist_r = knn(x[rows], x, int(3 * cfg["perplexity"]) + 1,
                        device="cpu")
    out["c_knn_idx"], out["c_knn_dist"] = idx_r.numpy(), dist_r.numpy()
    idx = torch.from_numpy(ld("c_idx.npy"))
    psym, mutual = pt._sparse_psym(idx, torch.from_numpy(ld("c_d.npy")),
                                   cfg["perplexity"], cfg["row_block"])
    out["c_psym"], out["c_mutual"] = psym.numpy(), mutual.numpy()
    sc = ld("c_states.npz")
    psym_card = torch.from_numpy(ld("c_psym.npy"))
    mutual_card = torch.from_numpy(ld("c_mutual.npy"))
    ys, kls = [], []
    for it in range(cfg["chunked_steps"]):
        ex, mom = t._schedule(it)
        y, _, kl = pt._chunked_step(
            torch.from_numpy(sc["y"][it].copy()),
            torch.from_numpy(sc["vel"][it].copy()), idx, psym_card,
            mutual_card, ex, mom, t.learning_rate, cfg["row_block"],
            x.shape[0])
        ys.append(y.numpy())
        kls.append(float(kl))
    out["c_y"], out["c_kl"] = np.stack(ys), np.asarray(kls)
    # (d)
    km = KMeansClustering(cfg["kmeans_k"],
                          max_iterations=cfg["kmeans_iters"], device="cpu")
    out["d_init"] = km._init_centers(x)
    cs = km.apply(x)
    out["d_assign"], out["d_centers"] = cs.assignments, cs.centers
    out["d_inertia"] = np.asarray(cs.inertia)
    np.savez(os.path.join(job, "cpu.npz"), **out)


def tsne_fit(torch, t, xc, labels, r):
    """Time `t.fit_transform` on the card and fill `r` (its seconds per
    iteration net of the affinities' `r["p_s"]`, peak memory, the KL at
    the first, 100th and last iteration, the 10-NN label share)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = t.fit_transform(xc)
    torch.cuda.synchronize()
    r["fit_s"] = time.perf_counter() - t0
    r["s_per_iter"] = (r["fit_s"] - r["p_s"]) / t.max_iter
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["kl_first"] = float(t.kl_history_[0])
    r["kl_100"] = float(t.kl_history_[t.stop_lying_iteration])
    r["kl_final"] = t.kl_
    r["label_share"] = label_share(torch, emb, labels)
    return emb


def tsne_exact(torch, np, pt, Tsne, xc, job):
    """(b), before the fit: P on the card (its seconds warm), TSNE_
    EXACT_CPU_STEPS iterations from the seeded start with their states,
    and the CPU process's inputs under `job`."""
    n = xc.shape[0]
    t = Tsne(perplexity=TSNE_PERPLEXITY, max_iter=TSNE_EXACT_ITERS,
             method="exact", device=DEV)

    def affinities():
        pc = pt._p_conditional(xc, TSNE_PERPLEXITY)
        return pc, torch.clamp_min((pc + pc.T) / (2.0 * n), 1e-12)

    pc, p = affinities()
    del pc, p
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc, p = affinities()
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    rows = np.random.default_rng(3).choice(n, TSNE_CHECK_ROWS, replace=False)
    np.save(os.path.join(job, "rows.npy"), rows)
    pc_rows = pc[torch.as_tensor(rows, device=DEV)].cpu().numpy()
    del pc
    np.save(os.path.join(job, "b_P.npy"), p.cpu().numpy())
    y = t.initial_embedding(n).to(DEV)
    vel = torch.zeros_like(y)
    ys, vels, kls = [host_copy(y)], [host_copy(vel)], []
    for it in range(TSNE_EXACT_CPU_STEPS):
        ex, mom = t._schedule(it)
        g, kl = pt._tsne_grad(y, p, ex)
        vel = mom * vel - t.learning_rate * g
        y = y + vel
        y = y - torch.mean(y, dim=0)
        ys.append(host_copy(y))
        vels.append(host_copy(vel))
        kls.append(float(kl))
    np.savez(os.path.join(job, "b_states.npz"), y=np.stack(ys),
             vel=np.stack(vels))
    del p
    # the loop above is fit_transform's: its first iterations, alone
    short = Tsne(perplexity=TSNE_PERPLEXITY, max_iter=TSNE_EXACT_CPU_STEPS,
                 method="exact", device=DEV).fit_transform(xc)
    r = {"n": n, "iters": TSNE_EXACT_ITERS, "p_s": p_s,
         "loop_err": tsne_step_err(np, short, ys[-1])}
    # bound per iteration: P read once (4 B per pair) against the
    # gradient's operations, 27 per pair as _tsne_grad does them (the
    # d2 matmul 4 + 4 elementwise, num 2, Z 1, q 2, pq 3, rowsum 1, neg
    # 1, the pq @ y matmul 4, KL 5)
    pairs = float(n) * n
    r["bound_ms"] = max(4.0 * pairs / HBM_BYTES_PER_S,
                        27.0 * pairs / F32_FLOPS_PER_S) * 1e3
    r["bound_by"] = ("bytes" if 4.0 / HBM_BYTES_PER_S
                     >= 27.0 / F32_FLOPS_PER_S else "operations")
    return r, t, pc_rows, kls, ys


def tsne_chunked(torch, np, pt, Tsne, xc, job):
    """(c), before the fit: the kNN (timed alone) and the sparse P on
    the card, TSNE_CHUNKED_CPU_STEPS iterations from the seeded start
    with their states, and the CPU process's inputs under `job`."""
    from deeplearning4j_tpu_torch.clustering import knn

    n = xc.shape[0]
    t = Tsne(perplexity=TSNE_PERPLEXITY, max_iter=TSNE_CHUNKED_ITERS,
             method="chunked", row_block=TSNE_ROW_BLOCK, device=DEV)
    k = int(3 * TSNE_PERPLEXITY)
    knn(xc[:TSNE_ROW_BLOCK], xc, k + 1)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn(xc, xc, k + 1, tile=TSNE_ROW_BLOCK)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx, d = t.sparse_neighbours(xc)
    psym, mutual = pt._sparse_psym(idx, d, TSNE_PERPLEXITY, TSNE_ROW_BLOCK)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    for name, a in (("c_idx", idx), ("c_d", d), ("c_psym", psym),
                    ("c_mutual", mutual)):
        np.save(os.path.join(job, name + ".npy"), a.cpu().numpy())
    blk = TSNE_ROW_BLOCK
    n_pad = -(-n // blk) * blk
    y = torch.cat([t.initial_embedding(n).to(DEV),
                   torch.full((n_pad - n, 2), 1e6, device=DEV)])
    vel = torch.zeros_like(y)
    ys, vels, kls = [host_copy(y)], [host_copy(vel)], []
    for it in range(TSNE_CHUNKED_CPU_STEPS):
        ex, mom = t._schedule(it)
        y, vel, kl = pt._chunked_step(y, vel, idx, psym, mutual, ex, mom,
                                      t.learning_rate, blk, n)
        ys.append(host_copy(y))
        vels.append(host_copy(vel))
        kls.append(float(kl))
    np.savez(os.path.join(job, "c_states.npz"), y=np.stack(ys),
             vel=np.stack(vels))
    r = {"n": n, "k": k, "iters": TSNE_CHUNKED_ITERS, "knn_s": knn_s,
         "p_s": p_s}
    # bound per iteration: y, vel in and out, idx (int64), psym, mutual
    # read once, against the repulsive pass's operations over the real
    # pairs, 18 per pair as _chunked_step does them (the augmented 1 + d2
    # matmul 8, clamp and reciprocal 2, Z 1, square 1, the [y, 1] matmul
    # 6); the kNN-pattern work (n x K) is under 0.1% of it
    nbytes = 4.0 * n_pad * 2 * 4 + n * k * (8 + 4 + 1)
    ops = 18.0 * float(n) * n
    r["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                        ops / F32_FLOPS_PER_S) * 1e3
    r["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= ops / F32_FLOPS_PER_S else "operations")
    # the kNN: x read once, 2 x N^2 x D operations for the matmul
    r["knn_bound_ms"] = max(
        (2.0 * n * TSNE_D * 4) / HBM_BYTES_PER_S,
        2.0 * n * n * TSNE_D / F32_FLOPS_PER_S) * 1e3
    return r, t, idx, psym, mutual, kls, ys


def nn_brute_f64(torch, queries, corpus, k):
    """Exact k nearest corpus rows of `queries` in float64 on the card
    (chunks of the corpus; each chunk's best k, then the best k of
    those)."""
    q = queries.double()
    q2 = (q * q).sum(1, keepdim=True)
    best_d, best_i = [], []
    step = 1 << 18
    for s in range(0, corpus.shape[0], step):
        c = corpus[s:s + step].double()
        d2 = q2 + (c * c).sum(1)[None, :] - 2.0 * (q @ c.T)
        dv, di = torch.topk(d2, k, dim=1, largest=False)
        best_d.append(dv)
        best_i.append(di + s)
    dv, pos = torch.topk(torch.cat(best_d, 1), k, dim=1, largest=False)
    return torch.gather(torch.cat(best_i, 1), 1, pos), dv.clamp_min(0).sqrt()


def same_neighbours(np, got, want, got_d64, want_d64, scale):
    """A k-NN answer computed in f32 by |q|^2 + |x|^2 - 2 q.x is right
    when the exact (f64) squared distances of the neighbours it names,
    sorted, are the reference's k smallest, each within that formula's
    rounding: KNN_ULPS x 2^-24 x `scale` ([rows], |q|^2 + the largest
    |x|^2). Where its indices differ from the reference's, two
    neighbours tie within that rounding. Returns the count of rows whose
    indices differ, or None when the answer is wrong."""
    err = np.abs(np.sort(got_d64, axis=1) ** 2 - want_d64 ** 2)
    if (err > KNN_ULPS * 2.0 ** -24 * np.asarray(scale)[:, None]).any():
        return None
    return int((got != want).any(axis=1).sum())


def norm2(np, a):
    return (np.asarray(a, np.float64) ** 2).sum(-1)


def exact_dists(np, q, pts, idx):
    """||q_r - pts[idx[r, c]]|| in float64 on the host."""
    q = np.asarray(q, np.float64)
    return np.sqrt(((q[:, None, :] - np.asarray(pts[idx], np.float64)) ** 2)
                   .sum(-1))


def nn_serving(torch, np, card):
    """(e): NearestNeighborsServer over NN_ROWS x NN_DIM on the card."""
    from deeplearning4j_tpu_torch.clustering import (
        KDTree,
        NearestNeighborsClient,
        NearestNeighborsServer,
        VPTree,
        knn,
    )

    gen = torch.Generator(device=DEV).manual_seed(11)
    corpus = torch.randn(NN_ROWS, NN_DIM, generator=gen, device=DEV)
    rng = np.random.default_rng(12)
    checks = rng.normal(size=(NN_CHECK_QUERIES, NN_DIM)).astype(np.float32)
    res = {}
    server = NearestNeighborsServer(corpus, port=0, device=DEV).start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        client = NearestNeighborsClient(url, timeout=120.0)
        st = client.status()
        if st != {"num_points": NN_ROWS, "dims": NN_DIM,
                  "metric": "euclidean"}:
            fail(f"nn: /status {st}")
        got = []
        for s in range(0, NN_CHECK_QUERIES, NN_QUERIES):
            got += client.knn_batch(checks[s:s + NN_QUERIES], k=NN_K)
        gi = np.asarray([r["indices"] for r in got])
        qd = torch.as_tensor(checks, device=DEV).double()
        bi, bd = nn_brute_f64(torch, qd, corpus, NN_K)
        gd = ((qd[:, None, :] - corpus[torch.as_tensor(gi, device=DEV)]
               .double()) ** 2).sum(-1).sqrt()
        cmax = float((corpus * corpus).sum(1).max())
        swaps = same_neighbours(np, gi, bi.cpu().numpy(), gd.cpu().numpy(),
                                bd.cpu().numpy(), norm2(np, checks) + cmax)
        derr = float(np.abs(np.asarray([r["distances"] for r in got])
                            - bd.cpu().numpy()).max())
        if swaps is None or derr > 1e-3:
            fail(f"nn: served indices differ from the f64 brute force "
                 f"(distance error {derr})")
        res["check"] = {"queries": NN_CHECK_QUERIES, "tie_swaps": swaps,
                        "max_dist_err": derr}
        # the load: NN_CLIENTS threads, NN_QUERIES queries per request
        lat, errors, lock = [], [], threading.Lock()
        stop = threading.Event()

        def client_loop(seed):
            c = NearestNeighborsClient(url, timeout=120.0)
            r = np.random.default_rng(seed)
            while not stop.is_set():
                q = r.normal(size=(NN_QUERIES, NN_DIM))
                t0 = time.perf_counter()
                try:
                    out = c.knn_batch(q, k=NN_K)
                    ok = len(out) == NN_QUERIES
                except Exception as e:   # noqa: BLE001 - counted, fails below
                    ok = False
                    out = e
                with lock:
                    (lat if ok else errors).append(
                        time.perf_counter() - t0 if ok else repr(out))

        threads = [threading.Thread(target=client_loop, args=(100 + i,),
                                    daemon=True) for i in range(NN_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(NN_WINDOW_S)
        stop.set()
        for th in threads:
            th.join(timeout=120.0)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    if errors or any(th.is_alive() for th in threads):
        fail(f"nn: {len(errors)} failed requests: {errors[:3]}")
    ms = np.asarray(lat) * 1e3
    res["load"] = {"requests": len(lat), "req_per_s": len(lat) / wall,
                   "queries_per_s": len(lat) * NN_QUERIES / wall,
                   "p50_ms": float(np.percentile(ms, 50)),
                   "p99_ms": float(np.percentile(ms, 99))}
    # the device's share of a request: knn of NN_QUERIES queries alone
    q = torch.as_tensor(checks[:NN_QUERIES], device=DEV)
    for _ in range(3):
        knn(q, corpus, NN_K)
    reps = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        knn(q, corpus, NN_K)
    end.record()
    end.synchronize()
    dev_ms = start.elapsed_time(end) / reps
    nbytes = 4.0 * (NN_ROWS * NN_DIM + NN_QUERIES * NN_DIM) \
        + 12.0 * NN_QUERIES * NN_K
    # the q @ c^T matmul, the corpus norms, the per-pair combine (3),
    # clamp and sqrt
    ops = (2.0 * NN_QUERIES * NN_ROWS * NN_DIM + 2.0 * NN_ROWS * NN_DIM
           + 5.0 * NN_QUERIES * NN_ROWS)
    res["device_ms"] = dev_ms
    res["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                          ops / F32_FLOPS_PER_S) * 1e3
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                       >= ops / F32_FLOPS_PER_S else "operations")
    # the host trees on a NN_TREE_ROWS subset against knn on the card
    sub = corpus[:NN_TREE_ROWS]
    sub_np = sub.cpu().numpy().astype(np.float64)
    tq = checks[:NN_TREE_QUERIES]
    ki, _ = knn(tq, sub, NN_K, device=DEV)
    ki = ki.cpu().numpy()
    t0 = time.perf_counter()
    vp = VPTree(sub_np)
    kd = KDTree(NN_DIM)
    for p in sub_np:
        kd.insert(p)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vpi = np.asarray([vp.search(q, NN_K)[0] for q in tq])
    kdi = np.asarray([kd.knn(q, NN_K)[0] for q in tq])
    search_s = time.perf_counter() - t0
    scale = norm2(np, tq) + norm2(np, sub_np).max()
    for name, ti in (("VPTree", vpi), ("KDTree", kdi)):
        if same_neighbours(np, ki, ti, exact_dists(np, tq, sub_np, ki),
                           exact_dists(np, tq, sub_np, ti), scale) is None:
            fail(f"nn: {name} on {NN_TREE_ROWS} rows differs from knn on "
                 "the card")
    res["trees"] = {"rows": NN_TREE_ROWS, "queries": NN_TREE_QUERIES,
                    "build_s": build_s, "search_s": search_s}
    return res


def dashboard_tab(torch, np, x, labels):
    """(f): embedding_scatter on DASH_ROWS rows and the page's t-SNE
    tab."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.stats import (
        InMemoryStatsStorage,
        StatsListener,
        embedding_scatter,
        render_html,
    )

    t0 = time.perf_counter()
    emb = embedding_scatter(x, labels=[int(v) for v in labels],
                            max_points=DASH_ROWS, device=DEV)
    secs = time.perf_counter() - t0
    conf = (NeuralNetConfiguration.Builder().seed(3).updater("adam")
            .learning_rate(1e-3).list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.feed_forward(TSNE_D)).build())
    net = MultiLayerNetwork(conf, device=DEV).init()
    storage = InMemoryStatsStorage()
    net.listeners.append(StatsListener(storage, frequency=1))
    y = np.eye(10, dtype=np.float32)[labels[:64]]
    for _ in range(2):
        net.fit_batch((x[:64], y))
    page = render_html(storage, embedding=emb)
    data = json.loads(page.split("const DATA = ", 1)[1].split(";\n", 1)[0])
    tab = data["embedding"]
    want = [int(v) for v in dict.fromkeys(int(v) for v in labels)]
    if not (len(tab["points"]) == DASH_ROWS
            and len(tab["labels"]) == DASH_ROWS
            and all(len(p) == 2 and all(np.isfinite(p))
                    for p in tab["points"])
            and [want[i] for i in tab["labels"]] == [int(v) for v in labels]
            and tab["kl"] is not None and np.isfinite(tab["kl"])):
        fail("dashboard: the t-SNE tab does not hold the "
             f"{DASH_ROWS} labelled points")
    return {"points": len(tab["points"]), "kl": tab["kl"], "s": secs,
            "page_bytes": len(page)}


def clustering_phase(torch, np, card):
    """Phase 5k (b)-(f): t-SNE (exact, chunked), k-means, the
    nearest-neighbour server and the dashboard's t-SNE tab (module
    docstring); the CPU checks run in a spawned process meanwhile."""
    import multiprocessing

    from deeplearning4j_tpu_torch.clustering import KMeansClustering, Tsne
    from deeplearning4j_tpu_torch.clustering import tsne as pt

    res = {"card": card}
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    x, labels = mnist_shaped(np, TSNE_N)
    res["data_s"] = time.perf_counter() - t0
    xb, lb = x[:TSNE_EXACT_N], labels[:TSNE_EXACT_N]
    with tempfile.TemporaryDirectory() as job:
        np.save(os.path.join(job, "x.npy"), x)
        xc = torch.as_tensor(x, device=DEV)
        xbc = xc[:TSNE_EXACT_N]
        b, tb, pc_rows, b_kls, b_ys = tsne_exact(torch, np, pt, Tsne, xbc,
                                                 job)
        c, tc, idx, psym, mutual, c_kls, c_ys = tsne_chunked(
            torch, np, pt, Tsne, xc, job)
        ctx = multiprocessing.get_context("spawn")
        cfg = {"exact_n": TSNE_EXACT_N, "perplexity": TSNE_PERPLEXITY,
               "exact_steps": TSNE_EXACT_CPU_STEPS,
               "chunked_steps": TSNE_CHUNKED_CPU_STEPS,
               "row_block": TSNE_ROW_BLOCK, "kmeans_k": KMEANS_K,
               "kmeans_iters": KMEANS_ITERS}
        child = ctx.Process(target=tsne_cpu_worker, args=(job, cfg),
                            daemon=True)
        child.start()
        # the card's fits while the CPU checks run
        emb_b = torch.as_tensor(tsne_fit(torch, tb, xbc, lb, b), device=DEV)
        tsne_fit(torch, tc, xc, labels, c)
        # the chunked tier on (b)'s rows; both embeddings scored by the
        # exact tier's KL (the chunked tier's own KL sums over its kNN
        # pattern only: another objective where the dense P's mass
        # spreads beyond the K nearest)
        t_sub = Tsne(perplexity=TSNE_PERPLEXITY, max_iter=TSNE_EXACT_ITERS,
                     method="chunked", row_block=TSNE_ROW_BLOCK, device=DEV)
        emb_sub = torch.as_tensor(t_sub.fit_transform(xbc), device=DEV)
        pc = pt._p_conditional(xbc, TSNE_PERPLEXITY)
        sub_idx, _ = t_sub.sparse_neighbours(xbc)
        b["p_mass_in_knn"] = float(torch.gather(pc, 1, sub_idx).sum(1).mean())
        p = torch.clamp_min((pc + pc.T) / (2.0 * TSNE_EXACT_N), 1e-12)
        del pc
        b["kl_chunked_own"] = t_sub.kl_
        b["kl_exact_objective"] = float(pt._tsne_grad(emb_b, p, 1.0)[1])
        b["kl_chunked_exact_objective"] = float(
            pt._tsne_grad(emb_sub, p, 1.0)[1])
        del p, emb_b, emb_sub
        # (d) on the card
        km = KMeansClustering(KMEANS_K, max_iterations=KMEANS_ITERS,
                              device=DEV)
        init = km._init_centers(xc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs = km.apply(xc)
        d_s = time.perf_counter() - t0
        dist = torch.cdist(xc, torch.as_tensor(cs.centers, device=DEV))
        two = torch.topk(dist, 2, dim=1, largest=False).values.cpu().numpy()
        del xc, xbc, dist
        f = dashboard_tab(torch, np, xb[:DASH_ROWS], lb[:DASH_ROWS])
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        child.join(timeout=900)
        res["cpu_wait_s"] = time.perf_counter() - t0
        if child.is_alive() or child.exitcode != 0:
            fail(f"clustering: the CPU check process ended with "
                 f"{child.exitcode}")
        with np.load(os.path.join(job, "cpu.npz")) as z:
            cpu = {k: z[k] for k in z.files}
    # (b) checks
    b["p_err"] = float(np.abs(pc_rows - cpu["b_pc_rows"]).max())
    b["step_err"] = max(tsne_step_err(np, cpu["b_y"][i], b_ys[i + 1])
                        for i in range(TSNE_EXACT_CPU_STEPS))
    b["kl_err"] = float(np.abs(np.asarray(b_kls) - cpu["b_kl"]).max()
                        / abs(cpu["b_kl"]).max())
    # (c) checks
    k = c["k"]
    ci = idx.cpu().numpy()
    rows = np.random.default_rng(3).choice(TSNE_EXACT_N, TSNE_CHECK_ROWS,
                                           replace=False)
    cpu_idx = cpu["c_knn_idx"]
    # the CPU's neighbours of each sampled row, itself dropped (no
    # duplicate rows: the self entry is the nearest)
    cpu_nb = np.asarray([[j for j in r if j != i][:k]
                         for i, r in zip(rows, cpu_idx)])
    c["knn_tie_swaps"] = same_neighbours(
        np, ci[rows], cpu_nb, exact_dists(np, x[rows], x, ci[rows]),
        exact_dists(np, x[rows], x, cpu_nb),
        norm2(np, x[rows]) + norm2(np, x).max())
    n = TSNE_N
    c["p_err"] = float(np.abs(psym.cpu().numpy() - cpu["c_psym"]).max()
                       * 2.0 * n)
    c["mutual_same"] = bool((mutual.cpu().numpy() == cpu["c_mutual"]).all())
    c["step_err"] = max(tsne_step_err(np, cpu["c_y"][i][:n],
                                      c_ys[i + 1][:n])
                        for i in range(TSNE_CHUNKED_CPU_STEPS))
    c["kl_err"] = float(np.abs(np.asarray(c_kls) - cpu["c_kl"]).max()
                        / abs(cpu["c_kl"]).max())
    for name, r in (("exact", b), ("chunked", c)):
        bad = []
        if not (r["p_err"] <= TSNE_P_TOL and r["step_err"] <= TSNE_STEP_TOL
                and r["kl_err"] <= 1e-5):
            bad.append("card against the CPU")
        if not (np.isfinite(r["kl_final"]) and r["kl_final"] < r["kl_100"]):
            bad.append("KL not finite and below iteration 100's")
        if not r["label_share"] >= TSNE_LABEL_SHARE:
            bad.append("label share")
        if name == "exact" and not r["loop_err"] <= TSNE_STEP_TOL:
            bad.append("the loop is not fit_transform's")
        if name == "chunked" and not (r["knn_tie_swaps"] is not None
                                      and r["mutual_same"]):
            bad.append("kNN or the mutual pattern")
        if bad:
            fail(f"tsne {name}: {', '.join(bad)}: {r}")
    ke, kc = b["kl_exact_objective"], b["kl_chunked_exact_objective"]
    if not abs(kc - ke) < TSNE_KL_REL * ke + TSNE_KL_ABS:
        fail(f"tsne: scored by the exact KL, the chunked tier's embedding "
             f"of (b)'s rows reads {kc} against the exact tier's {ke}")
    for name, r in (("exact", b), ("chunked", c)):
        log(f"tsne {name}: {r['n']} x {TSNE_D} MNIST-shaped rows, "
            f"perplexity {TSNE_PERPLEXITY:g}, {r['iters']} iterations: "
            f"{r['s_per_iter'] * 1e3:.3f} ms per iteration (bound "
            f"{r['bound_ms']:.3f} ms, {r['bound_by']}; "
            f"{r['s_per_iter'] * 1e3 / r['bound_ms']:.1f}x), affinities "
            f"{r['p_s']:.2f} s"
            + (f" (of them the kNN {r['knn_s']:.2f} s, bound "
               f"{r['knn_bound_ms']:.1f} ms)" if "knn_s" in r else "")
            + f", whole fit {r['fit_s']:.2f} s, peak {r['peak_gb']:.2f} GB; "
            f"KL {r['kl_first']:.4f} first, {r['kl_100']:.4f} at iteration "
            f"100, {r['kl_final']:.4f} final; 10-NN label share in 2-D "
            f"{r['label_share']:.4f}; against the port on the CPU from the "
            f"card's states: P {r['p_err']:.2e}, y {r['step_err']:.2e} "
            f"(first {TSNE_EXACT_CPU_STEPS if name == 'exact' else TSNE_CHUNKED_CPU_STEPS}"
            f" iterations), KL {r['kl_err']:.2e} [{card}]")
    log(f"tsne: the chunked tier on the exact tier's {TSNE_EXACT_N} rows, "
        f"scored by the exact KL: {kc:.4f} against the exact tier's "
        f"{ke:.4f} (limit {TSNE_KL_REL} x + {TSNE_KL_ABS}); its own KL over "
        f"its kNN pattern {b['kl_chunked_own']:.4f} (the dense P keeps "
        f"{b['p_mass_in_knn']:.4f} of each row's mass inside the "
        f"{int(3 * TSNE_PERPLEXITY)} nearest)")
    # (d) checks
    same_init = np.array_equal(init, cpu["d_init"])
    differ = np.nonzero(cs.assignments != cpu["d_assign"])[0]
    near_tie = (two[:, 1] - two[:, 0]) <= KMEANS_GAP_TOL * two[:, 1]
    cerr = float(np.abs(cs.centers - cpu["d_centers"]).max()
                 / np.abs(cpu["d_centers"]).max())
    ierr = abs(cs.inertia - float(cpu["d_inertia"])) / float(
        cpu["d_inertia"])
    res["kmeans"] = {"n": TSNE_N, "k": KMEANS_K, "s": d_s,
                     "init_equal": bool(same_init),
                     "assign_differ": int(len(differ)),
                     "centers_err": cerr, "inertia": cs.inertia,
                     "inertia_err": ierr}
    if not (same_init and near_tie[differ].all() and cerr <= KMEANS_TOL
            and ierr <= KMEANS_TOL):
        fail(f"kmeans: the card against the CPU: {res['kmeans']}")
    log(f"kmeans: k={KMEANS_K} on the {TSNE_N} x {TSNE_D} rows, "
        f"{d_s:.3f} s on the card; k-means++ centres equal the CPU's "
        f"exactly, {len(differ)} assignments differ (near ties only), "
        f"centres within {cerr:.1e}, inertia {cs.inertia:.2f} within "
        f"{ierr:.1e} [{card}]")
    res["exact"], res["chunked"] = b, c
    res["dashboard"] = f
    log(f"dashboard: embedding_scatter on {DASH_ROWS} of the exact tier's "
        f"rows {f['s']:.2f} s, KL {f['kl']}; render_html's t-SNE tab holds "
        f"{f['points']} labelled points ({f['page_bytes']} bytes)")
    # (e) last: its clients share the host with nothing else
    e = res["nn"] = nn_serving(torch, np, card)
    lo = e["load"]
    log(f"nn: NearestNeighborsServer over {NN_ROWS} x {NN_DIM} f32 on the "
        f"card, {NN_CLIENTS} client threads, {NN_QUERIES} queries of k="
        f"{NN_K} per request for {NN_WINDOW_S:g} s: {lo['requests']} "
        f"requests, {lo['req_per_s']:.1f} req/s ({lo['queries_per_s']:.0f} "
        f"queries/s), p50 {lo['p50_ms']:.2f} ms, p99 {lo['p99_ms']:.2f} ms; "
        f"the device's knn of one request {e['device_ms']:.3f} ms (bound "
        f"{e['bound_ms']:.3f} ms, {e['bound_by']}; one read of the corpus "
        f"{e['bytes_ms']:.3f} ms); {e['check']['queries']} queries equal "
        f"the f64 brute force ({e['check']['tie_swaps']} tie swaps); "
        f"VPTree and KDTree on {e['trees']['rows']} rows equal knn "
        f"(build {e['trees']['build_s']:.2f} s, {e['trees']['queries']} "
        f"searches {e['trees']['search_s']:.2f} s) [{card}]")
    return res


# ------------------------------------------------------------ phase 5l


def zipf_corpus(np, vocab, n_words, seq, seed):
    """bench.py:468's corpus: n_words draws of a zipf-1.1 vocabulary
    ("w0" the most frequent) from default_rng(seed), in sequences of
    `seq` tokens."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    words = np.array([f"w{i}" for i in range(vocab)])
    corpus = rng.choice(vocab, size=n_words, p=p)
    return [words[corpus[i:i + seq]].tolist()
            for i in range(0, n_words, seq)]


def topic_sentences(np, n, seed=5):
    """tests/test_nlp.py:23 _corpus: sentences of 8 words drawn from one
    of two six-word topics."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tech = ["cpu", "gpu", "ram", "disk", "cache", "bus"]
    sents = []
    for _ in range(n):
        words = rng.choice(animals if rng.random() < 0.5 else tech,
                           size=8, replace=True)
        sents.append(" ".join(words))
    return sents, animals, tech


def nlp_table_err(np, want, got):
    if want is None or got is None:
        return 0.0 if want is None and got is None else float("inf")
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def nlp_tables(np, sv):
    return [None if t is None else np.array(t)
            for t in (sv.syn0, sv.syn1, sv.syn1neg)]


def nlp_host_side(sv, seqs):
    """A fit of `sv` with the device work cut out: the host side alone
    (indexing, subsampling, the native packer on its thread, the slab
    buffer) -> (seconds, the packer's seconds, [(rows, lrs)] of every
    slab)."""
    got, pack_s = [], []
    pack = sv._epoch_pack_chunk

    def keep(tables, rows, lrs, W, hs_tabs):
        got.append((rows, lrs))
        return tables

    def timed_pack(*a):
        t0 = time.perf_counter()
        out = pack(*a)
        pack_s.append(time.perf_counter() - t0)
        return out

    sv._dispatch_slab, sv._epoch_pack_chunk = keep, timed_pack
    try:
        t0 = time.perf_counter()
        sv.fit(seqs)
        return time.perf_counter() - t0, sum(pack_s), got
    finally:
        del sv._dispatch_slab, sv._epoch_pack_chunk


def nlp_rows_per_example(np, sv, rows, lrs):
    """Table rows one example gathers (and scatters back) in this slab's
    real batches: skip-gram NS K + 2; HS 1 + the target's code length;
    CBOW its valid context words + K + 1 or + the centre's code length."""
    W = 2 * sv.window
    Bp = rows.shape[0] // lrs.size
    real = rows[:int((lrs > 0).sum()) * Bp].astype(np.int64)
    code_len = np.array([len(w.codes) for w in sv.vocab.vocab_words()])
    if sv.use_cbow:
        n = (real[:, :W] >= 0).sum(axis=1)
        n = n + (code_len[real[:, W]] if sv.use_hs else sv.negative + 1)
    else:
        n = (1 + code_len[real[:, 1]] if sv.use_hs
             else np.full(len(real), sv.negative + 2))
    return float(n.mean())


def nlp_device_side(torch, np, sv, slabs):
    """The captured slabs dispatched back to back on copies of the fitted
    tables (upload, launches and the device's work; no packing): seconds
    between CUDA events, then the first slab alone unprofiled and under
    the profiler (busy ms per batch, the idle share)."""
    dev = sv._syn0_dev.device
    hs = sv._hs_tabs_on(dev) if sv.use_hs else None
    W = 2 * sv.window

    def copies():
        return tuple(None if t is None else t.clone() for t in
                     (sv._syn0_dev, sv._syn1_dev, sv._syn1neg_dev))

    def run(tables, part):
        for rows, lrs in part:
            sv._dispatch_slab(tables, rows, lrs, W, hs)

    batches = sum(int((lrs > 0).sum()) for _, lrs in slabs)
    tables = copies()
    run(tables, slabs[:1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run(tables, slabs)
    end.record()
    end.synchronize()
    all_s = start.elapsed_time(end) / 1e3
    host_s = time.perf_counter() - t0
    first = int((slabs[0][1] > 0).sum())
    torch.cuda.synchronize()
    start.record()
    run(tables, slabs[:1])
    end.record()
    end.synchronize()
    slab_ms = start.elapsed_time(end)
    prof = decode_profile(torch, lambda: run(tables, slabs[:1]))
    top = engine_profile(torch, lambda: run(tables, slabs[:1]), first)
    busy = prof["busy_ms"]
    del tables
    return {"s": all_s, "host_clock_s": host_s, "batches": batches,
            "ms_per_batch": all_s * 1e3 / batches,
            "slab_ms_per_batch": slab_ms / first,
            "busy_ms_per_batch": None if busy is None else busy / first,
            "idle_share": None if busy is None else 1.0 - busy / slab_ms,
            "kernels_per_batch": prof["kernels"] / first,
            "top": top["top"][:4]}


def nlp_split(torch, np, sv, seqs, epochs):
    """The host side and the device side of one epoch of `sv`, each
    alone, and one example's bound (gathered + scattered rows at 3.35
    TB/s)."""
    t0 = time.perf_counter()
    sv._index_corpus(seqs)
    index_s = time.perf_counter() - t0
    sv.epochs = 1
    host_s, pack_s, slabs = nlp_host_side(sv, seqs)
    sv.epochs = epochs
    devs = nlp_device_side(torch, np, sv, slabs)
    rows = nlp_rows_per_example(np, sv, *slabs[0])
    B = sv.dense_batch_size
    bound = rows * B * sv.layer_size * 4 * 2 / HBM_BYTES_PER_S * 1e3
    return {"index_s": index_s, "host_epoch_s": host_s - index_s,
            "native_pack_s": pack_s,
            "device": devs, "rows_per_example": rows,
            "bound_ms_per_batch": bound,
            "wire": str(slabs[0][0].dtype), "slabs": len(slabs)}


def nlp_finite_checks(np, sv, label):
    for name, t in zip(("syn0", "syn1", "syn1neg"), nlp_tables(np, sv)):
        if t is not None and not np.isfinite(t).all():
            fail(f"nlp {label}: non-finite {name}")
    sim = sv.similarity("w0", "w1")
    if not np.isfinite(sim):
        fail(f"nlp {label}: similarity('w0', 'w1') = {sim}")
    return sim


def nlp_split_line(r):
    d = r["device"]
    busy = ("not measured" if d["busy_ms_per_batch"] is None
            else f"{d['busy_ms_per_batch']:.3f} ms")
    idle = ("not measured" if d["idle_share"] is None
            else f"{d['idle_share']:.3f}")
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in d["top"])
    return (f"per epoch the host side alone {r['host_epoch_s']:.3f} s "
            f"(the native packer's calls {r['native_pack_s']:.3f} s of it; "
            f"+ {r['index_s']:.3f} s indexing per fit), the device side "
            f"alone {d['s']:.3f} s ({d['batches']} batches, "
            f"{d['ms_per_batch']:.3f} ms per batch; one slab "
            f"{d['slab_ms_per_batch']:.3f} ms per batch, busy {busy}, idle "
            f"share {idle}, {d['kernels_per_batch']:.1f} kernels per batch; "
            f"bound {r['bound_ms_per_batch']:.4f} ms: "
            f"{r['rows_per_example']:.2f} rows of the table gathered and "
            f"scattered per example); wire {r['wire']}; top kernels per "
            f"batch: {top}")


def w2v_bench(torch, np, card):
    """(a) bench.py:468 bench_word2vec on the card."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    r = {"card": card}
    t0 = time.perf_counter()
    seqs = zipf_corpus(np, NLP_VOCAB, NLP_WORDS, NLP_SEQ, 0)
    r["corpus_s"] = time.perf_counter() - t0
    sv = SequenceVectors(layer_size=NLP_DIM, window=NLP_WINDOW,
                         negative=NLP_NEG, epochs=1, seed=1, mode="dense",
                         device=DEV)
    t0 = time.perf_counter()
    sv.build_vocab(seqs)
    r["build_vocab_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sv.fit(seqs)
    float(sv._syn0_dev[0, 0])
    r["warm_s"] = time.perf_counter() - t0
    _ = sv.syn0, sv.syn1neg
    sv.epochs = NLP_EPOCHS
    torch.cuda.reset_peak_memory_stats()
    r["reps_s"] = []
    for _ in range(NLP_REPS):
        t0 = time.perf_counter()
        sv.fit(seqs)
        float(sv._syn0_dev[0, 0])   # the barrier: a host read
        r["reps_s"].append(time.perf_counter() - t0)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    best = min(r["reps_s"])
    r["words_per_s"] = NLP_WORDS * NLP_EPOCHS / best
    r["epoch_s"] = best / NLP_EPOCHS
    r["split"] = nlp_split(torch, np, sv, seqs, NLP_EPOCHS)
    r["similarity_w0_w1"] = nlp_finite_checks(np, sv, "(a)")
    log(f"nlp (a) word2vec at bench.py:468 (vocab {sv.vocab.num_words()}, "
        f"{NLP_WORDS} zipf-1.1 words in sequences of {NLP_SEQ}, dim "
        f"{NLP_DIM}, window {NLP_WINDOW}, K={NLP_NEG}, skip-gram NS, dense, "
        f"batch {sv.dense_batch_size}): build_vocab "
        f"{r['build_vocab_s']:.2f} s, warm epoch {r['warm_s']:.2f} s; "
        f"{NLP_EPOCHS} epochs {', '.join(f'{x:.3f}' for x in r['reps_s'])}"
        f" s: {r['words_per_s']:.0f} words/s, {r['epoch_s']:.3f} s per "
        f"epoch; peak {r['peak_gb']:.2f} GB; similarity(w0, w1) "
        f"{r['similarity_w0_w1']:.4f} [{card}]")
    log(f"nlp (a) split: {nlp_split_line(r['split'])} [{card}]")
    return r, seqs


def w2v_wide(torch, np, card):
    """(b) CBOW + HS at width 300 over a 50,000-word vocab."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    r = {"card": card}
    seqs = zipf_corpus(np, NLP_WIDE_VOCAB, NLP_WIDE_WORDS, NLP_SEQ, 1)
    sv = SequenceVectors(layer_size=NLP_WIDE_DIM, window=NLP_WINDOW,
                         negative=0, use_hierarchic_softmax=True,
                         use_cbow=True, epochs=1, seed=1, mode="dense",
                         device=DEV)
    t0 = time.perf_counter()
    sv.build_vocab(seqs)
    r["build_vocab_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sv.fit(seqs)
    float(sv._syn0_dev[0, 0])
    r["fit_s"] = time.perf_counter() - t0
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["words_per_s"] = NLP_WIDE_WORDS / r["fit_s"]
    r["split"] = nlp_split(torch, np, sv, seqs, 1)
    if r["split"]["wire"] != "int32":
        fail(f"nlp (b): {sv.vocab.num_words()} words shipped on the "
             f"{r['split']['wire']} wire")
    r["similarity_w0_w1"] = nlp_finite_checks(np, sv, "(b)")
    r["vocab"] = sv.vocab.num_words()
    r["max_code_len"] = sv._max_code_len
    log(f"nlp (b) CBOW + HS, vocab {r['vocab']} (max code length "
        f"{r['max_code_len']}), dim {NLP_WIDE_DIM}, {NLP_WIDE_WORDS} words, "
        f"1 epoch: build_vocab {r['build_vocab_s']:.2f} s, fit "
        f"{r['fit_s']:.3f} s, {r['words_per_s']:.0f} words/s; peak "
        f"{r['peak_gb']:.2f} GB; similarity(w0, w1) "
        f"{r['similarity_w0_w1']:.4f} [{card}]")
    log(f"nlp (b) split: {nlp_split_line(r['split'])} [{card}]")
    return r


def nlp_recorder(np, sv):
    """Digests of every batch the fit feeds its device steps: the dense
    tier's slabs, the scan tier's step inputs (copied to the host)."""
    import hashlib

    digests = []

    def digest(*arrays):
        h = hashlib.sha1()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        digests.append(h.hexdigest())

    if sv._dense:
        orig = sv._dispatch_slab

        def slab(tables, rows, lrs, W, hs_tabs):
            digest(rows, lrs)
            return orig(tables, rows, lrs, W, hs_tabs)

        sv._dispatch_slab = slab
    else:
        for name in ("_neg_step", "_hs_step", "_cbow_neg_step",
                     "_cbow_hs_step"):
            step = getattr(sv, name)

            def rec(*a, _step=step):
                digest(*(x.cpu().numpy() for x in a[2:-1]))
                return _step(*a)

            setattr(sv, name, rec)
    return digests


NLP_CHECK_MODES = (
    ("dense sg-ns", dict(mode="dense", negative=NLP_NEG)),
    ("dense sg-hs", dict(mode="dense", negative=0)),
    ("dense cbow-ns", dict(mode="dense", negative=NLP_NEG, use_cbow=True)),
    ("dense cbow-hs", dict(mode="dense", negative=0, use_cbow=True)),
    ("scan sg-ns", dict(mode="scan", negative=NLP_NEG)))


def nlp_versus_cpu(torch, np, card, seqs):
    """(c) the same fits on the card (twice) and on the CPU."""
    from deeplearning4j_tpu_torch.nlp import Glove, ParagraphVectors
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        LabelledDocument,
    )
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    cut = seqs[:NLP_CUT_WORDS // NLP_SEQ]
    res, bad = {}, []

    def held(label, make, fit, tables, packs=None, twice=False):
        out, secs = [], []
        for dev in (DEV, DEV, "cpu")[0 if twice else 1:]:
            m = make(dev)
            digests = packs(m) if packs else None
            t0 = time.perf_counter()
            fit(m)
            secs.append(time.perf_counter() - t0)
            out.append((tables(m), digests))
        (c1, p1), (cpu, pc_) = out[0], out[-1]
        err = max(nlp_table_err(np, w, g) for w, g in zip(cpu, c1))
        same_bits = None
        if twice:   # the card sums scatters with float atomics
            same_bits = all((a is None and b is None)
                            or np.array_equal(a, b)
                            for a, b in zip(c1, out[1][0]))
        r = {"err": err, "card_runs_bitwise_equal": same_bits,
             "card_s": secs[0], "cpu_s": secs[-1]}
        if packs:
            r["batches"] = len(p1)
            r["packs_equal"] = (p1 == pc_ and len(p1) > 0
                                and (not twice or out[1][1] == p1))
            if not r["packs_equal"]:
                bad.append(f"{label}: packs differ")
        if not err <= NLP_TABLE_TOL:
            bad.append(f"{label}: tables {err:.3e} > {NLP_TABLE_TOL}")
        res[label] = r
        log(f"nlp (c) {label}: card against CPU {err:.3e} (bar "
            f"{NLP_TABLE_TOL:g})"
            + (f"; two card runs bitwise equal: {same_bits}" if twice
               else "")
            + (f"; packs of {r['batches']} slabs or batches equal: "
               f"{r['packs_equal']}" if packs else "")
            + f"; card {secs[0]:.2f} s, CPU {secs[-1]:.2f} s [{card}]")

    for label, kw in NLP_CHECK_MODES:
        def make(dev, kw=kw):
            sv = SequenceVectors(layer_size=NLP_DIM, window=NLP_WINDOW,
                                 epochs=1, seed=1, device=dev, **kw)
            sv.build_vocab(cut)
            sv._ensure_steps()
            return sv

        def packs(sv):
            return nlp_recorder(np, sv)

        held(label, make, lambda m: m.fit(cut),
             lambda m: nlp_tables(np, m), packs,
             twice=label.startswith("dense"))
    held("glove",
         lambda dev: Glove(layer_size=NLP_DIM, window=NLP_WINDOW, epochs=1,
                           seed=1, device=dev),
         lambda m: m.fit(cut), lambda m: [m.syn0])
    docs = [LabelledDocument(" ".join(s), [f"DOC_{i}"])
            for i, s in enumerate(cut[:NLP_PV_CUT_DOCS])]
    text = " ".join(cut[0])
    for algo in ("dbow", "dm"):
        held(f"paragraph vectors {algo} + infer_vector",
             lambda dev, algo=algo: (
                 ParagraphVectors.Builder().layer_size(NLP_DIM)
                 .window_size(NLP_WINDOW).negative_sample(NLP_NEG).epochs(1)
                 .seed(1).sequence_learning_algorithm(algo).device(dev)
                 .build()),
             lambda m: m.fit(docs),
             lambda m: [m.syn0, m.syn1neg, m.doc_vectors,
                        m.infer_vector(text)])
    if bad:
        fail(f"nlp (c): {bad}")
    return res


def nlp_quality(torch, np, card):
    """(d) the two-topic corpus: Word2Vec's dense tier in all four modes,
    ParagraphVectors (DBOW) on its documents."""
    from deeplearning4j_tpu_torch.nlp import (
        CollectionSentenceIterator,
        ParagraphVectors,
        Word2Vec,
    )
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        LabelledDocument,
    )

    sents, animals, tech = topic_sentences(np, NLP_TOPIC_SENTS)
    res, bad = {}, []
    for mode in ("negative", "hs", "cbow-negative", "cbow-hs"):
        t0 = time.perf_counter()
        w2v = (Word2Vec.Builder().layer_size(24).window_size(4)
               .negative_sample(5 if mode.endswith("negative") else 0)
               .use_hierarchic_softmax(mode.endswith("hs"))
               .elements_learning_algorithm(
                   "CBOW" if mode.startswith("cbow") else "SkipGram")
               .min_word_frequency(1).epochs(1).seed(1).mode("dense")
               .device(DEV).iterate(CollectionSentenceIterator(sents))
               .build())
        w2v.dense_batch_size = NLP_TOPIC_BATCH
        w2v.fit()
        s = time.perf_counter() - t0
        intra = float(np.mean(
            [w2v.similarity(a, b) for g in (animals, tech) for a in g
             for b in g if a < b]))
        inter = float(np.mean([w2v.similarity(a, b) for a in animals
                               for b in tech]))
        res[mode] = {"intra": intra, "inter": inter, "s": s}
        if not intra > inter + NLP_TOPIC_GAP:
            bad.append(f"{mode}: intra {intra:.3f} inter {inter:.3f}")
        log(f"nlp (d) two topics, {NLP_TOPIC_SENTS} sentences, dense "
            f"{mode} (batch {NLP_TOPIC_BATCH}, 1 epoch): intra-topic "
            f"similarity {intra:.4f}, inter-topic {inter:.4f} (bar: "
            f"+{NLP_TOPIC_GAP}); {s:.2f} s [{card}]")
    docs = [LabelledDocument(s, [f"DOC_{i}"])
            for i, s in enumerate(sents[:NLP_PV_DOCS])]
    t0 = time.perf_counter()
    pv = (ParagraphVectors.Builder().layer_size(16).negative_sample(5)
          .epochs(NLP_PV_EPOCHS).seed(3).device(DEV).iterate(docs).build())
    pv.fit()
    s = time.perf_counter() - t0
    topic = np.array([d.content.split()[0] in animals for d in docs])
    x = torch.as_tensor(np.array(pv.doc_vectors), device=DEV)
    x = x / x.norm(dim=1, keepdim=True)
    sims = (x @ x.T).cpu().numpy().astype(np.float64)
    same = topic[:, None] == topic[None]
    off = ~np.eye(len(docs), dtype=bool)
    intra, inter = sims[same & off].mean(), sims[~same].mean()
    np.fill_diagonal(sims, -np.inf)
    nn_share = float((topic[sims.argmax(axis=1)] == topic).mean())
    res["paragraph_vectors"] = {"intra": intra, "inter": inter,
                                "nn_share": nn_share, "s": s}
    if not (intra > inter + NLP_TOPIC_GAP and nn_share >= NLP_PV_NN_SHARE):
        bad.append(f"paragraph vectors: {res['paragraph_vectors']}")
    log(f"nlp (d) ParagraphVectors DBOW on {NLP_PV_DOCS} documents, "
        f"{NLP_PV_EPOCHS} epochs: intra-topic {intra:.4f}, inter-topic "
        f"{inter:.4f}, nearest document in the same topic {nn_share:.3f} "
        f"(bars +{NLP_TOPIC_GAP}, {NLP_PV_NN_SHARE}); {s:.2f} s [{card}]")
    if bad:
        fail(f"nlp (d): {bad}")
    return res


def blog_graph(np, Graph, seed=0):
    """A planted partition at BlogCatalog's scale: BLOG_VERTICES vertices
    in BLOG_BLOCKS blocks (uniform), BLOG_EDGES undirected edges, a share
    BLOG_INSIDE of them inside a block (a block drawn in proportion to
    its size, two distinct members), the rest across blocks."""
    rng = np.random.default_rng(seed)
    n, m = BLOG_VERTICES, BLOG_EDGES
    block = rng.integers(0, BLOG_BLOCKS, n)
    order = np.argsort(block, kind="stable")
    size = np.bincount(block, minlength=BLOG_BLOCKS)
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    n_in = int(round(BLOG_INSIDE * m))
    bl = block[rng.integers(0, n, n_in)]
    o1 = (rng.random(n_in) * size[bl]).astype(np.int64)
    o2 = (o1 + 1 + (rng.random(n_in) * (size[bl] - 1)).astype(np.int64)
          ) % size[bl]
    a = rng.integers(0, n, 2 * (m - n_in))
    b = rng.integers(0, n, 2 * (m - n_in))
    keep = np.nonzero(block[a] != block[b])[0][:m - n_in]
    ea = np.concatenate([order[start[bl] + o1], a[keep]])
    eb = np.concatenate([order[start[bl] + o2], b[keep]])
    g = Graph(n)
    for u, v in zip(ea.tolist(), eb.tolist()):
        g.add_edge(u, v)
    return g, block, float((block[ea] == block[eb]).mean())


def block_share(torch, np, dw, block, k=10):
    """The share of each vertex's k nearest (cosine) in its own block."""
    sv = dw._sv
    ids = np.array([int(w) for w in sv.vocab.words()])
    x = torch.as_tensor(np.array(sv.syn0), device=DEV)
    x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    sims = x @ x.T
    sims.fill_diagonal_(-2.0)
    nn = sims.topk(k, dim=1).indices.cpu().numpy()
    blk = block[ids]
    return float((blk[nn] == blk[:, None]).mean())


def graph_embed(torch, np, card):
    """(e) DeepWalk and Node2Vec at BlogCatalog's scale."""
    from deeplearning4j_tpu_torch.graph import (
        DeepWalk,
        Graph,
        Node2Vec,
        Node2VecWalkIterator,
        RandomWalkIterator,
    )

    r = {"card": card}
    t0 = time.perf_counter()
    g, block, inside = blog_graph(np, Graph)
    r["graph_s"] = time.perf_counter() - t0
    dw = DeepWalk(vector_size=BLOG_DIM, window_size=BLOG_WINDOW, seed=0,
                  device=DEV).initialize(g)
    t0 = time.perf_counter()
    walks = list(RandomWalkIterator(g, BLOG_WALK, BLOG_WALKS, seed=0))
    r["walk_s"] = time.perf_counter() - t0
    tokens = sum(len(w) for w in walks)
    t0 = time.perf_counter()
    dw.fit(walks)
    float(dw._sv._syn0_dev[0, 0])
    r["fit_s"] = time.perf_counter() - t0
    r["words_per_s"] = tokens / r["fit_s"]
    if not (dw._sv._dense and dw._sv.use_hs and dw._sv.negative == 0):
        fail("nlp (e): DeepWalk did not take the dense HS tier")
    r["share"] = block_share(torch, np, dw, block)
    r["chance"] = 1.0 / BLOG_BLOCKS
    log(f"nlp (e) DeepWalk on a planted partition at BlogCatalog's scale "
        f"({BLOG_VERTICES} vertices, {BLOG_EDGES} edges, {BLOG_BLOCKS} "
        f"blocks, {inside:.3f} of edges inside a block; built in "
        f"{r['graph_s']:.2f} s), d={BLOG_DIM}, window {BLOG_WINDOW}, walk "
        f"length {BLOG_WALK}, {BLOG_WALKS} walks per vertex (the paper's 80, "
        f"cut: a Python loop on the host): walks {r['walk_s']:.2f} s, fit "
        f"(dense HS skip-gram) {r['fit_s']:.2f} s, {r['words_per_s']:.0f} "
        f"words/s over {tokens} tokens; share of each vertex's 10 nearest "
        f"in its block {r['share']:.4f} (chance {r['chance']:.4f}, bar "
        f"{BLOG_SHARE_MIN}) [{card}]")
    if not r["share"] >= BLOG_SHARE_MIN:
        fail(f"nlp (e): block share {r['share']:.4f} < {BLOG_SHARE_MIN}")
    nv = Node2Vec(p=1.0, q=0.5, vector_size=BLOG_DIM,
                  window_size=BLOG_WINDOW, seed=0, device=DEV).initialize(g)
    t0 = time.perf_counter()
    walks = list(Node2VecWalkIterator(g, BLOG_N2V_WALK, 1, p=1.0, q=0.5,
                                      seed=0))
    r["n2v_walk_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nv.fit(walks)
    float(nv._sv._syn0_dev[0, 0])
    r["n2v_fit_s"] = time.perf_counter() - t0
    if not np.isfinite(nv._sv.syn0).all():
        fail("nlp (e): Node2Vec embeddings not finite")
    r["n2v_share"] = block_share(torch, np, nv, block)
    log(f"nlp (e) Node2Vec (p=1, q=0.5), 1 walk per vertex of length "
        f"{BLOG_N2V_WALK} (cut from {BLOG_WALK}: its per-edge bias loop "
        f"runs on the host): walks {r['n2v_walk_s']:.2f} s, fit "
        f"{r['n2v_fit_s']:.2f} s; finite; block share "
        f"{r['n2v_share']:.4f} [{card}]")
    return r


def nlp_phase(torch, np, pc, card):
    """Phase 5l: the embedding trainers and graph embeddings (lines start
    "nlp "). The kernel launch counters are set to 0 before it and read
    after it: no kernel of csrc/ is on this path."""
    from deeplearning4j_tpu_torch import native

    pc.reset_launch_counts()
    if not native.available():
        fail("nlp: the native host library (the word2vec packers) did not "
             "build; the NumPy fallback is not the measured path")
    res, secs = {"card": card}, {}
    t0 = time.perf_counter()
    res["bench"], seqs = w2v_bench(torch, np, card)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["wide"] = w2v_wide(torch, np, card)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["versus_cpu"] = nlp_versus_cpu(torch, np, card, seqs)
    secs["c"] = time.perf_counter() - t0
    del seqs
    t0 = time.perf_counter()
    res["quality"] = nlp_quality(torch, np, card)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["graph"] = graph_embed(torch, np, card)
    secs["e"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    counts = pc.launch_counts()
    res["launches"] = {k: counts[k] for k in pc.LAUNCHES}
    res["seconds"] = secs
    log(f"nlp phase: kernel launches on the embedding path "
        f"{res['launches']}; seconds per part "
        + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    if any(res["launches"].values()):
        fail(f"nlp: a csrc/ kernel launched on the embedding path: "
             f"{res['launches']}")
    return res


# ------------------------------------------------------------ phase 6


def free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def scaleout_fit(torch, pc, tm, batch_fn, start, steps):
    """`tm.fit` from `start` for `steps` steps, timed by the host clock
    up to a CUDA sync, with the kernel launch counters zeroed before it:
    (ms per step, launches)."""
    torch.cuda.synchronize()
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    tm.fit(batch_fn, start + steps, start_step=start)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = pc.launch_counts()
    return ms, {n: counts[n] for n in pc.LAUNCHES}


def nccl_kernels(torch, fn):
    """torch.profiler over `fn()`: the NCCL kernels the device ran
    ({name: count}), and the device ms they took."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    out, ms = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "nccl" in e.key.lower():
            out[e.key[:60]] = e.count
            ms += dev(e) / 1e3
    return out, ms


def shard_projection(leaves_, dp):
    """The updater state's bytes under the ZeRO-1 policy at `dp`: (sharded
    bytes, replica bytes, full bytes) and the sharded leaves' shapes by
    kind — what a gang of `dp` ranks would hold per rank."""
    from deeplearning4j_tpu_torch.engine.sharding import zero1_leaf_sharded

    full = sharded = 0
    kinds = {}
    for t in leaves_:
        b = t.numel() * t.element_size()
        full += b
        on = zero1_leaf_sharded(tuple(t.shape), dp)
        kind = "conv kernels" if t.ndim == 4 else (
            "matrices" if t.ndim == 2 else "vectors")
        k = kinds.setdefault(kind, {"leaves": 0, "sharded": 0})
        k["leaves"] += 1
        k["sharded"] += int(on)
        if on:
            sharded += b
    return {"dp": dp, "full_bytes": full,
            "replica_bytes": full - sharded + sharded // dp,
            "replica_fraction": (full - sharded + sharded // dp) / full,
            "by_kind": kinds}


def scaleout_zero1(torch, np, pc, ResNet50, card, tmp):
    """Phase 5m (a): unsharded run_group(GROUP_K) against ZeRO-1 on the
    flagship at world 1 over NCCL (module docstring)."""
    from deeplearning4j_tpu_torch.parallel import TrainingMaster, collectives

    res = {}
    _, batch_fn = tm_data(np, 70, TRAIN_BATCH)
    k, n = GROUP_K, SCALEOUT_STEPS
    ref = flagship(ResNet50, "pallas")
    tm_ref = TrainingMaster(ref, steps_per_dispatch=k)
    tm_ref.fit(batch_fn, k)
    bare_ms, _ = scaleout_fit(torch, pc, tm_ref, batch_fn, k, n)
    net = flagship(ResNet50, "pallas")
    tm = TrainingMaster(net, sharding="zero1", steps_per_dispatch=k,
                        checkpoint_dir=os.path.join(tmp, "zero1"))
    prog = tm._harness.program
    tm.fit(batch_fn, k)
    z_ms, launches = scaleout_fit(torch, pc, tm, batch_fn, k, n)
    res["launches"] = launches
    res["params"] = ref.num_params()
    at = k + n
    same, count, diff = same_bits(torch, ref, net)
    coll = {str(key[1]): c for key, c in prog.group_collectives().items()}
    res["bitwise"] = {"tensors": count, "differ": diff}
    res["ms_per_step"] = {"zero1": z_ms, "run_group": bare_ms}
    res["collectives_per_replay"] = coll
    log(f"scaleout (a) zero1 vs unsharded run_group({k}) after {at} steps: "
        f"{count} tensors, {diff} differ; ms/step zero1 {z_ms:.3f} against "
        f"run_group({k}) {bare_ms:.3f} ({z_ms / bare_ms:.3f}x; host clock "
        f"over {n} steps, the input pipeline on); collectives per replay "
        f"{coll}; kernel launches {launches} [{card}]")
    if not same:
        fail("scaleout (a): ZeRO-1 differs from the unsharded run_group")
    for name, c in launches.items():
        if c <= 0:
            fail(f"scaleout (a): {name} was not launched by the zero1 fit")
    if not coll or not all(c.get("all_reduce", 0) >= k
                           for c in coll.values()):
        fail(f"scaleout (a): the captured zero1 group holds no NCCL "
             f"collective per step: {coll}")
    kernels, nccl_ms = nccl_kernels(
        torch, lambda: tm.fit(batch_fn, at + k, start_step=at))
    tm_ref.fit(batch_fn, at + k, start_step=at)
    at += k
    res["profiled_replay"] = {"nccl_kernels": kernels, "nccl_ms": nccl_ms}
    log(f"scaleout (a) one profiled replay ({k} steps): NCCL kernels "
        f"{kernels}, {nccl_ms:.3f} ms device (a world-1 NCCL all-reduce "
        f"may run as a device copy, with no NCCL kernel) [{card}]")
    # the policy at world 1 and what it would shard in a gang
    mgr = tm._mesh_mgr
    facts = mgr.memory_facts(net.updater_states)
    from deeplearning4j_tpu_torch.util.tree import leaves

    proj = {dp: shard_projection(leaves(net.updater_states), dp)
            for dp in (2, 8)}
    res["memory_facts"] = facts
    res["projection"] = proj
    log(f"scaleout (a) memory_facts at world 1: {facts}; the policy at "
        f"dp 2: {proj[2]}; at dp 8: {proj[8]}")
    # NCCL's reduce-scatter and all-gather at world 1: copies
    v = torch.arange(4096, dtype=torch.float32, device=DEV)
    rs_ok = torch.equal(collectives.reduce_scatter(v), v)
    ag_ok = torch.equal(collectives.all_gather(v), v)
    res["nccl_rs_ag_identity"] = rs_ok and ag_ok
    if not (rs_ok and ag_ok):
        fail("scaleout (a): NCCL reduce-scatter/all-gather at world 1 are "
             "not the identity")
    # save, then a fresh master's restore and GROUP_K more steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm.save_checkpoint(at)
    save_s = time.perf_counter() - t0
    d = tm.checkpoint_dir
    sizes = {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
             if f.endswith(".npz")}
    tm.fit(batch_fn, at + k, start_step=at)
    del ref, tm_ref
    torch.cuda.empty_cache()
    net2 = flagship(ResNet50, "pallas")
    tm2 = TrainingMaster(net2, sharding="zero1", steps_per_dispatch=k,
                         checkpoint_dir=d)
    t0 = time.perf_counter()
    tm2.load_checkpoint_at(at)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    tm2.fit(batch_fn, at + k, start_step=at)
    torch.cuda.synchronize()
    same, count, diff = same_bits(torch, net, net2)
    res["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                         "files": sizes, "step": at, "tensors": count,
                         "differ": diff, "reshards": mgr.reshards}
    log(f"scaleout (a) checkpoint at step {at}: save {save_s:.3f} s "
        f"(gather + main + sidecar), restore {restore_s:.3f} s, files "
        f"{sizes}; {k} more steps after the restore against the "
        f"uninterrupted run: {count} tensors, {diff} differ [{card}]")
    if not same:
        fail("scaleout (a): the restored ZeRO-1 run differs from the "
             "uninterrupted one")
    del net, net2, tm, tm2, prog
    torch.cuda.empty_cache()
    return res


class GroupLosses:
    """A listener keeping the net's loss after each local-SGD group."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration):
        self.losses.append(float(net.score()))


def scaleout_local_sgd(torch, np, ResNet50, card, ref_state):
    """Phase 5m (b): ParallelWrapper(averaging_frequency=GROUP_K) at world
    1 against the unsharded state after the same batches; then threshold
    compression."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    res = {}
    data, batch_fn = tm_data(np, 70, TRAIN_BATCH)
    steps = GROUP_K + SCALEOUT_STEPS
    batches = [batch_fn(s) for s in range(steps)]
    net = flagship(ResNet50, "pallas")
    t0 = time.perf_counter()
    ParallelWrapper(net, averaging_frequency=GROUP_K).fit(batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    state = train_state(net)
    diff = sum(1 for a, b in zip(state, ref_state)
               if not bits_equal(torch, a, b))
    res["local_sgd"] = {"steps": steps, "seconds": secs,
                        "tensors": len(state), "differ": diff}
    log(f"scaleout (b) ParallelWrapper(averaging_frequency={GROUP_K}) over "
        f"{steps} batches of {TRAIN_BATCH} against the unsharded "
        f"run_group({GROUP_K}) state: {len(state)} tensors, {diff} differ "
        f"({secs:.2f} s, eager local steps) [{card}]")
    if diff:
        fail("scaleout (b): local SGD at world 1 differs from the plain "
             "steps (the rendezvous of one rank must be an identity)")
    del net, state
    torch.cuda.empty_cache()
    net = flagship(ResNet50, "pallas")
    rec = GroupLosses()
    net.listeners = [rec]
    pw = ParallelWrapper(net, averaging_frequency=GROUP_K,
                         threshold_compression=SCALEOUT_THRESHOLD)
    pw.fit(batches)
    wire = pw._local_step.wire_stats()
    res["threshold"] = {"wire": wire, "group_losses": rec.losses}
    log(f"scaleout (b) threshold_compression={SCALEOUT_THRESHOLD}: "
        f"wire_stats {wire}; loss per rendezvous {rec.losses} [{card}]")
    if not (all(np.isfinite(rec.losses))
            and rec.losses[-1] < rec.losses[0]
            and wire["rendezvous"] == steps // GROUP_K
            and 0 < wire["compression_ratio"] < 1):
        fail("scaleout (b): the compressed local SGD run did not train "
             "(finite, falling loss, a compression ratio in (0, 1))")
    del net, pw
    torch.cuda.empty_cache()
    return res


def scaleout_stale(torch, np, ResNet50, card):
    """Phase 5m (c): StaleGradientTrainer against the delayed-gradient
    oracle on the flagship."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.base_network import clip_grads
    from deeplearning4j_tpu_torch.parallel import (
        StaleGradientTrainer,
        make_mesh,
    )
    from deeplearning4j_tpu_torch.util.tree import tree_map

    data, batch_fn = tm_data(np, 71, TRAIN_BATCH)
    batches = [batch_fn(s) for s in range(SCALEOUT_STALE_STEPS)]
    net = flagship(ResNet50, "pallas")
    tr = StaleGradientTrainer(net, make_mesh())
    got = []
    for x, y in batches:
        got.append(float(tr.step(x, y)))
    tr.flush()
    torch.cuda.synchronize()
    got_state = [t.float().clone() for t in train_state(net)]
    del net, tr
    torch.cuda.empty_cache()
    ref = flagship(ResNet50, "pallas")
    prog = StepProgram(ref)
    want, prev = [], None
    for x, y in batches + [(None, None)]:
        params, upd, states = ref._train_carry()
        sc = ref._step_scalars(ref.iteration)[0]
        g = prev
        if x is not None:
            inputs, labels, lmasks, fmasks = prog._tensors(x, y, None, None)
            grads, loss, states, _ = ref._grads(
                params, states, inputs, labels, lmasks, fmasks)
            with torch.no_grad():
                prev = clip_grads(ref.conf, grads)
            want.append(float(loss))
        if g is None:
            g = tree_map(torch.zeros_like, params)
        with torch.no_grad():
            params, upd = ref._apply_updates(params, upd, g, sc[0], sc[1])
        ref._set_train_carry((params, upd, states))
        if x is not None:
            ref.iteration += 1
    torch.cuda.synchronize()
    ref_state = train_state(ref)
    diff = sum(1 for a, b in zip(got_state, ref_state)
               if not torch.equal(a, b.float()))
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want)]
    worst = max(float(torch.max(torch.abs(a - b.float())))
                for a, b in zip(got_state, ref_state))
    res = {"steps": SCALEOUT_STALE_STEPS, "losses": got, "oracle": want,
           "loss_gap": max(gaps), "tensors": len(got_state),
           "differ": diff, "max_abs_state_diff": worst}
    log(f"scaleout (c) StaleGradientTrainer, {SCALEOUT_STALE_STEPS} steps + "
        f"flush against the delayed-gradient oracle: largest relative loss "
        f"gap {max(gaps):.3e} (STEP_TOL {STEP_TOL['bfloat16']['loss']}), "
        f"{diff} of {len(got_state)} state tensors differ (largest "
        f"{worst:.3e}); losses {got} [{card}]")
    if max(gaps) > STEP_TOL["bfloat16"]["loss"] or not np.isfinite(worst):
        fail("scaleout (c): the stale trainer is not the delayed-gradient "
             "oracle")
    del ref
    torch.cuda.empty_cache()
    return res


def gang_inputs(np, io):
    """The gang's inputs in the port's own terms (tests/fixtures/torch/
    scaleout_worker.py reads them): kernel-free nets with seeded port
    weights, seeded data at SCALEOUT_GANG_BATCH rows."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization,
        ConvolutionLayer,
        DenseLayer,
        OutputLayer,
        SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.tree import leaves

    confs = {
        "conv": (NeuralNetConfiguration.Builder().seed(3).updater("sgd")
                 .learning_rate(0.05).weight_init("xavier").list()
                 .layer(ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                         activation="relu"))
                 .layer(BatchNormalization())
                 .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                 .layer(OutputLayer(n_out=3, loss="mcxent"))
                 .set_input_type(InputType.convolutional(8, 8, 1)).build()),
        "mlp8": (NeuralNetConfiguration.Builder().seed(7).updater("sgd")
                 .learning_rate(0.1).activation("tanh").weight_init("xavier")
                 .list().layer(DenseLayer(n_out=16))
                 .layer(OutputLayer(n_out=4, loss="mcxent"))
                 .set_input_type(InputType.feed_forward(8)).build()),
        "adam24": (NeuralNetConfiguration.Builder().seed(7).updater("adam")
                   .learning_rate(1e-2).activation("tanh")
                   .weight_init("xavier").list()
                   .layer(DenseLayer(n_out=24))
                   .layer(OutputLayer(n_out=24, loss="mcxent"))
                   .set_input_type(InputType.feed_forward(24)).build())}
    spec = {"nets": {}, "helpers": {},
            "steps": {"dp_conv": SCALEOUT_GANG_STEPS,
                      "z1": SCALEOUT_GANG_STEPS}}
    arrays = {}
    for name, conf in confs.items():
        net = MultiLayerNetwork(conf, device="cpu").init()
        spec["nets"][name] = ["mln", conf.to_json()]
        for prefix, tree in (("p", net.params), ("s", net.states)):
            for i, t in enumerate(leaves(tree)):
                arrays[f"{name}/{prefix}:{i}"] = t.numpy()
    rng = np.random.default_rng(72)
    b, n = SCALEOUT_GANG_BATCH, SCALEOUT_GANG_STEPS
    onehot = lambda rows, c, *lead: np.eye(c, dtype=np.float32)[
        rng.integers(0, c, lead + (rows,))]
    x = rng.normal(size=(b, 8, 8, 1)).astype(np.float32)
    x[b // 2:] = x[b // 2:] * 3 + 1          # the two dp halves differ
    data = {"conv_x": x, "conv_y": onehot(b, 3),
            "lsgd_x": rng.normal(size=(n, b, 8)).astype(np.float32),
            "lsgd_y": onehot(b, 4, n),
            "z_x": rng.normal(size=(max(n, 8), b, 24)).astype(np.float32),
            "z_y": onehot(b, 24, max(n, 8))}
    os.makedirs(io, exist_ok=True)
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(io, "nets.npz"), **arrays)
    np.savez(os.path.join(io, "data.npz"), **data)


# where `--gang-logs` keeps every gang rank's whole log (None: not kept)
GANG_LOG_DIR = None


def run_gangs(np, tmp, world, backend, only, wait_s=300.0, env_extra=None,
              check=True):
    """tests/fixtures/torch/scaleout_worker.py's gang of `world` ranks on
    the card(s) (`backend` gloo: CUDA tensors on one card; nccl: one card
    per rank) and the same gang over gloo on the CPU, at the same time,
    over gang_inputs; `env_extra` joins the card gang's environment.
    Returns ({"card"|"cpu": rank 0's arrays}, {"card"|"cpu": rank 0's
    facts}, seconds); with `check` False a failed gang returns (None,
    {"rcs": ..., "tails": ...}, seconds) instead of failing the run."""
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "tests", "fixtures", "torch",
                          "scaleout_worker.py")
    ios, procs, logs = {}, [], []
    t0 = time.perf_counter()
    for which, dev, be in (("card", DEV, backend), ("cpu", "cpu", "gloo")):
        io = ios[which] = os.path.join(tmp, f"gang-{which}-{world}")
        os.makedirs(io, exist_ok=True)
        gang_inputs(np, io)
        port = free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = here
        if be == "nccl":
            env.setdefault("NCCL_DEBUG", "WARN")
        if which == "card":
            env.update(env_extra or {})
        for r in range(world):
            log_f = open(os.path.join(io, f"log-{r}.txt"), "w")
            logs.append(log_f)
            procs.append(subprocess.Popen(
                [sys.executable, worker, "--rank", str(r), "--world",
                 str(world), "--port", str(port), "--io", io, "--device",
                 dev, "--backend", be, "--only", only],
                stdout=log_f, stderr=subprocess.STDOUT, env=env, cwd=here))
    deadline = time.perf_counter() + wait_s
    try:
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.perf_counter())))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    secs = time.perf_counter() - t0
    if GANG_LOG_DIR:
        dst = os.path.join(GANG_LOG_DIR, os.path.basename(tmp.rstrip("/")))
        os.makedirs(dst, exist_ok=True)
        for which, io in ios.items():
            for r in range(world):
                shutil.copy(os.path.join(io, f"log-{r}.txt"),
                            os.path.join(dst, f"{which}-log-{r}.txt"))
    if any(rcs):
        tails = "".join(
            open(os.path.join(io, f"log-{r}.txt")).read()[-3000:]
            for io in ios.values() for r in range(world))
        if not check:
            # each card rank's capture lines, its last NCCL collective
            # lines and its errors, from the whole log
            lines = {}
            for r in range(world):
                text = open(os.path.join(ios["card"],
                                         f"log-{r}.txt")).read()
                ls = text.splitlines()
                coll = [ln for ln in ls if "NCCL INFO" in ln
                        and "opCount" in ln]
                lines[r] = ([ln for ln in ls if "graph rank" in ln]
                            + coll[-4:]
                            + [ln for ln in ls if "imeout" in ln
                               or "Error" in ln or "timed out" in ln][-6:])
            return None, {"rcs": rcs, "tails": tails, "lines": lines}, secs
        fail(f"scaleout gang of {world}: a rank failed {rcs}:\n{tails}")
    out = {w: dict(np.load(os.path.join(io, "out-0.npz")))
           for w, io in ios.items()}
    facts = {}
    for w, io in ios.items():
        with open(os.path.join(io, "out-0.json")) as f:
            facts[w] = json.load(f)
    return out, facts, secs


def gang_errors(np, out, scens):
    """{scenario: largest |card - cpu| / (atol + rtol |cpu|)} under
    SCALEOUT_GANG_TOL (<= 1 passes)."""
    card, cpu = out["card"], out["cpu"]
    errs = {}
    for scen in scens:
        keys = [k for k in cpu if k.startswith(scen + "/")]
        errs[scen] = max(
            float(np.max(np.abs(card[k] - cpu[k])
                         / (SCALEOUT_GANG_TOL["atol"]
                            + SCALEOUT_GANG_TOL["rtol"] * np.abs(cpu[k]))))
            for k in keys)
    return errs


def bitwise_pair(np, arrays, a, b):
    keys = [k for k in arrays if k.startswith(a + "/")]
    return bool(keys) and all(
        np.array_equal(arrays[k], arrays[b + k[len(a):]]) for k in keys)


def scaleout_gang(torch, np, card, tmp):
    """Phase 5m (d): the tests' 2-rank gloo gang, once with CUDA tensors
    on the one card and once on the CPU, at the same time."""
    out, _, secs = run_gangs(np, tmp, 2, "gloo", "dp_conv,lsgd,zero1")
    errs = gang_errors(np, out, ("dp_conv", "lsgd", "z1", "dp_tm"))
    z1_bitwise = bitwise_pair(np, out["card"], "z1", "dp_tm")
    res = {"seconds": secs, "tol_ratio": errs, "zero1_bitwise": z1_bitwise}
    log(f"scaleout (d) 2-rank gloo gang, CUDA tensors on the card against "
        f"the CPU gang ({SCALEOUT_GANG_STEPS} steps at batch "
        f"{SCALEOUT_GANG_BATCH}): largest |card - cpu| / (atol + rtol |cpu|)"
        f" per scenario {errs} (<= 1 passes {SCALEOUT_GANG_TOL}); ZeRO-1 "
        f"against the unsharded 2-rank run on the card bit for bit: "
        f"{z1_bitwise}; both gangs {secs:.1f} s [{card}]")
    if max(errs.values()) > 1.0 or not z1_bitwise:
        fail("scaleout (d): the card's gang disagrees with the CPU gang, or "
             "its ZeRO-1 with its unsharded run")
    return res


def nccl_gang(torch, np, card, world):
    """`--nccl-gang N` (N cards): the tests' gang of N ranks over NCCL, one
    card per rank, against the same gang over gloo on the CPU within
    SCALEOUT_GANG_TOL, in two launches: (1) eager — per-step dp with
    global BatchNorm statistics, local SGD k=2, ZeRO-1 with real
    reduce-scatters and all-gathers (against the unsharded run: reported,
    bit for bit only where the sums keep their order); (2) ZeRO-1's
    run_group(4) with the collectives captured, against its eager k=1
    steps."""
    gap = lambda arrays, a, b: max(
        float(np.max(np.abs(arrays[k] - arrays[b + k[len(a):]])))
        for k in arrays if k.startswith(a + "/"))
    res = {"world": world}
    with tempfile.TemporaryDirectory() as tmp:
        out, facts, secs = run_gangs(
            np, os.path.join(tmp, "eager"), world, "nccl",
            "dp_conv,lsgd,zero1", wait_s=150.0)
        errs = gang_errors(np, out, ("dp_conv", "lsgd", "z1", "dp_tm"))
        res["eager"] = {
            "seconds": secs, "tol_ratio": errs,
            "zero1_vs_unsharded": {
                "bitwise": bitwise_pair(np, out["card"], "z1", "dp_tm"),
                "max_abs": gap(out["card"], "z1", "dp_tm")},
            "layout": facts["card"]["z1"]["layout"],
            "memory": facts["card"]["z1"]["memory"]}
        log(f"nccl gang (1) eager: {world} ranks over NCCL, one card each, "
            f"against the same gang over gloo on the CPU: {res['eager']} "
            f"[{card}]")
        if max(errs.values()) > 1.0:
            fail("nccl gang (1): the NCCL gang disagrees with the CPU gang")
        # (2), the F11 drill: the refusal lifted, a hang made an error
        # that names the collective, every rank's capture logged
        drill = {"DL4J_TPU_NCCL_CAPTURE": "1", "DL4J_TPU_GRAPH_LOG": "1",
                 "DL4J_TPU_PG_TIMEOUT_S": "60",
                 "TORCH_NCCL_BLOCKING_WAIT": "1", "NCCL_DEBUG": "INFO",
                 "NCCL_DEBUG_SUBSYS": "INIT,COLL"}
        out, facts, secs = run_gangs(
            np, os.path.join(tmp, "groups"), world, "nccl",
            "zero1_groups", wait_s=100.0, check=False, env_extra=drill)
        res["f11"] = {"passed": out is not None, "seconds": secs}
        if out is None:
            res["f11"].update(rcs=facts["rcs"], lines=facts["lines"])
            log(f"nccl gang (2) F11 drill: ranks ended {facts['rcs']} in "
                f"{secs:.1f} s; each rank's capture lines, last collectives "
                f"and errors:\n"
                + "\n".join(f"[rank {r}] {ln[:300]}"
                             for r, ls in facts["lines"].items()
                             for ln in ls))
            fail("nccl gang (2): the captured ZeRO-1 groups hung or failed "
                 "(F11; logs above)")
    errs = gang_errors(np, out, ("z1_k1", "z1_k4"))
    coll = facts["card"]["z1_k4"]["collectives"]
    res["groups"] = {"seconds": secs, "tol_ratio": errs,
                     "k4_vs_k1": {
                         "bitwise": bitwise_pair(np, out["card"], "z1_k4",
                                                 "z1_k1"),
                         "max_abs": gap(out["card"], "z1_k4", "z1_k1")},
                     "collectives_per_replay": coll}
    log(f"nccl gang (2) captured ZeRO-1 groups: {res['groups']} [{card}]")
    if (max(errs.values()) > 1.0 or not coll
            or not all(c.get("reduce_scatter", 0) >= 4
                       and c.get("all_gather", 0) >= 4
                       for c in coll.values())):
        fail("nccl gang (2): the captured ZeRO-1 groups disagree with the "
             "CPU gang, or hold no reduce-scatter/all-gather")
    return res


def scaleout_phase(torch, np, pc, ResNet50, card, det):
    """Phase 5m (module docstring): (a)-(e) over one NCCL group of world
    1, destroyed at the end."""
    from deeplearning4j_tpu_torch.parallel import collectives, dcn_sweep

    res = {}
    parts = {}
    torch.backends.cudnn.deterministic = det
    collectives.init_process_group(f"127.0.0.1:{free_port()}", 1, 0,
                                   device=DEV)
    try:
        log(f"scaleout: process group backend {collectives.backend()}, "
            f"world {collectives.world_size()}")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res["zero1"] = scaleout_zero1(torch, np, pc, ResNet50, card, tmp)
            parts["a"] = time.perf_counter() - t0
            # the unsharded state after GROUP_K + SCALEOUT_STEPS steps, for
            # (b): recomputed by the plain run (cheaper than keeping it)
            t0 = time.perf_counter()
            from deeplearning4j_tpu_torch.parallel import TrainingMaster

            _, batch_fn = tm_data(np, 70, TRAIN_BATCH)
            ref = flagship(ResNet50, "pallas")
            TrainingMaster(ref, steps_per_dispatch=GROUP_K).fit(
                batch_fn, GROUP_K + SCALEOUT_STEPS)
            ref_state = [t.clone() for t in train_state(ref)]
            del ref
            torch.cuda.empty_cache()
            res["local_sgd"] = scaleout_local_sgd(torch, np, ResNet50, card,
                                                  ref_state)
            del ref_state
            torch.cuda.empty_cache()
            parts["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["stale"] = scaleout_stale(torch, np, ResNet50, card)
            parts["c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["gang"] = scaleout_gang(torch, np, card, tmp)
            parts["d"] = time.perf_counter() - t0
    finally:
        collectives.destroy_process_group()
        torch.backends.cudnn.deterministic = False
    # (e) the DCN model on the port's own measured inputs
    ms = res["zero1"]["ms_per_step"]["zero1"]
    param_bytes = res["zero1"]["params"] * 4
    sweep = dcn_sweep(param_bytes, ms, [2, 4, 8, 16])
    res["dcn"] = {"step_ms": ms, "param_bytes": param_bytes,
                  "sweep": [{k: r[k] for k in (
                      "n_slices", "exchange_ms", "sync_efficiency",
                      "local_sgd_efficiency", "k_for_target")}
                      for r in sweep]}
    log(f"scaleout (e) dcn_model.crossover_report on the port's inputs "
        f"(step {ms:.3f} ms from (a), {param_bytes} f32 parameter bytes; "
        f"the model's default link is a TPU slice's DCN, 25 GB/s, 0.1 ms): "
        f"{res['dcn']['sweep']}")
    res["launches"] = res["zero1"]["launches"]
    res["seconds_per_part"] = parts
    log(f"scaleout phase: seconds per part {parts}")
    return res


# ------------------------------------------------------------ phase 5n
def dense_attention(torch, q, k, v, causal):
    """softmax(QK^T / sqrt(D)) V of [B, T, H, D] tensors in f32, head by
    head (the scores of one head at a time): the plain reference of the
    ring."""
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=torch.float32, device=q.device)
    mask = (torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    for h in range(H):
        qh, kh, vh = (a[:, :, h].float() for a in (q, k, v))
        s = qh @ kh.transpose(-1, -2) / float(D) ** 0.5
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        out[:, :, h] = torch.softmax(s, dim=-1) @ vh
    return out


def mesh_barrier(torch):
    from deeplearning4j_tpu_torch.parallel import collectives

    collectives.all_reduce_sum(torch.zeros(1))


def sha_of(torch, ts):
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tol_ratio(torch, got, want, tol):
    """Largest |got - want| / (atol + rtol |want|) (<= 1 passes)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def mesh_ring(torch, rank):
    """5n (a): ring_self_attention over make_mesh(sp=2), causal, f32 and
    bf16: ms per call (both ranks synchronized), the hops, the output's
    hash on each rank, and on rank 0 (rank 1 waits) the largest error
    against dense attention and one scaled_dot_product_attention call of
    the whole sequence on the card."""
    from deeplearning4j_tpu_torch.parallel import (
        collectives,
        make_mesh,
        ring_self_attention,
    )

    mesh = make_mesh(sp=2)
    B, T, H, D = (MESH_RING[c] for c in "BTHD")
    gen = torch.Generator().manual_seed(81)
    base = [torch.randn(B, T, H, D, generator=gen).to(DEV)
            for _ in range(3)]
    res = {"shape": [B, T, H, D], "sp": mesh.shape["sp"]}
    for dt in ("float32", "bfloat16"):
        q, k, v = (a.to(getattr(torch, dt)) for a in base)
        out = ring_self_attention(q, k, v, mesh, causal=True)
        torch.cuda.synchronize()
        mesh_barrier(torch)
        hops0 = collectives.COUNTS["ppermute"]
        t0 = time.perf_counter()
        for _ in range(MESH_RING_CALLS):
            out = ring_self_attention(q, k, v, mesh, causal=True)
        torch.cuda.synchronize()
        r = {"ms_per_call": (time.perf_counter() - t0) * 1e3
             / MESH_RING_CALLS,
             "hops_per_call": (collectives.COUNTS["ppermute"] - hops0)
             / MESH_RING_CALLS,
             "out_sha": sha_of(torch, [out]),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        mesh_barrier(torch)
        if rank == 0:
            ref = dense_attention(torch, q, k, v, True)
            r["tol_ratio"] = tol_ratio(torch, out, ref, MESH_RING_TOL[dt])
            r["max_abs_err"] = float((out.float() - ref).abs().max())
            del ref
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            F = torch.nn.functional
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_RING_CALLS):
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.cuda.synchronize()
            r["sdpa_ms"] = (time.perf_counter() - t0) * 1e3 / MESH_RING_CALLS
            del qt, kt, vt
        mesh_barrier(torch)
        res[dt] = r
        del out
        torch.cuda.empty_cache()
    return res


def mesh_tp_vgg(torch, np, rank):
    """5n (b): VGG16 (phase 5c's) at MESH_VGG_BATCH through
    ParallelWrapper(tp=2): one warm fit of a step, then a fit of
    MESH_VGG_STEPS + 1 steps: ms per step between its first and last step
    ends (CUDA-synchronized listener stamps: the steady state) and over
    the whole fit (with its slicing and gathering), the collectives per
    step, an empty fit timing the slicing and gathering alone, each
    rank's param and updater bytes; then on rank 0 (rank 1 waits) the
    same steps in one process from the same seeded init: ms per step and
    the tp params' largest error against them (MESH_TP_TOL)."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, collectives
    from deeplearning4j_tpu_torch.util.tree import leaves
    from deeplearning4j_tpu_torch.zoo.models import VGG16

    class Stamps:
        def __init__(self):
            self.t = []

        def iteration_done(self, net, iteration):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())

    x, y = mln_batch(torch, np, 73, MESH_VGG_BATCH)
    init_sum = lambda n: float(sum(float(t.double().abs().sum())
                                   for t in leaves(n.params)))
    net = vgg16(VGG16)
    res = {"params": net.num_params(), "init_sum": init_sum(net)}
    stamps = Stamps()
    net.listeners = [stamps]
    pw = ParallelWrapper(net, tp=2, pipeline=False)
    pw.fit([(x, y)])
    torch.cuda.synchronize()
    mesh_barrier(torch)
    torch.cuda.reset_peak_memory_stats()
    stamps.t.clear()
    c0 = dict(collectives.COUNTS)
    t0 = time.perf_counter()
    pw.fit([(x, y)] * (MESH_VGG_STEPS + 1))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steady = stamps.t[-1] - stamps.t[0]
    res["tp_ms_per_step"] = steady * 1e3 / MESH_VGG_STEPS
    res["tp_fit_ms_per_step"] = (t1 - t0) * 1e3 / (MESH_VGG_STEPS + 1)
    res["collectives_per_fit"] = {k: collectives.COUNTS[k] - c0[k]
                                  for k in c0}
    res["tp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["memory"] = pw.tp_memory
    res["tp_loss"] = float(net.score())
    t0 = time.perf_counter()
    pw.fit([])
    torch.cuda.synchronize()
    res["slice_gather_s"] = time.perf_counter() - t0
    res["mesh"] = pw.mesh.shape
    res["params_sha"] = sha_of(torch, leaves(net.params))
    mesh_barrier(torch)
    if rank == 0:
        ref = vgg16(VGG16)
        res["ref_init_sum"] = init_sum(ref)
        prog = StepProgram(ref)
        prog.run(x, y)
        torch.cuda.synchronize()
        prog.run(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_VGG_STEPS):
            prog.run(x, y)
        torch.cuda.synchronize()
        res["one_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                  / MESH_VGG_STEPS)
        res["one_loss"] = float(ref.score())
        res["tol_ratio"] = max(
            tol_ratio(torch, a, b, MESH_TP_TOL)
            for a, b in zip(leaves(net.params), leaves(ref.params)))
        res["max_abs_err"] = max(
            float((a - b).abs().max())
            for a, b in zip(leaves(net.params), leaves(ref.params)))
        del ref, prog
    del net, pw
    torch.cuda.empty_cache()
    mesh_barrier(torch)
    return res


def mesh_w2v(torch, np, rank):
    """5n (c): DistributedSequenceVectors over the two ranks at phase 5l's
    bench.py:468 configuration (each rank trains its half of the
    sequences, one rendezvous per epoch): a warm epoch, then
    MESH_W2V_EPOCHS timed epochs up to a host read; the corpus' words/s,
    the rendezvous seconds, the tables' hash on each rank."""
    from deeplearning4j_tpu_torch.nlp.distributed import (
        DistributedSequenceVectors,
    )
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    seqs = zipf_corpus(np, NLP_VOCAB, NLP_WORDS, NLP_SEQ, 0)
    sv = SequenceVectors(layer_size=NLP_DIM, window=NLP_WINDOW,
                         negative=NLP_NEG, epochs=1, seed=1, mode="dense",
                         device=DEV)
    dsv = DistributedSequenceVectors(sv, sync_every=1)
    dsv.build_vocab(seqs)
    t0 = time.perf_counter()
    dsv.fit(seqs, epochs=1)
    float(sv._syn0_dev[0, 0])
    res = {"warm_s": time.perf_counter() - t0}
    mesh_barrier(torch)
    r0, n0 = dsv.rendezvous_s, dsv.wire_stats()["rendezvous"]
    t0 = time.perf_counter()
    dsv.fit(seqs, epochs=MESH_W2V_EPOCHS)
    float(sv._syn0_dev[0, 0])
    t = time.perf_counter() - t0
    res.update({
        "epochs": MESH_W2V_EPOCHS, "fit_s": t,
        "words_per_s": NLP_WORDS * MESH_W2V_EPOCHS / t,
        "rendezvous_s": dsv.rendezvous_s - r0,
        "rendezvous": dsv.wire_stats()["rendezvous"] - n0,
        "tables_sha": sha_of(torch, [sv._syn0_dev, sv._syn1neg_dev]),
        "finite": bool(np.isfinite(sv.syn0).all()
                       and np.isfinite(sv.syn1neg).all())})
    mesh_barrier(torch)
    return res


def mesh_rank_main(rank, world, port, io):
    """One rank of phase 5n's gang (`--mesh-rank`): (a)-(c) in sequence
    over one gloo group with CUDA tensors on the card; writes
    io/rank-<rank>.json. Imports only the port."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as pc
    from deeplearning4j_tpu_torch.parallel import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    collectives.init_process_group(f"127.0.0.1:{port}", world, rank,
                                   backend="gloo", device=DEV)
    pc.reset_launch_counts()
    out = {"rank": rank, "seconds": {}}
    try:
        for name, fn in (("ring", lambda: mesh_ring(torch, rank)),
                         ("tp", lambda: mesh_tp_vgg(torch, np, rank)),
                         ("w2v", lambda: mesh_w2v(torch, np, rank))):
            t0 = time.perf_counter()
            out[name] = fn()
            out["seconds"][name] = time.perf_counter() - t0
            print(f"mesh rank {rank}: {name} {out['seconds'][name]:.1f} s",
                  flush=True)
        out["launches"] = pc.launch_counts()
    finally:
        with open(os.path.join(io, f"rank-{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        collectives.destroy_process_group()


def mesh_gang(np, tmp, world=2, wait_s=240.0):
    """Phase 5n's gang: `world` ranks of this script (`--mesh-rank`) on
    the card. Returns ([rank outputs], seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    io = os.path.join(tmp, "mesh")
    os.makedirs(io, exist_ok=True)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = here
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        log_f = open(os.path.join(io, f"log-{r}.txt"), "w")
        logs.append(log_f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), "--mesh-world", str(world), "--mesh-port", str(port),
             "--mesh-io", io], stdout=log_f, stderr=subprocess.STDOUT,
            env=env, cwd=here))
    deadline = time.perf_counter() + wait_s
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.perf_counter())))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    secs = time.perf_counter() - t0
    if any(rcs):
        tails = "".join(open(os.path.join(io, f"log-{r}.txt")).read()[-4000:]
                        for r in range(world))
        fail(f"mesh gang: a rank failed {rcs}:\n{tails}")
    outs = []
    for r in range(world):
        with open(os.path.join(io, f"rank-{r}.json")) as f:
            outs.append(json.load(f))
    return outs, secs


def mesh_drill(np, tmp, res):
    """5n (d): tests/test_torch_cluster_gang.py's SIGKILL drill on the
    card: gang_worker.py's 2 ranks (gloo, CUDA tensors) under
    ClusterSupervisor, unfaulted, then with rank 1 SIGKILLed from outside
    at step 2 or later; the relaunched gang's final params against the
    unfaulted run's (rtol 1e-6, atol 1e-7). Fills `res`."""
    from deeplearning4j_tpu_torch.resilience import (
        ClusterSupervisor,
        HeartbeatFile,
        heartbeat_path,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "tests", "fixtures", "torch",
                          "gang_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = here
    env.pop("DL4J_TPU_FAULTS", None)

    def run(name, spin_ms, kill):
        out = os.path.join(tmp, f"drill-{name}")
        hb_dir = os.path.join(out, "hb")
        os.makedirs(out, exist_ok=True)

        def command_fn(rank, nprocs, port, resume_step):
            return [sys.executable, worker, str(rank), str(nprocs),
                    str(port), str(MESH_DRILL_STEPS), out,
                    "--checkpoint-every", "1", "--cluster",
                    "--heartbeat-dir", hb_dir, "--resume-step",
                    str(resume_step), "--device", DEV, "--spin-ms",
                    str(spin_ms)]

        cs = ClusterSupervisor(2, command_fn, hb_dir,
                               checkpoint_dir=os.path.join(out, "ckpt"),
                               lease_timeout_s=120.0, startup_grace_s=120.0,
                               poll_s=0.2, restart_backoff_s=0.2,
                               max_restarts_per_worker=2, env=env)
        killed = {}

        def killer():
            while not killed and not stop.is_set():
                rec = HeartbeatFile.read(heartbeat_path(hb_dir, 1))
                if (rec and rec.get("status") == "running"
                        and (rec.get("step") or 0) >= 2):
                    try:
                        os.kill(rec["pid"], 9)
                        killed["pid"] = rec["pid"]
                        killed["t"] = time.perf_counter()
                    except ProcessLookupError:
                        pass
                    return
                time.sleep(0.05)

        stop = threading.Event()
        th = threading.Thread(target=killer, daemon=True) if kill else None
        if th:
            th.start()
        t0 = time.perf_counter()
        stats = cs.run(timeout_s=200.0)
        t1 = time.perf_counter()
        stop.set()
        if th:
            th.join(timeout=5.0)
        with np.load(os.path.join(out, "final_params.npz")) as z:
            final = [z[k] for k in z.files if k.startswith("arr_")]
            it = int(z["iteration"])
        return stats, final, it, t1 - t0, killed

    try:
        s0, f0, it0, sec0, _ = run("oracle", 0, False)
        s1, f1, it1, sec1, killed = run("kill", 250, True)
        ok = (bool(killed) and s1["gang_restarts"] == 1
              and it1 == it0 == MESH_DRILL_STEPS and len(f0) == len(f1)
              and all(np.allclose(a, b, rtol=1e-6, atol=1e-7)
                      for a, b in zip(f1, f0)))
        res.update({
            "ok": ok, "oracle_s": sec0, "drill_s": sec1,
            "gang_restarts": s1["gang_restarts"],
            "ledger": [{k: e[k] for k in ("worker", "reason", "collateral",
                                          "resume_step")}
                       for e in s1["ledger"]],
            "max_abs_vs_oracle": max(float(np.max(np.abs(a - b)))
                                     for a, b in zip(f1, f0))})
    except Exception as e:   # noqa: BLE001 - reported by the phase
        res.update({"ok": False, "error": repr(e)})


def mesh_phase(torch, np, pc, card, nlp_words_per_s):
    """Phase 5n (module docstring): the 2-rank gang's (a)-(c) and, on a
    thread beside it, (d). The kernel launch counters are set to 0 before
    it and read after it, the gang's ranks' added: no kernel of csrc/ is
    on these paths."""
    pc.reset_launch_counts()
    res = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        drill = {}
        th = threading.Thread(target=mesh_drill, args=(np, tmp, drill),
                              daemon=True)
        th.start()
        outs, secs = mesh_gang(np, tmp)
        t0 = time.perf_counter()
        th.join(timeout=240.0)
        wait_s = time.perf_counter() - t0
    r0, r1 = outs
    ring, tp, w2v = r0["ring"], r0["tp"], r0["w2v"]
    launches = {k: pc.LAUNCHES[k] + sum(o["launches"].get(k, 0)
                                        for o in outs)
                for k in pc.LAUNCHES if "/" not in k}
    res.update({"gang_s": secs, "drill_wait_s": wait_s,
                "rank_seconds": [o["seconds"] for o in outs],
                "ring": ring, "tp": tp, "w2v": w2v, "drill": drill,
                "launches": launches})
    for dt in ("float32", "bfloat16"):
        r = ring[dt]
        log(f"mesh (a) ring_self_attention over make_mesh(sp=2), 2 gloo "
            f"ranks on the card, B {MESH_RING['B']}, T {MESH_RING['T']}, H "
            f"{MESH_RING['H']}, D {MESH_RING['D']}, causal, {dt}: "
            f"{r['ms_per_call']:.3f} ms per call ({r['hops_per_call']:.0f} "
            f"hop each, through host buffers), the same output on both "
            f"ranks: {r['out_sha'] == r1['ring'][dt]['out_sha']}; against "
            f"dense attention on the card max |err| {r['max_abs_err']:.3e} "
            f"({r['tol_ratio']:.3f} of {MESH_RING_TOL[dt]}); "
            f"scaled_dot_product_attention of the whole sequence on one "
            f"rank {r['sdpa_ms']:.3f} ms; peak {r['peak_gb']:.2f} GB "
            f"[{card}]")
        if r["tol_ratio"] > 1.0 or r["out_sha"] != r1["ring"][dt]["out_sha"]:
            fail(f"mesh (a): the {dt} ring disagrees with dense attention "
                 "or between ranks")
    mem = tp["memory"]
    log(f"mesh (b) VGG16 ({tp['params']} params, bf16, dropout on) at batch "
        f"{MESH_VGG_BATCH} through ParallelWrapper(tp=2) (mesh {tp['mesh']}):"
        f" {tp['tp_ms_per_step']:.2f} ms/step in the steady state "
        f"({MESH_VGG_STEPS} steps; {tp['tp_fit_ms_per_step']:.2f} over the "
        f"whole fit with its slicing and gathering, alone "
        f"{tp['slice_gather_s']:.3f} s; collectives in the fit "
        f"{tp['collectives_per_fit']}) against {tp['one_ms_per_step']:.2f} "
        f"in one process ({tp['tp_ms_per_step'] / tp['one_ms_per_step']:.2f}"
        f"x); per rank "
        f"{mem['param_bytes']} of {mem['param_bytes_full']} param bytes "
        f"({mem['param_fraction']:.4f}) and {mem['updater_bytes']} of "
        f"{mem['updater_bytes_full']} updater bytes "
        f"({mem['updater_fraction']:.4f}); the params after fit against the "
        f"one-process fit: max |err| {tp['max_abs_err']:.3e} "
        f"({tp['tol_ratio']:.3f} of {MESH_TP_TOL}), loss {tp['tp_loss']:.5f}"
        f" against {tp['one_loss']:.5f}; both ranks' params equal: "
        f"{tp['params_sha'] == r1['tp']['params_sha']}; peak "
        f"{tp['tp_peak_gb']:.2f} GB [{card}]")
    if (tp["tol_ratio"] > 1.0 or tp["params_sha"] != r1["tp"]["params_sha"]
            or tp["init_sum"] != tp["ref_init_sum"]
            or not 0.45 < mem["param_fraction"] < 0.55):
        fail("mesh (b): the tp VGG16 fit disagrees with the one-process fit, "
             "between ranks, or holds more than its slices")
    log(f"mesh (c) DistributedSequenceVectors over 2 ranks at bench.py:468 "
        f"(vocab {NLP_VOCAB}, {NLP_WORDS} words, dim {NLP_DIM}, skip-gram NS, "
        f"dense, sync_every 1): {w2v['epochs']} epochs {w2v['fit_s']:.3f} s,"
        f" {w2v['words_per_s']:.0f} words/s (one process, phase 5l: "
        f"{nlp_words_per_s:.0f}); {w2v['rendezvous']} rendezvous "
        f"{w2v['rendezvous_s']:.3f} s in the timed fit; tables equal on "
        f"both ranks: {w2v['tables_sha'] == r1['w2v']['tables_sha']}; "
        f"finite {w2v['finite']} [{card}]")
    if w2v["tables_sha"] != r1["w2v"]["tables_sha"] or not w2v["finite"]:
        fail("mesh (c): the ranks' tables differ after the final rendezvous")
    log(f"mesh (d) SIGKILL gang drill on the card: {drill} [{card}]")
    if not drill.get("ok"):
        fail("mesh (d): the relaunched gang does not match its unfaulted run")
    log(f"mesh phase: gang {secs:.1f} s (per rank {res['rank_seconds']}), "
        f"the drill waited {wait_s:.1f} s more; kernel launches on these "
        f"paths {launches}")
    return res


# ------------------------------------------------------------ phase 5o
def analysis_records(torch, np, ResNet50, card):
    """(b)'s records: the flagship's single step and run_group(GROUP_K)
    group (the group captured first, so its record carries the captured
    launches and collectives), the serving forward, the decode programs.
    Returns (records, the net, the decode model)."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.parallel.inference import (
        ParallelInference,
    )
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    net = flagship(ResNet50, "pallas")
    (x, y), = engine_batches(np, 71, 1, TRAIN_BATCH,
                             net.conf.node("output").obj.n_out)
    prog = StepProgram(net)
    prog.run_group(np.repeat(x[None], GROUP_K, 0),
                   np.repeat(y[None], GROUP_K, 0))
    records = prog.lint_records(x, y, k=GROUP_K, name="flagship_step")
    pi = ParallelInference(net, batch_limit=BATCH, queue_limit=64,
                           max_wait_ms=1.0, pipeline_depth=0)
    try:
        rng = np.random.default_rng(5)
        for rows in (BATCH, BATCH, BATCH // 2):
            pi.output(serving_inputs(np, rng, rows), timeout_s=120.0)
        records += pi.lint_records()
    finally:
        pi.shutdown()
    model = CausalTransformer(**DECODE_BENCH, device=DEV).init()
    dprog = DecodeProgram(model, max_slots=DECODE_SLOTS,
                          page_size=DECODE_PAGE)
    dprog.warmup(dprog.init_kv())
    records += dprog.lint_records()
    return records, net, model


def analysis_check_records(reports, finds, card):
    """(b)'s checks and lines: every report's numbers, every finding,
    the flagship's and the serving forward's kernels all bf16 "wgmma",
    the group record's eager launches equal to its captured replay's."""
    from deeplearning4j_tpu_torch.analysis import Baseline

    for rep in reports:
        log(f"analysis (b) {rep['summary']}; wall {rep.get('wall_s', 0):.3f}"
            f" s; copy bytes by op {rep.get('churn_by_op', {})}; traffic "
            f"{rep.get('traffic_bytes', 0)} B [{card}]")
    for rep in reports:
        if not rep["name"].startswith(("flagship_step", "serving_predict")):
            continue
        kern = rep["kernels"]
        want = ({"fused_conv1x1", "fused_conv3x3"}
                if rep["name"] == "serving_predict" else
                {"fused_conv1x1", "fused_conv3x3", "dgrad_conv1x1",
                 "wgrad_conv1x1"})
        if {k.split("/")[0] for k in kern} != want or not all(
                k.endswith("/wgmma/bf16") for k in kern):
            fail(f"analysis (b) {rep['name']}: kernel launches {kern}, not "
                 f"every one of {sorted(want)} bf16 on wgmma")
    group = next(r for r in reports
                 if r["name"] == f"flagship_step_group_k{GROUP_K}")
    cap = group.get("notes", {}).get("captured_launches", {})
    eager = {}
    for k, v in group["kernels"].items():
        eager[k.split("/")[0]] = eager.get(k.split("/")[0], 0) + v
    log(f"analysis (b) the group record's eager launches {eager} against "
        f"the captured group's per replay "
        f"{ {k: v for k, v in cap.items() if '/' not in k} }; its "
        f"collectives per replay "
        f"{group.get('notes', {}).get('captured_collectives')} [{card}]")
    if any(cap.get(k) != v for k, v in eager.items()):
        fail("analysis (b): the group record's launches differ from the "
             "captured group's")
    here = os.path.dirname(os.path.abspath(__file__))
    bl = Baseline.load(os.path.join(here, "tools",
                                    "analyze_torch_baseline.json"))
    new, held, _ = bl.apply(finds)
    for f in finds:
        log(f"analysis (b) finding{'' if f in new else ' (baselined)'}: "
            f"{f.render()}")
    if new:
        fail(f"analysis (b): {len(new)} finding(s) not in the baseline")
    return {"findings": [f.to_dict() for f in finds],
            "baselined": len(held)}


def analysis_sanitized_serving(torch, np, net, model, card):
    """(c): ModelServer over the flagship (ANALYSIS_SERVE_THREADS npz
    client threads for ANALYSIS_SERVE_S), then a decode server answering
    ANALYSIS_DECODE_REQUESTS generate calls, all built and run under the
    port's LockOrderSanitizer."""
    from deeplearning4j_tpu_torch.analysis import LockOrderSanitizer
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    pool = [x for x in serving_pool(np, HW)
            if x.shape[0] in ANALYSIS_SERVE_SIZES]
    san = LockOrderSanitizer(long_hold_s=ANALYSIS_LONG_HOLD_S).install()
    done, errors, lock = [0], [], threading.Lock()
    try:
        server = ModelServer(net, model_name="resnet50", batch_limit=BATCH,
                             queue_limit=256, device=DEV).start()
        url = f"http://127.0.0.1:{server.port}"
        deadline = time.perf_counter() + ANALYSIS_SERVE_S

        def client(t):
            c = ModelClient(url, timeout=120.0, wire="npz")
            order = np.random.default_rng(300 + t)
            while time.perf_counter() < deadline:
                try:
                    c.predict(pool[int(order.integers(len(pool)))],
                              model="resnet50")
                    with lock:
                        done[0] += 1
                except Exception as e:   # noqa: BLE001 - counted, must be 0
                    errors.append(repr(e))

        ts = [threading.Thread(target=client, args=(t,), daemon=True,
                               name=f"analysis-client-{t}")
              for t in range(ANALYSIS_SERVE_THREADS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        server.stop()
        prog = DecodeProgram(model, max_slots=DECODE_SLOTS,
                             page_size=DECODE_PAGE)
        prog.warmup(prog.init_kv())
        dsrv = ModelServer(decode_engine=DecodeEngine(program=prog),
                           model_name="decoder", device=DEV).start()
        try:
            reqs = decode_requests(random.Random(5),
                                   ANALYSIS_DECODE_REQUESTS, DECODE_PROMPT,
                                   (8, 16), model.vocab_size)
            clients = [ModelClient(f"http://127.0.0.1:{dsrv.port}",
                                   timeout=300.0) for _ in range(2)]
            outs, _ = control_generate(clients, reqs)
        finally:
            dsrv.stop()
    finally:
        san.uninstall()
    cycles, holds, edges = san.cycles(), san.long_holds(), san.edges()
    res = {"requests": done[0], "errors": len(errors),
           "generated": sum(len(o) for o in outs), "edges": len(edges),
           "cycles": cycles,
           "long_holds": [{"site": h.site, "s": h.duration_s,
                           "thread": h.thread} for h in holds]}
    log(f"analysis (c) LockOrderSanitizer over {ANALYSIS_SERVE_S:.0f} s of "
        f"ResNet-50 \"pallas\" served over HTTP from "
        f"{ANALYSIS_SERVE_THREADS} client threads ({done[0]} requests, "
        f"{len(errors)} errors) and {ANALYSIS_DECODE_REQUESTS} decode "
        f"requests over HTTP ({res['generated']} tokens): {len(edges)} "
        f"lock-order edges, cycles {cycles}, long holds (> "
        f"{ANALYSIS_LONG_HOLD_S:g} s) {res['long_holds']} [{card}]")
    if cycles or errors or not done[0]:
        fail(f"analysis (c): cycles {cycles}, errors {errors[:3]}")
    return res


def analysis_phase(torch, np, pc, ResNet50, card):
    """Phase 5o (module docstring): (a)-(d)."""
    from deeplearning4j_tpu_torch.analysis import program_lint

    res, parts = {}, {}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable,
                        os.path.join(here, "tools", "analyze_torch.py")],
                       cwd=here, capture_output=True, text=True,
                       timeout=120)
    parts["a"] = time.perf_counter() - t0
    last = (p.stdout.strip().splitlines() or [""])[-1]
    res["ast"] = {"rc": p.returncode, "seconds": parts["a"], "line": last}
    log(f"analysis (a) tools/analyze_torch.py: exit {p.returncode} in "
        f"{parts['a']:.2f} s: {last}")
    if p.returncode != 0:
        fail(f"analysis (a): the analyzer found new findings:\n"
             f"{p.stdout[-3000:]}{p.stderr[-2000:]}")
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    records, net, model = analysis_records(torch, np, ResNet50, card)
    finds, reports = program_lint.run_with_reports(records)
    torch.cuda.synchronize()
    parts["b"] = time.perf_counter() - t0
    res["records"] = {r["name"]: r for r in reports}
    res.update(analysis_check_records(reports, finds, card))
    t0 = time.perf_counter()
    res["sanitizer"] = analysis_sanitized_serving(torch, np, net, model,
                                                  card)
    parts["c"] = time.perf_counter() - t0
    del net, model, records
    torch.cuda.empty_cache()
    res["launches"] = pc.launch_counts()
    res["seconds_per_part"] = parts
    log(f"analysis (d) the four kernels' launches on this path "
        f"{ {k: v for k, v in res['launches'].items() if '/' not in k} }; "
        f"seconds per part {parts}")
    return res


def record_kernel_calls(torch, pc, run):
    """The kernel calls `run()` makes, with their shapes and flags."""
    calls = []
    orig = {n: getattr(pc, n) for n in pc.LAUNCHES}

    def rec1(x, w, b, scale=None, shift=None, add=None, relu=False,
             emit_u=False, stats=True):
        calls.append(("fused_conv1x1", (x.shape[0], x.shape[1], w.shape[1]),
                      x.dtype, scale is not None, add is not None,
                      bool(relu), bool(emit_u), bool(stats)))
        return orig["fused_conv1x1"](x, w, b, scale, shift, add, relu,
                                     emit_u, stats)

    def rec3(x, w, b, scale=None, shift=None, relu=False, stats=True):
        calls.append(("fused_conv3x3", tuple(x.shape) + (w.shape[-1],),
                      x.dtype, scale is not None, False, bool(relu), False,
                      bool(stats)))
        return orig["fused_conv3x3"](x, w, b, scale, shift, relu, stats)

    def x2_mode(x2, scale2):
        return None if x2 is None else ("plain" if scale2 is None
                                        else "affine")

    def recd(dy, y, w, x, x2=None, du_out=None, scale=None, shift=None,
             scale2=None, shift2=None, dssum=None, dssq=None, relu=False):
        calls.append(("dgrad_conv1x1", (x.shape[0], x.shape[1], w.shape[1]),
                      x.dtype, scale is not None, x2_mode(x2, scale2),
                      du_out is not None, dssum is not None, bool(relu)))
        return orig["dgrad_conv1x1"](dy, y, w, x, x2, du_out, scale, shift,
                                     scale2, shift2, dssum, dssq, relu)

    def recw(dy, y, x, x2=None, scale=None, shift=None, scale2=None,
             shift2=None, dssum=None, dssq=None, relu=False):
        calls.append(("wgrad_conv1x1", (x.shape[0], x.shape[1], dy.shape[1]),
                      x.dtype, scale is not None, x2_mode(x2, scale2),
                      False, dssum is not None, bool(relu)))
        return orig["wgrad_conv1x1"](dy, y, x, x2, scale, shift, scale2,
                                     shift2, dssum, dssq, relu)

    pc.fused_conv1x1, pc.fused_conv3x3 = rec1, rec3
    pc.dgrad_conv1x1, pc.wgrad_conv1x1 = recd, recw
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for n, f in orig.items():
            setattr(pc, n, f)
    return calls


def bound_ms(flops, nbytes, dtype):
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def forward_case(torch, pc, r, key):
    """(FLOPs, bytes, make, kernel, plain, library) of a forward kernel
    call: bytes count each input read once and each output written once;
    the library call is torch.matmul / F.conv2d of x and W."""
    import torch.nn.functional as F

    name, shape, dt, affine, add, relu, emit_u, stats = key
    one_x1 = name == "fused_conv1x1"
    c_in, n = shape[-2], shape[-1]
    x_shape = shape[:2] if one_x1 else shape[:4]
    w_shape = (c_in, n) if one_x1 else (3, 3, c_in, n)
    fan_in = c_in if one_x1 else 9 * c_in
    m = x_shape[0] if one_x1 else shape[0] * shape[1] * shape[2]
    flops = 2.0 * m * n * (c_in if one_x1 else 9 * c_in)
    nbytes = dt.itemsize * (m * c_in + (1 if one_x1 else 9) * c_in * n
                            + m * n + (m * c_in if add else 0)
                            + (m * c_in if emit_u else 0))
    nbytes += 4 * (n + (2 * c_in if affine else 0) + (2 * n if stats else 0))

    def make():
        x, w = r(*x_shape).to(dt), (r(*w_shape) / fan_in ** 0.5).to(dt)
        kw = {"relu": relu, "stats": stats}
        if affine:
            kw["scale"], kw["shift"] = r(c_in) * 0.5 + 1, r(c_in) * 0.1
        if one_x1:
            if add:
                kw["add"] = r(*x_shape).to(dt)
            kw["emit_u"] = emit_u
        return x, w, r(n) * 0.1, kw

    kern_f = pc.fused_conv1x1 if one_x1 else pc.fused_conv3x3
    plain_f = pc.ref_fused_conv1x1 if one_x1 else pc.ref_fused_conv3x3
    if one_x1:
        lib = lambda a: torch.matmul(a[0], a[1])
    else:
        lib = lambda a: F.conv2d(a[4], a[5], padding=1)

    def make_all():
        a = make()
        if one_x1:
            return a
        return a + (a[0].permute(0, 3, 1, 2), a[1].permute(3, 2, 0, 1)
                    .contiguous(memory_format=torch.channels_last))

    return (flops, nbytes, make_all,
            lambda a: kern_f(*a[:3], **a[3]),
            lambda a: plain_f(*a[:3], **a[3]), lib)


def backward_case(torch, pc, r, key):
    """As forward_case for dgrad/wgrad; the library calls are
    torch.matmul(ybar, W^T) and torch.matmul(u^T, ybar) on inputs that
    stand for ybar and u."""
    name, (m, k, n), dt, affine, x2, duo, stats, relu = key
    gen = torch.Generator(device=DEV).manual_seed(4)
    two, aff2 = x2 is not None, x2 == "affine"
    flops = 2.0 * m * k * n
    vec = 4 * ((2 * k if affine else 0) + (2 * k if aff2 else 0)
               + (2 * n if stats else 0))
    if name == "dgrad_conv1x1":
        # x (x2) is read only for the relu mask or its ds1 (ds2); dx1 and
        # dx2 are written; dt exists when either branch has an affine
        reads_x, reads_x2 = relu or affine, two and (relu or aff2)
        nbytes = dt.itemsize * (m * n * (2 if stats else 1) + k * n
                                + m * k * (reads_x + 1 + reads_x2 + two
                                           + duo))
        nbytes += vec + 4 * (n + k * (affine + aff2 + (affine or aff2)))
    else:
        nbytes = dt.itemsize * (m * n * (2 if stats else 1)
                                + m * k * (1 + two)) + 4 * k * n + vec

    def make():
        kw = backward_args(backward_inputs(torch, gen, dt, m, k, n), affine,
                           x2, duo, stats, relu)
        return kw if name == "dgrad_conv1x1" else wgrad_args(kw)

    kern_f, plain_f = getattr(pc, name), getattr(pc, "ref_" + name)
    if name == "dgrad_conv1x1":
        lib = lambda a: torch.matmul(a["dy"], a["w"].t())
    else:
        lib = lambda a: torch.matmul(a["x"].t(), a["dy"])
    return (flops, nbytes, make, lambda a: kern_f(**a),
            lambda a: plain_f(**a), lib)


def timing_phase(torch, pc, calls):
    gen = torch.Generator(device=DEV).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    groups = {}
    for c in calls:
        groups[c] = groups.get(c, 0) + 1
    tot = {}
    rows = []
    for key, count in groups.items():
        name, shape, dt = key[:3]
        dtype = str(dt).replace("torch.", "")
        case = forward_case if name.startswith("fused") else backward_case
        flops, nbytes, make, kern_f, plain_f, lib_f = case(torch, pc, r, key)
        ins = [make() for _ in range(copies_for(nbytes))]
        pc.reset_launch_counts()
        ms, p_ms, l_ms = (time_ms(torch, [lambda a=a: f(a) for a in ins])
                          for f in (kern_f, plain_f, lib_f))
        route = launched_routes(pc).get(name, "cuda")
        del ins
        bms, by = bound_ms(flops, nbytes, dtype)
        row = {"name": name, "shape": list(shape), "dtype": dtype,
               "flags": [str(v) for v in key[3:]], "count": count,
               "route": route, "input_copies": copies_for(nbytes), "ms": ms,
               "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bms,
               "bound_by": by, "x_bound": ms / bms}
        rows.append(row)
        log("timing " + json.dumps(row))
        t = tot.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                  "library_ms": 0.0, "bound_ms": 0.0,
                                  "bytes_ms": 0.0, "ops_ms": 0.0})
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            t[k] += count * row[k]
        t["bytes_ms" if by == "bytes" else "ops_ms"] += count * bms
    return tot, rows


# ------------------------------------------------------------------ main


def main():
    # a crash inside a native library still prints every thread's stack
    faulthandler.enable(all_threads=True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--nccl-gang", type=int, default=0, metavar="N",
                    help="run only the N-card NCCL gang check (needs N "
                         "cards) and exit")
    ap.add_argument("--gang-logs", default=None, metavar="DIR",
                    help="keep every gang rank's whole log under DIR")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 5h's Keras weights and data and of "
                         "phase 5i's requests and GPT-2-width weights")
    # one rank of phase 5n's gang (the script launches them itself)
    ap.add_argument("--mesh-rank", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=2,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-io", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    global GANG_LOG_DIR
    GANG_LOG_DIR = args.gang_logs
    if args.mesh_rank >= 0:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        mesh_rank_main(args.mesh_rank, args.mesh_world, args.mesh_port,
                       args.mesh_io)
        return

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from deeplearning4j_tpu_torch.nn.helpers import kernel_build
        from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as pc
        from deeplearning4j_tpu_torch.zoo.models import ResNet50
    except ImportError as e:
        fail(f"the port package deeplearning4j_tpu_torch is not beside "
             f"this script: {e}")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    if args.nccl_gang:
        if torch.cuda.device_count() < args.nccl_gang:
            fail(f"--nccl-gang {args.nccl_gang} needs that many cards; "
                 f"{torch.cuda.device_count()} visible")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        nccl_gang(torch, np, card, args.nccl_gang)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    # 2. build
    t0 = time.perf_counter()
    built = kernel_build.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s ({built})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    worst = kernel_phase(torch, pc, BATCH)
    # the train step's forward calls: bf16, with statistics
    for name, v in kernel_phase(torch, pc, TRAIN_BATCH,
                                dtypes=("bfloat16",)).items():
        worst[name] = max(worst[name], v)
    worst.update(backward_kernel_phase(torch, pc, TRAIN_BATCH))
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    # 4. serving the main path
    t0 = time.perf_counter()
    net = ResNet50(input_shape=(HW, HW, 3), compute_dtype="bfloat16",
                   helpers="pallas").init_model(device=DEV)
    randomize_batchnorm(torch, net, seed=1)
    log(f"model: ResNet-50, {net.num_params()} params, bf16 policy, "
        f"helpers=pallas ({time.perf_counter() - t0:.1f} s to build)")
    serving = serving_phase(torch, np, pc, net)
    reference = reference_check(torch, np, net)
    fwd = forward_times(torch, net, BATCH)
    calls = record_kernel_calls(torch, pc, lambda: net.output(
        torch.zeros(BATCH, HW, HW, 3)))

    # 5. training: the step check, then the training run
    t0 = time.perf_counter()
    step = step_check(torch, np, pc, net)
    del net
    train, train_net, train_x = training_run(torch, np, pc, ResNet50)
    log(f"training phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    y = labels_for(torch, torch.Generator().manual_seed(32), TRAIN_BATCH,
                   train_net.conf.node("output").obj.n_out)
    train_calls = record_kernel_calls(
        torch, pc, lambda: train_net.fit_batch(([train_x], [y])))
    del train_net
    torch.cuda.empty_cache()

    # 5b. the training engine: StepProgram.run / run_group (a CUDA graph
    # of GROUP_K captured train steps) and EarlyStoppingTrainer
    engine = engine_phase(torch, np, pc, ResNet50, card)
    log(f"engine phase: {time.perf_counter() - t0:.1f} s")

    # 5c. MultiLayerNetwork: VGG16 serving and training (eager and one
    # CUDA-graph replay of GROUP_K steps, dropout on), the dropout checks,
    # AlexNet
    t0 = time.perf_counter()
    mln = mln_phase(torch, np, pc, card)
    log(f"mln phase: {time.perf_counter() - t0:.1f} s")

    # 5d. TrainingMaster (timed at k=GROUP_K and k=1, checkpoints, resume,
    # torn write, guard), ParallelWrapper and EarlyStoppingParallelTrainer
    t0 = time.perf_counter()
    tm = tm_phase(torch, np, pc, ResNet50, card,
                  engine["pallas"]["group"]["ms_per_step"],
                  engine["group_check"]["deterministic"])
    log(f"tm phase: {time.perf_counter() - t0:.1f} s")

    # 5e. observability on the flagship: every hook on against every hook
    # off, the cost model, the watchdog drill, traced serving, stats
    t0 = time.perf_counter()
    obs = obs_phase(torch, np, pc, ResNet50, card,
                    engine["group_check"]["deterministic"])
    log(f"obs phase: {time.perf_counter() - t0:.1f} s")

    # 5f. recurrent networks: TextGenerationLSTM trained (TBPTT) and
    # generating, the cuDNN yardstick, the recurrent golden graph
    t0 = time.perf_counter()
    rnn = rnn_phase(torch, np, pc, card)
    log(f"rnn phase: {time.perf_counter() - t0:.1f} s")

    # 5g. the graph zoo (GoogLeNet, InceptionResNetV1, FaceNetNN4Small2),
    # ModelSelector, transfer learning (ResNet-50, VGG16), the line-search
    # solvers and layerwise pretraining
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        zoo = zoo_phase(torch, np, pc, card, engine, tmp)
    for name, v in zoo["worst"].items():
        worst[name] = max(worst[name], v)
    log(f"zoo phase: {time.perf_counter() - t0:.1f} s")

    # 5h. Keras import (the seven fixtures, canonical VGG16 with its two
    # config-4 steps, Keras ResNet50 through the kernels), the native CSV
    # path and LeNet on the MNIST stand-in
    t0 = time.perf_counter()
    keras = keras_phase(torch, np, pc, card, args.seed, engine)
    for name, v in keras["worst"].items():
        worst[name] = max(worst[name], v)
    log(f"keras phase: {time.perf_counter() - t0:.1f} s")

    # 5i. the decode-serving path: bench_decode's configuration (naive
    # against the continuous engine, the journal), the paged drills, and
    # GPT-2-small width
    t0 = time.perf_counter()
    decode = decode_phase(torch, np, pc, card, args.seed)
    decode_oracle = decode.pop("bench_tokens")
    log(f"decode phase: {time.perf_counter() - t0:.1f} s")

    # 5j. the serving control plane: ModelServer on both wires at phase
    # 4's width, the hot swap, tenant admission at 2x capacity, a
    # three-replica fleet, decode over HTTP
    t0 = time.perf_counter()
    control = control_phase(torch, np, pc, card, args.seed, serving,
                            decode, decode_oracle)
    log(f"control phase: {time.perf_counter() - t0:.1f} s")

    # 5k. cluster supervision of the flagship (the unfaulted oracle, a
    # wedge inside a CUDA wait escalated by the watchdog's hard exit and
    # found stale by the supervisor) and clustering (t-SNE's two tiers,
    # k-means, the nearest-neighbour server, the dashboard's t-SNE tab)
    t0 = time.perf_counter()
    cluster = cluster_phase(torch, np, card,
                            engine["group_check"]["deterministic"],
                            tm["k4"]["ms_per_step"])
    log(f"cluster phase (a): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    clustering = clustering_phase(torch, np, card)
    log(f"clustering phase (b)-(f): {time.perf_counter() - t1:.1f} s; "
        f"phase 5k: {time.perf_counter() - t0:.1f} s")

    # 5l. the embedding trainers and graph embeddings: word2vec at
    # bench.py:468's configuration, CBOW + HS at width 300, the card
    # against the CPU, the two-topic quality bars, DeepWalk and Node2Vec
    # at BlogCatalog's scale
    t0 = time.perf_counter()
    nlp = nlp_phase(torch, np, pc, card)
    log(f"nlp phase: {time.perf_counter() - t0:.1f} s")

    # 5m. data-parallel scale-out and ZeRO-1: the flagship at world 1 over
    # NCCL (ZeRO-1 against run_group, local SGD, the stale trainer), the
    # tests' 2-rank gloo gang on the card, the DCN model on its numbers
    t0 = time.perf_counter()
    scaleout = scaleout_phase(torch, np, pc, ResNet50, card,
                              engine["group_check"]["deterministic"])
    log(f"scaleout phase: {time.perf_counter() - t0:.1f} s")

    # 5n. tensor and sequence parallelism on a 2-rank gloo gang on the
    # card (ring attention, tp VGG16, DistributedSequenceVectors) and the
    # SIGKILL gang drill
    t0 = time.perf_counter()
    mesh = mesh_phase(torch, np, pc, card, nlp["bench"]["words_per_s"])
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")

    # 5o. the analyzer: the AST passes, the program lint of full-width
    # records on the card, serving under the lock-order sanitizer
    t0 = time.perf_counter()
    analysis = analysis_phase(torch, np, pc, ResNet50, card)
    log(f"analysis phase: {time.perf_counter() - t0:.1f} s")

    # 6. timing of the kernel calls of a batch-32 forward and of a
    # batch-128 train step
    t0 = time.perf_counter()
    for what, cs in (("forward at batch %d" % BATCH, calls),
                     ("train step at batch %d" % TRAIN_BATCH, train_calls)):
        per_kernel = {}
        for c in cs:
            per_kernel[c[0]] = per_kernel.get(c[0], 0) + 1
        log(f"main path, {what}: kernel calls {per_kernel}")
    totals, rows = timing_phase(torch, pc, calls)
    train_totals, train_rows = timing_phase(torch, pc, train_calls)
    for what, tots in ((f"forward at batch {BATCH}", totals),
                       (f"train step at batch {TRAIN_BATCH}", train_totals)):
        for name, t in tots.items():
            log(f"{what}, {name} summed over its calls: {t['ms']:.3f} ms "
                f"(bound {t['bound_ms']:.3f} ms, "
                f"{t['ms'] / t['bound_ms']:.1f}x; plain {t['plain_ms']:.3f} "
                f"ms; library {t['library_ms']:.3f} ms)")
    log(f"timing phases: {time.perf_counter() - t0:.1f} s")

    src = "deeplearning4j_tpu_torch/csrc/"
    tpu = "deeplearning4j_tpu/nn/helpers/pallas_conv.py:"
    # forward kernels: launches from the serving run, times summed over a
    # batch-32 forward; backward kernels: launches from the "pallas"
    # training run, times summed over a batch-128 train step
    sources = {"fused_conv1x1": ("fused_conv1x1.cu", "95",
                                 serving["launches"], totals),
               "fused_conv3x3": ("fused_conv3x3.cu", "221",
                                 serving["launches"], totals),
               "dgrad_conv1x1": ("dgrad_conv1x1.cu", "361",
                                 train["pallas"]["launches"], train_totals),
               "wgrad_conv1x1": ("wgrad_conv1x1.cu", "469",
                                 train["pallas"]["launches"], train_totals)}
    kernels = []
    for name, (file, line, launches, tots) in sources.items():
        t = tots[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + file,
            "replaces": tpu + line,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "library_ms": t["library_ms"],
            "tm_launches": tm["k4"]["launches"][name],
            "tm_launches_per_replay": tm["k4"]["launches_per_replay"][name],
            "obs_launches": obs["fit"]["launches"][name],
            "rnn_launches": rnn["launches"][name],
            "zoo_launches": zoo["zoo_launches"][name],
            "zoo_launches_by_route": {
                r: zoo["zoo_launches"][f"{name}/{r}"]
                for r in ("wgmma", "simple")},
            "tl_launches": zoo["tl_launches"][name],
            "keras_launches": keras["launches"][name],
            "keras_launches_by_route": {
                r: keras["launches"][f"{name}/{r}"]
                for r in ("wgmma", "simple")},
            "decode_launches": decode["launches"][name],
            "control_launches": control["launches"][name],
            "control_launches_by_route": control["launches_by_route"].get(
                name, {"wgmma": 0, "simple": 0}),
            "cluster_launches": cluster["launches"][name],
            "nlp_launches": nlp["launches"][name],
            "scaleout_launches": scaleout["launches"][name],
            "mesh_launches": mesh["launches"][name],
            "analysis_launches": analysis["launches"][name],
        })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "batch": BATCH,
                       "train_batch": TRAIN_BATCH, "kernels": kernels,
                       "timing_rows": rows, "train_timing_rows": train_rows,
                       "train_step_totals": train_totals,
                       "serving": serving, "reference": reference,
                       "forward_ms": fwd, "step_check": step,
                       "train": train, "engine": engine, "mln": mln,
                       "tm": tm, "obs": obs, "rnn": rnn, "zoo": zoo,
                       "keras": keras, "decode": decode,
                       "control": control, "cluster": cluster,
                       "clustering": clustering, "nlp": nlp,
                       "scaleout": scaleout, "mesh": mesh,
                       "analysis": analysis},
                      f, indent=1,
                      default=str)
    log("note: kernels[].ms/plain_ms/library_ms/bound_ms are sums over the "
        f"kernel calls of one batch-{BATCH} forward (fused_conv*) or of one "
        f"batch-{TRAIN_BATCH} train step (dgrad/wgrad); launches are from "
        f"the serving run (fused_conv*) and the {TRAIN_STEPS}-step "
        "training run (dgrad/wgrad); tm_launches from the "
        f"{TM_STEPS}-step TrainingMaster fit at steps_per_dispatch="
        f"{GROUP_K}, tm_launches_per_replay from one of its replays, "
        f"obs_launches from phase 5e's two hooks-on fits ({2 * OBS_STEPS} "
        "steps), rnn_launches from phase 5f (the recurrent path), "
        f"zoo_launches from phase 5g's timed \"pallas\" steps of GoogLeNet "
        f"({ZOO_STEPS}), InceptionResNetV1 and FaceNetNN4Small2 "
        f"({ZOO_SMALL_STEPS} each), tl_launches from its {TL_STEPS} "
        "ResNet-50 transfer steps, keras_launches from phase 5h's "
        f"{KERAS_RESNET_STEPS} timed Keras ResNet50 steps, decode_launches "
        "from phase 5i (the decode-serving path), control_launches from "
        "phase 5j's two measured ModelServer windows and "
        "control_launches_by_route from those and its hot-swap drill, "
        "cluster_launches from phase 5k's supervised worker fits (the "
        f"oracle's {CLUSTER_STEPS} steps and each drill's relaunched "
        f"{CLUSTER_STEPS - 2 * GROUP_K}; counted in the worker processes), "
        "nlp_launches from phase 5l (the embedding trainers and graph "
        "embeddings), scaleout_launches from phase 5m's timed "
        f"{SCALEOUT_STEPS}-step ZeRO-1 TrainingMaster fit at "
        f"steps_per_dispatch={GROUP_K} (world 1, NCCL), mesh_launches from "
        "phase 5n (ring attention, tp VGG16 and the distributed embedding "
        "fit, counted in the gang's ranks too), analysis_launches from "
        "phase 5o (the flagship's capture and its linted records, the "
        "linted serving forward, the sanitized serving window)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
