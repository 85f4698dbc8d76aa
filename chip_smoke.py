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
     and their ratio (fails above OBS_RATIO_MAX), the phase shares and
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
     under SERVE_THREADS clients (a profiler window); the Chrome trace
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
  6. timing: every kernel call of one batch-32 forward and of one
     batch-128 train step, timed on the card (kernel, plain version, one
     library call) beside its bound and the ratio of the two, with the
     backward calls' route, each call reading its inputs from device
     memory, not from L2;
  7. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the port package beside it, it exits non-zero and
prints no result.
"""

import argparse
import json
import os
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
TRAIN_STEPS = 20
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
ENGINE_STEPS = 20              # timed steps: 20 run() calls, 5 replays
ENGINE_PROFILE_STEPS = 4       # steps under torch.profiler, after those
ES_BATCHES = 4                 # EarlyStoppingTrainer: batches per epoch
ES_EPOCHS = 3
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
MLN_STEPS = 20                 # timed steps: 20 run() calls, 5 replays
MLN_PROFILE_STEPS = 4
MLN_CHECK_BATCH = 8            # the dropout checks
MLN_SERVE_SIZES = (1, 3, 8, 16, 32, 5)
ALEXNET_STEPS = 8
# phase 5d, TrainingMaster and ParallelWrapper on the flagship
TM_DATA = 4                    # seeded host batches a batch_fn cycles through
TM_STEPS = 20                  # timed steps at steps_per_dispatch=GROUP_K
TM_K1_STEPS = 8                # timed steps at steps_per_dispatch=1
TM_PROFILE_STEPS = 8           # profiled steps after a timed fit
TM_CHECK_BATCH = 32            # the resume, torn-write and guard checks
TM_CKPT_REPEATS = 2            # timed saves and restores of one checkpoint
PW_BATCHES = 8                 # ParallelWrapper's bitwise check
ES_PARALLEL_EPOCHS = 2
# phase 5f, recurrent networks: the zoo's TextGenerationLSTM at
# bench.py:196 bench_lstm's configuration
RNN_VOCAB = 98
RNN_SEQ = 256
RNN_BATCHES = (64, 2048)       # bench_lstm's default; the README's batch
RNN_REMAT_BATCH = 2048         # bench.py lstm 2048 remat
RNN_FOLLOW = 0.9               # share of characters that follow the rule
RNN_WARMUP = 1                 # fit_batch calls before the timed ones
RNN_STEPS = 3                  # timed fit_batch calls (6 chunks each)
RNN_CHUNK_CALLS = 4            # timed calls of one 50-step chunk's step
RNN_PROMPT = 32                # greedy generation at batch 64
RNN_GENERATE = 256
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
OBS_RATIO_MAX = 1.10           # hooks-on / hooks-off ms per step
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
OBS_REQUESTS = 50              # sequential mixed-size served requests
OBS_SERVE_SIZES = (1, 3, 8, 16, 32, 5, 40)
OBS_IDLE_S = 3.0               # the serving idle-share window
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
ZOO_STEPS = 20                 # GoogLeNet: timed steps, 5 replays
ZOO_SMALL_STEPS = 8            # InceptionResNetV1, FaceNetNN4Small2
ZOO_CHECK_BATCH = 32           # the routed-backward and replay checks
ZOO_PROFILE_STEPS = 4
TL_STEPS = 20                  # ResNet-50 transfer: timed steps
VGG_TL_BATCH = 32              # bench.py:506 bench_vgg16's batch
VGG_TL_STEPS = 8
VGG_TL_CLASSES = 100           # the replaced head's width
SOLVER_BATCH = 128
SOLVER_ITERS = 10
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
KERAS_RESNET_STEPS = 20
# the bf16 "pallas" forward against "fused", max |log p - log p_ref|, of
# the imported ResNet50 (its f32 limit is ZOO_LOGP_TOL's): the first chip
# reading was 0.169 (f32 1.9e-5; PERF.md, phase 5h), margin 3x
KERAS_RESNET_BF16_LOGP_TOL = 0.5
CSV_ROWS = 1_000_000
CSV_COLS = 11
CSV_BATCH = 4096
LENET_BATCH = 64
LENET_STEPS = 20
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


def serving_phase(torch, np, pc, net):
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

    rng = np.random.default_rng(7)
    pool = [serving_inputs(np, rng, s) for s in SERVE_SIZES
            for _ in range(POOL_PER_SIZE)]
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


def obs_fits(torch, np, pc, ResNet50, tr, storage):
    """The flagship through TrainingMaster(steps_per_dispatch=GROUP_K,
    pipeline_depth=OBS_PIPELINE_DEPTH) at TRAIN_BATCH from one seeded
    state, every hook on (obs_hooks, the fit run by its Supervisor) and
    every hook off: a warm-up fit of OBS_STEPS steps each (the capture;
    StatsListener's first collection, whose one-off device allocations
    took ~0.22 s), then two timed fits of OBS_STEPS steps per arm in the
    order off, on, on, off (host clock, a sync at each end); the
    launches of the hooks-on fits counted from 0; the CostModel's FLOPs
    of the captured group (register_perf) against the same fits' time."""
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
        t0 = time.perf_counter()
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
    output; then SERVE_THREADS closed-loop clients for OBS_IDLE_S under
    torch.profiler: the device's idle share while serving."""
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

        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        time.sleep(0.5)   # the clients' first round, outside the window
        prof = engine_profile(torch, lambda: time.sleep(OBS_IDLE_S), 1)
        stop.set()
        for t in threads:
            t.join()
    finally:
        pi.shutdown()
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
    busy_s = None if prof["busy_ms"] is None else prof["busy_ms"] / 1e3
    r = {"requests": OBS_REQUESTS, "chains": chains,
         "batches_expected": sum(-(-n // 32) for n in sizes),
         "splits_expected": sum(1 for n in sizes if n > 32),
         "rows": sum(sizes), "concurrent_served": served[0],
         "idle_share": (None if busy_s is None
                        else 1.0 - busy_s / (prof["profiled_wall_ms"] / 1e3)),
         "busy_s": busy_s, "window_s": prof["profiled_wall_ms"] / 1e3}
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
        f"{r['off_ms_per_step']:.2f} ms/step: ratio {r['ratio']:.4f} (the "
        f"JAX package's bar for its telemetry: < 1.02; this run's limit "
        f"{OBS_RATIO_MAX}); phase shares {shares}, coverage "
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
    if r["ratio"] > OBS_RATIO_MAX:
        problems.append(f"hooks-on/off ratio {r['ratio']:.4f}")
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
        "under the profiler: "
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


# ------------------------------------------------------------ phase 6


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 5h's Keras weights and data")
    args = ap.parse_args()

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
                       "keras": keras},
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
        f"{KERAS_RESNET_STEPS} timed Keras ResNet50 steps")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
