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
import subprocess
import sys
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


def randomize_batchnorm(torch, net, seed):
    """Seeded random gamma/beta, and running statistics near the real
    per-channel statistics of each conv output on a seeded batch (so the
    network's activations stay at a realistic scale), scaled/offset by
    seeded noise (var > 0): the affine prologues are not the identity.
    The output layer is rescaled so the logits have unit spread."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import BatchNormalization

    gen = torch.Generator().manual_seed(seed)
    bn_nodes = [n for n in net.topo if n.kind == "layer"
                and isinstance(n.obj, BatchNormalization)]
    params = {k: dict(v) for k, v in net.params.items()}
    for node in bn_nodes:
        c = params[node.name]["gamma"].shape[0]
        # the last BN of each residual branch gets a small gamma, as in
        # trained ResNets: blocks stay near the identity, so the random
        # network does not amplify rounding differences layer by layer
        g0 = 0.2 if node.name.endswith("_c_bn") else 1.0
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
    x = torch.randn(8, HW, HW, 3, generator=gen).to(DEV)
    acts = twin.feed_forward(x)
    # output layer scaled so the logits have unit spread: softmax then is
    # not saturated and a comparison of probabilities means something
    out_name = net.conf.network_outputs[0]
    feats = acts[net.conf.node(out_name).inputs[0]].float()
    logits = feats @ params[out_name]["W"] + params[out_name]["b"]
    params[out_name] = {"W": params[out_name]["W"] / float(logits.std()),
                        "b": params[out_name]["b"]}
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


def serving_inputs(np, rng, rows):
    """Seeded images; each row gets its own brightness and contrast, so
    distinct rows give distinct outputs."""
    loc = rng.uniform(-1.0, 1.0, size=(rows, 1, 1, 1))
    scale = rng.uniform(0.5, 2.0, size=(rows, 1, 1, 1))
    return (loc + scale * rng.normal(size=(rows, HW, HW, 3))).astype(
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
                                      int(args[10] is not None))
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
    """torch.profiler over PROFILE_STEPS train steps: the device's busy
    time per step (the sum of the kernels' device times; the port runs on
    one stream, so kernels do not overlap) and the kernels that take the
    most device time. The profiler stretches the host's side of a step,
    so the idle share is taken against an unprofiled step's time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
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
    return {"profiled_wall_ms": wall * 1e3 / PROFILE_STEPS,
            "busy_ms": sum(dev(e) for e in kernels) / 1e3 / PROFILE_STEPS,
            "top": [(e.key[:60], dev(e) / 1e3 / PROFILE_STEPS) for e in top]}


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

    # 6. timing of the kernel calls of a batch-32 forward and of a
    # batch-128 train step
    t0 = time.perf_counter()
    y = labels_for(torch, torch.Generator().manual_seed(32), TRAIN_BATCH,
                   train_net.conf.node("output").obj.n_out)
    train_calls = record_kernel_calls(
        torch, pc, lambda: train_net.fit_batch(([train_x], [y])))
    del train_net
    torch.cuda.empty_cache()
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
                       "train": train}, f, indent=1)
    log("note: kernels[].ms/plain_ms/library_ms/bound_ms are sums over the "
        f"kernel calls of one batch-{BATCH} forward (fused_conv*) or of one "
        f"batch-{TRAIN_BATCH} train step (dgrad/wgrad); launches are from "
        f"the serving run (fused_conv*) and the {TRAIN_STEPS}-step "
        "training run (dgrad/wgrad)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
