#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ with nvcc (sm_90a);
  3. kernel phase: each kernel against its plain PyTorch version at every
     distinct ResNet-50 shape, bf16 and f32, every prologue variant;
  4. serving phase: full-width ResNet-50 (224x224x3, 1000 classes, bf16,
     helpers="pallas", seeded random weights and BatchNorm statistics)
     behind ParallelInference(batch_limit=32): after a warm-up round,
     SERVE_THREADS closed-loop clients send mixed-size requests for
     SERVE_S seconds (hundreds of requests); throughput over the whole
     window, latency percentiles over every request; every response
     checked against a direct `net.output` on the same rows; the kernel
     launch counters must move by 30 (1x1) and 16 (3x3) per forward; the
     kernel path checked against the torch reference path;
  5. timing: every kernel call of one batch-32 forward, timed on the card
     (kernel, plain version, one library call) beside its bound, each
     call reading its inputs from device memory, not from L2;
  6. a `kernels` JSON line, then the last line
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
BATCH = 32                     # kernel-phase shapes and timings
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


def kernel_phase(torch, pc, batch):
    gen = torch.Generator(device=DEV).manual_seed(0)
    worst = {}
    for dtype in ("bfloat16", "float32"):
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
                got = kern(x, w, b, **kw)
                ref = plain(x, w, b, **kw)
                # the main path asks for no statistics: same y, no ssum/ssq
                bare = kern(x, w, b, **kw, stats=False)
                torch.cuda.synchronize()
                errs = {"y": norm_err(got[0], ref[0]),
                        "ssum": norm_err(got[1], ref[1]),
                        "ssq": norm_err(got[2], ref[2])}
                if kind == "1x1" and kw.get("emit_u"):
                    errs["u"] = norm_err(got[3], ref[3])
                abs_y = float((got[0].float() - ref[0].float()).abs().max())
                worst[name] = max(worst.get(name, 0.0), abs_y)
                ok = all(e <= tol for e in errs.values()) and bool(
                    torch.isfinite(got[0]).all()) and torch.equal(
                    bare[0], got[0]) and bare[1] is None
                log(f"check {name} {dtype} {kind} {h}x{h} K={k} N={n} "
                    f"{variant}: " + " ".join(
                        f"{key}={v:.2e}" for key, v in errs.items())
                    + f" max_abs_y={abs_y:.3e} tol={tol:g} "
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    fail(f"{name} disagrees with its plain version "
                         f"({dtype}, {kind} {h}x{h} K={k} N={n} {variant})")
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
    log(f"serving: launches {counts} over {forwards} forwards")
    if forwards <= 0 or counts["fused_conv1x1"] != 30 * forwards or \
            counts["fused_conv3x3"] != 16 * forwards:
        fail(f"launch counts {counts} != 30/16 per forward x {forwards}")

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


def record_main_path_calls(torch, pc, net, batch):
    """The kernel calls one batch-`batch` forward makes, with their flags."""
    calls = []
    orig1, orig3 = pc.fused_conv1x1, pc.fused_conv3x3

    def rec1(x, w, b, scale=None, shift=None, add=None, relu=False,
             emit_u=False, stats=True):
        calls.append(("fused_conv1x1", (x.shape[0], x.shape[1], w.shape[1]),
                      x.dtype, scale is not None, add is not None,
                      bool(relu), bool(emit_u), bool(stats)))
        return orig1(x, w, b, scale, shift, add, relu, emit_u, stats)

    def rec3(x, w, b, scale=None, shift=None, relu=False, stats=True):
        calls.append(("fused_conv3x3", tuple(x.shape) + (w.shape[-1],),
                      x.dtype, scale is not None, False, bool(relu), False,
                      bool(stats)))
        return orig3(x, w, b, scale, shift, relu, stats)

    pc.fused_conv1x1, pc.fused_conv3x3 = rec1, rec3
    try:
        x = torch.zeros(batch, HW, HW, 3)
        net.output(x)
        torch.cuda.synchronize()
    finally:
        pc.fused_conv1x1, pc.fused_conv3x3 = orig1, orig3
    return calls


def work(name, shape, dtype_bytes, affine, add, emit_u, stats):
    """(FLOPs, bytes) of one call: each input read once, each output
    written once."""
    if name == "fused_conv1x1":
        m, k, n = shape
        flops = 2.0 * m * k * n
        nbytes = dtype_bytes * (m * k + k * n + m * n
                                + (m * k if add else 0)
                                + (m * k if emit_u else 0))
    else:
        bsz, h, w, k, n = shape
        m = bsz * h * w
        flops = 2.0 * m * 9 * k * n
        nbytes = dtype_bytes * (m * k + 9 * k * n + m * n)
    nbytes += 4 * (n + (2 * k if affine else 0) + (2 * n if stats else 0))
    return flops, nbytes


def bound_ms(flops, nbytes, dtype):
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing_phase(torch, pc, calls):
    import torch.nn.functional as F

    gen = torch.Generator(device=DEV).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    groups = {}
    for c in calls:
        groups[c] = groups.get(c, 0) + 1
    tot = {}
    rows = []
    for key, count in groups.items():
        name, shape, dt, affine, add, relu, emit_u, stats = key
        dtype = str(dt).replace("torch.", "")
        one_x1 = name == "fused_conv1x1"
        c_in, n = shape[-2], shape[-1]
        x_shape = shape[:2] if one_x1 else shape[:4]
        w_shape = (c_in, n) if one_x1 else (3, 3, c_in, n)
        fan_in = c_in if one_x1 else 9 * c_in

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

        flops, nbytes = work(name, shape, dt.itemsize, affine, add, emit_u,
                             stats)
        ins = [make() for _ in range(copies_for(nbytes))]
        kern_f = pc.fused_conv1x1 if one_x1 else pc.fused_conv3x3
        plain_f = pc.ref_fused_conv1x1 if one_x1 else pc.ref_fused_conv3x3
        kern = [lambda a=a: kern_f(*a[:3], **a[3]) for a in ins]
        plain = [lambda a=a: plain_f(*a[:3], **a[3]) for a in ins]
        if one_x1:
            lib = [lambda a=a: torch.matmul(a[0], a[1]) for a in ins]
        else:
            lib_ins = [(a[0].permute(0, 3, 1, 2),
                        a[1].permute(3, 2, 0, 1).contiguous(
                            memory_format=torch.channels_last)) for a in ins]
            lib = [lambda a=a: F.conv2d(a[0], a[1], padding=1)
                   for a in lib_ins]
        ms, p_ms, l_ms = (time_ms(torch, kern), time_ms(torch, plain),
                          time_ms(torch, lib))
        bms, by = bound_ms(flops, nbytes, dtype)
        row = {"name": name, "shape": list(shape), "dtype": dtype,
               "affine": affine, "add": add, "relu": relu, "emit_u": emit_u,
               "stats": stats, "count": count, "input_copies": len(ins),
               "ms": ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": bms, "bound_by": by}
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

    # 5. timing of the main path's kernel calls
    calls = record_main_path_calls(torch, pc, net, BATCH)
    per_kernel = {}
    for c in calls:
        per_kernel[c[0]] = per_kernel.get(c[0], 0) + 1
    log(f"main path at batch {BATCH}: kernel calls {per_kernel}")
    totals, rows = timing_phase(torch, pc, calls)

    sources = {"fused_conv1x1": ("deeplearning4j_tpu_torch/csrc/fused_conv1x1.cu",
                                 "deeplearning4j_tpu/nn/helpers/pallas_conv.py:95"),
               "fused_conv3x3": ("deeplearning4j_tpu_torch/csrc/fused_conv3x3.cu",
                                 "deeplearning4j_tpu/nn/helpers/pallas_conv.py:221")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": serving["launches"][name],
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
            json.dump({"card": card, "batch": BATCH, "kernels": kernels,
                       "timing_rows": rows, "serving": serving,
                       "reference": reference, "forward_ms": fwd}, f,
                      indent=1)
    log("note: kernels[].ms/plain_ms/library_ms/bound_ms are sums over the "
        f"kernel calls of one batch-{BATCH} forward; launches are from "
        "the serving run")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
