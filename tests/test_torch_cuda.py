"""The port's CUDA kernels against their plain PyTorch versions, and the
training engine's CUDA-graph group against eager steps, on the card.
Marked `cuda`; they skip without a CUDA device. This file imports no
jax, so it runs on a GPU host without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as tpc


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def _args_1x1(rng, variant, M, K, N):
    a = {"x": rng.normal(size=(M, K)).astype(np.float32),
         "w": (rng.normal(size=(K, N)) * 0.1).astype(np.float32),
         "b": rng.normal(size=(N,)).astype(np.float32)}
    kw = {}
    if variant in ("affine", "affine_relu", "full"):
        kw["scale"] = (rng.normal(size=(K,)) * 0.5 + 1).astype(np.float32)
        kw["shift"] = (rng.normal(size=(K,)) * 0.1).astype(np.float32)
    if variant in ("affine_relu", "full", "add_only"):
        kw["relu"] = True
    if variant in ("full", "add_only"):
        kw["add"] = rng.normal(size=(M, K)).astype(np.float32)
        kw["emit_u"] = True
    return a, kw


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")


# (M, K, N): 16-byte vector accesses; odd K and N (the kernels' scalar
# fallback); a small grid with a deep K (many chunks per tile); then
# shapes of the bf16 wgmma route: M not a multiple of its row tile with K
# or N at 64 and at 192 (64-wide N tiles), a deep K over few rows, and a
# grid large enough for two warpgroups per block
SHAPES_1X1 = [(200, 72, 136), (77, 13, 9), (100, 1024, 72),
              (1100, 64, 192), (1100, 192, 64), (300, 2048, 512),
              (8500, 256, 512)]
IDS_1X1 = ["vec", "scalar", "deep_k", "ragged_k64_n192", "ragged_k192_n64",
           "deep_k_small_m", "two_warpgroups"]
# the forward route each shape takes in bf16 (f32 always takes "simple")
FWD_ROUTE_1X1 = {"vec": "simple", "scalar": "simple", "deep_k": "simple",
                 "ragged_k64_n192": "wgmma", "ragged_k192_n64": "wgmma",
                 "deep_k_small_m": "wgmma", "two_warpgroups": "wgmma"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES_1X1, ids=IDS_1X1)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "affine", "affine_relu",
                                     "full", "add_only"])
def test_cuda_conv1x1_kernel_matches_plain(rng, variant, dtype, shape):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    a, kw = _args_1x1(rng, variant, *shape)
    cast = lambda v: torch.from_numpy(v).cuda().to(
        dt if v.ndim == 2 else torch.float32)
    cast_kw = {k: (cast(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
    x, w = cast(a["x"]), cast(a["w"])
    b = torch.from_numpy(a["b"]).cuda()
    y, s, q, u = tpc.fused_conv1x1(x, w, b, **cast_kw)
    yr, sr, qr, ur = tpc.ref_fused_conv1x1(x, w, b, **cast_kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, sr, rtol=tol, atol=tol * 10)
    torch.testing.assert_close(q, qr, rtol=tol, atol=tol * 10)
    if kw.get("emit_u"):
        assert torch.equal(u, ur)


# (B, H, C, N), as for SHAPES_1X1; the wgmma route's shapes: the 7x7 and
# 56x56 stages with ragged image counts (one warpgroup tile per image at
# 7x7, one image row per tile at 56x56), C = 64 -> N = 192, and a grid
# large enough for two warpgroups per block
SHAPES_3X3 = [(2, 9, 24, 40), (2, 9, 5, 7), (1, 5, 128, 40),
              (1, 7, 512, 512), (3, 7, 128, 256), (1, 56, 64, 64),
              (3, 56, 64, 128), (2, 14, 64, 192), (10, 56, 64, 64)]
IDS_3X3 = ["vec", "scalar", "deep_k", "img7_b1", "img7_b3", "img56_b1",
           "img56_b3", "c64_n192", "two_warpgroups"]
FWD_ROUTE_3X3 = {"vec": "simple", "scalar": "simple", "deep_k": "simple",
                 "img7_b1": "wgmma", "img7_b3": "wgmma", "img56_b1": "wgmma",
                 "img56_b3": "wgmma", "c64_n192": "wgmma",
                 "two_warpgroups": "wgmma"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES_3X3, ids=IDS_3X3)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [False, True])
def test_cuda_conv3x3_kernel_matches_plain(rng, affine, dtype, shape):
    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    B, H, C, N = shape
    x = torch.from_numpy(rng.normal(size=(B, H, H, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, C, N)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)).cuda()
    kw = {}
    if affine:
        kw["scale"] = torch.from_numpy(
            (rng.normal(size=(C,)) * 0.5 + 1).astype(np.float32)).cuda()
        kw["shift"] = torch.from_numpy(
            (rng.normal(size=(C,)) * 0.1).astype(np.float32)).cuda()
        kw["relu"] = True
    x, w = x.cuda().to(dt), w.cuda().to(dt)
    y, s, q = tpc.fused_conv3x3(x, w, b, **kw)
    yr, sr, qr = tpc.ref_fused_conv3x3(x, w, b, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, sr, rtol=tol, atol=tol * 10)
    torch.testing.assert_close(q, qr, rtol=tol, atol=tol * 10)


def _fwd_inputs(rng, kind, shape, dt=torch.bfloat16, prologue=True):
    """x, w, b and the prologue keywords of one forward call on the card."""
    t = lambda *sz, sc=1.0, off=0.0: torch.from_numpy(
        (rng.normal(size=sz) * sc + off).astype(np.float32)).cuda()
    if kind == "1x1":
        m, k, n = shape
        x, w = t(m, k).to(dt), t(k, n, sc=k ** -0.5).to(dt)
    else:
        bsz, h, k, n = shape
        x, w = t(bsz, h, h, k).to(dt), t(3, 3, k, n, sc=(9 * k) ** -0.5).to(dt)
    kw = {}
    if prologue:
        kw = {"scale": t(k, sc=0.5, off=1.0), "shift": t(k, sc=0.1),
              "relu": True}
        if kind == "1x1":
            kw["add"] = t(*x.shape).to(dt)
            kw["emit_u"] = True
    return x, w, t(n, sc=0.1), kw


def _fwd(kind):
    return tpc.fused_conv1x1 if kind == "1x1" else tpc.fused_conv3x3


# (kind, shape) on either forward route
FWD_CASES = [("1x1", (200, 72, 136)), ("3x3", (2, 9, 24, 40)),
             ("1x1", (1100, 64, 192)), ("1x1", (8500, 256, 512)),
             ("3x3", (3, 7, 128, 256)), ("3x3", (10, 56, 64, 64))]
FWD_IDS = ["1x1_simple", "3x3_simple", "1x1_wgmma", "1x1_wgmma_wgs2",
           "3x3_wgmma", "3x3_wgmma_wgs2"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_cuda_kernels_without_stats_give_the_same_y(rng, case):
    _need_cuda()
    kind, shape = case
    x, w, _, kw = _fwd_inputs(rng, kind, shape, prologue=False)
    f = _fwd(kind)
    with_stats = f(x, w, None)
    without = f(x, w, None, stats=False)
    torch.cuda.synchronize()
    assert torch.equal(with_stats[0], without[0])
    assert without[1] is None and without[2] is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_cuda_forward_kernels_are_bitwise_repeatable(rng, case):
    """Partials and fixed-order reductions, no atomics: y, ssum, ssq (and
    u) are the same bits on every run, on either route."""
    _need_cuda()
    kind, shape = case
    x, w, b, kw = _fwd_inputs(rng, kind, shape)
    first, again = _fwd(kind)(x, w, b, **kw), _fwd(kind)(x, w, b, **kw)
    torch.cuda.synchronize()
    for p, q in zip(first, again):
        assert (p is None and q is None) or torch.equal(p, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [("1x1", s) for s in SHAPES_1X1]
                         + [("3x3", s) for s in SHAPES_3X3],
                         ids=[f"1x1_{i}" for i in IDS_1X1]
                         + [f"3x3_{i}" for i in IDS_3X3])
def test_cuda_forward_route_counter_names_the_kernel_launched(rng, case,
                                                              dtype):
    _need_cuda()
    kind, shape = case
    dt = getattr(torch, dtype)
    routes = FWD_ROUTE_1X1 if kind == "1x1" else FWD_ROUTE_3X3
    shapes, ids = ((SHAPES_1X1, IDS_1X1) if kind == "1x1"
                   else (SHAPES_3X3, IDS_3X3))
    want = routes[ids[shapes.index(shape)]] if dt == torch.bfloat16 \
        else "simple"
    x, w, b, kw = _fwd_inputs(rng, kind, shape, dt)
    name = "fused_conv1x1" if kind == "1x1" else "fused_conv3x3"
    tpc.reset_launch_counts()
    _fwd(kind)(x, w, b, **kw)
    torch.cuda.synchronize()
    assert tpc.FORWARD_ROUTES[name] == {"wgmma": int(want == "wgmma"),
                                        "simple": int(want == "simple")}
    assert tpc.LAUNCHES[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["1x1", "3x3"])
def test_cuda_forward_row_is_the_same_in_a_batch_of_1_and_of_32(rng, kind):
    """The wgmma route picks its tiles' reduction order from K (C) and N
    alone: an image's y (and u) is the same bits whether it is served
    alone or with 31 others, as ParallelInference's buckets need."""
    _need_cuda()
    shape = (32 * 49, 2048, 512) if kind == "1x1" else (32, 7, 512, 512)
    x, w, b, kw = _fwd_inputs(rng, kind, shape)
    rows = 49 if kind == "1x1" else 1
    one_kw = dict(kw, add=kw["add"][:rows].contiguous()) if "add" in kw \
        else kw
    batch = _fwd(kind)(x, w, b, **kw, stats=False)
    one = _fwd(kind)(x[:rows].contiguous(), w, b, **one_kw, stats=False)
    torch.cuda.synchronize()
    assert tpc.forward_route(torch.bfloat16, rows * (1 if kind == "1x1"
                                                     else 49),
                             shape[-2], shape[-1]) == "wgmma"
    assert torch.equal(one[0], batch[0][:rows])
    if kind == "1x1":
        assert torch.equal(one[3], batch[3][:rows])


# (M, K, N) of the 1x1 backward kernels: vector accesses over several
# tiles with M split across blocks in wgrad; odd K and N (scalar loads);
# then shapes of the bf16 wgmma route: M not a multiple of its 128-row
# tile with K or N at 64 and at 192 (not a multiple of 128: 64-wide
# tiles), a deep reduction over few rows (dgrad: 64 chunks), and a wide
# K*N whose M wgrad splits
SHAPES_BWD = [(1100, 72, 136), (77, 13, 9), (1100, 64, 192), (1100, 192, 64),
              (300, 512, 2048), (1100, 512, 2048)]
BWD_IDS = ["vec_split", "scalar", "ragged_k64_n192", "ragged_k192_n64",
           "deep_n", "split_wide"]
# the route each shape takes in bf16 (f32 always takes "simple")
BF16_ROUTE = {"vec_split": "simple", "scalar": "simple",
              "ragged_k64_n192": "wgmma", "ragged_k192_n64": "wgmma",
              "deep_n": "wgmma", "split_wide": "wgmma"}
# (affine, x2: None | "plain" | "affine", du_out, statistics, relu)
BWD_CASES = [(False, None, False, True, False), (True, None, False, True, True),
             (True, "plain", True, True, True),
             (True, "affine", True, False, True),
             (True, "affine", False, True, True)]


def _bwd_args(rng, M, K, N, dt, case):
    affine, x2, duo, stats, relu = case
    t = lambda *s, sc=1.0, off=0.0: torch.from_numpy(
        (rng.normal(size=s) * sc + off).astype(np.float32)).cuda()
    kw = {"dy": t(M, N, sc=0.1).to(dt), "y": t(M, N).to(dt),
          "w": t(K, N, sc=K ** -0.5).to(dt), "x": t(M, K).to(dt),
          "relu": relu}
    if affine:
        kw["scale"], kw["shift"] = t(K, sc=0.5, off=1.0), t(K, sc=0.1)
    if x2 is not None:
        kw["x2"] = t(M, K).to(dt)
    if x2 == "affine":
        kw["scale2"], kw["shift2"] = t(K, sc=0.5, off=1.0), t(K, sc=0.1)
    if duo:
        kw["du_out"] = t(M, K, sc=0.1).to(dt)
    if stats:
        kw["dssum"], kw["dssq"] = t(N, sc=1e-3), t(N, sc=1e-3)
    return kw


def _wgrad_kw(kw):
    return {k: v for k, v in kw.items() if k not in ("w", "du_out")}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES_BWD, ids=BWD_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=["plain", "affine_relu", "x2_duo", "affx2_duo",
                              "affx2_stats"])
def test_cuda_backward_kernels_match_plain(rng, case, dtype, shape):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    kw = _bwd_args(rng, *shape, dt, case)
    got = tpc.dgrad_conv1x1(**kw)
    ref = tpc.ref_dgrad_conv1x1(**kw)
    gw = tpc.wgrad_conv1x1(**_wgrad_kw(kw))
    rw = tpc.ref_wgrad_conv1x1(**_wgrad_kw(kw))
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    for name, g, r in zip(("dx1", "dx2", "ds1", "dt1", "ds2", "dt2", "db"),
                          got, ref):
        assert (g is None) == (r is None), name
        if g is not None:
            scale = max(float(r.float().abs().max()), 1.0)
            torch.testing.assert_close(g.float() / scale, r.float() / scale,
                                       rtol=0, atol=tol, msg=name)
    scale = max(float(rw.abs().max()), 1.0)
    torch.testing.assert_close(gw / scale, rw / scale, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["simple", "wgmma"])
def test_cuda_relu_prologues_keep_nan_like_their_plain_versions(
        rng, route, dtype):
    """A NaN input stays NaN through each kernel's relu prologue (the 1x1
    and 3x3 forward, wgrad's recomputed u), where it does in the plain
    versions (torch.clamp_min) and the JAX kernels (jnp.maximum): a
    poisoned batch reaches the loss. In f32 both shapes take "simple"."""
    _need_cuda()
    dt = getattr(torch, dtype)
    cuda = lambda v: torch.from_numpy(v).cuda()
    same_nans = lambda g, r: (torch.equal(torch.isnan(g), torch.isnan(r))
                              and bool(torch.isnan(r).any()))
    M, K, N = (1100, 64, 192) if route == "wgmma" else (200, 72, 136)
    a, kw = _args_1x1(rng, "affine_relu", M, K, N)
    a["x"][[3, 150]] = np.nan
    x, w, b = cuda(a["x"]).to(dt), cuda(a["w"]).to(dt), cuda(a["b"])
    kw = {k: (cuda(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    assert same_nans(tpc.fused_conv1x1(x, w, b, **kw)[0],
                     tpc.ref_fused_conv1x1(x, w, b, **kw)[0])
    B, H, C, N3 = (1, 7, 128, 256) if route == "wgmma" else (2, 9, 24, 40)
    x3 = rng.normal(size=(B, H, H, C)).astype(np.float32)
    x3[0, 2, 3] = np.nan
    w3 = (rng.normal(size=(3, 3, C, N3)) * 0.1).astype(np.float32)
    kw3 = {"scale": cuda(np.ones(C, np.float32)),
           "shift": cuda(np.zeros(C, np.float32)), "relu": True}
    x3, w3 = cuda(x3).to(dt), cuda(w3).to(dt)
    b3 = cuda(np.zeros(N3, np.float32))
    assert same_nans(tpc.fused_conv3x3(x3, w3, b3, **kw3)[0],
                     tpc.ref_fused_conv3x3(x3, w3, b3, **kw3)[0])
    shape = SHAPES_BWD[2] if route == "wgmma" else SHAPES_BWD[0]
    bkw = _wgrad_kw(_bwd_args(rng, *shape, dt, BWD_CASES[1]))
    bkw["x"][[5, 60]] = float("nan")
    assert same_nans(tpc.wgrad_conv1x1(**bkw), tpc.ref_wgrad_conv1x1(**bkw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPES_BWD[0], SHAPES_BWD[5]],
                         ids=["simple", "wgmma"])
def test_cuda_backward_kernels_are_bitwise_repeatable(rng, shape):
    """Partials and fixed-order reductions, no atomics: the same inputs
    give the same bits, on either route."""
    _need_cuda()
    kw = _bwd_args(rng, *shape, torch.bfloat16, BWD_CASES[4])
    a, b = tpc.dgrad_conv1x1(**kw), tpc.dgrad_conv1x1(**kw)
    wa = tpc.wgrad_conv1x1(**_wgrad_kw(kw))
    wb = tpc.wgrad_conv1x1(**_wgrad_kw(kw))
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(wa, wb)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES_BWD, ids=BWD_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_route_counter_names_the_kernel_launched(rng, dtype,
                                                              shape):
    _need_cuda()
    dt = getattr(torch, dtype)
    kw = _bwd_args(rng, *shape, dt, BWD_CASES[2])
    want = BF16_ROUTE[BWD_IDS[SHAPES_BWD.index(shape)]] \
        if dt == torch.bfloat16 else "simple"
    tpc.reset_launch_counts()
    tpc.dgrad_conv1x1(**kw)
    tpc.wgrad_conv1x1(**_wgrad_kw(kw))
    torch.cuda.synchronize()
    for name in ("dgrad_conv1x1", "wgrad_conv1x1"):
        assert tpc.BACKWARD_ROUTES[name] == {
            "wgmma": int(want == "wgmma"), "simple": int(want == "simple")}
        assert tpc.LAUNCHES[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES_BWD, ids=BWD_IDS)
@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[4]],
                         ids=["affine_relu", "affx2_stats"])
def test_cuda_dgrad_relu_mask_matches_plain_exactly(rng, case, shape):
    """u is recomputed with the forward's rounding on either route, so no
    element of the relu mask flips against the plain version: dx1 is zero
    exactly where the plain version's is."""
    _need_cuda()
    kw = _bwd_args(rng, *shape, torch.bfloat16, case)
    got = tpc.dgrad_conv1x1(**kw)[0]
    ref = tpc.ref_dgrad_conv1x1(**kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(got == 0, ref == 0)


# ------------------------------------------------- the training engine
#
# StepProgram.run_group on the card: one replay of a CUDA graph that holds
# k captured train steps, against k eager run() calls, on a graph the size
# of tests/test_helpers.py's `_mini_resnet`, built from the port alone.
# cuDNN computes this net's stride-2 stem convolution and the composed
# backward; its default algorithms may reduce in a run-dependent order, so
# these tests ask it for deterministic ones (the comparison is bitwise).


def _port_mini_resnet(helpers, compute_dtype=None, **conf_attrs):
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
        ElementWiseVertex,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer,
        BatchNormalization,
        ConvolutionLayer,
        GlobalPoolingLayer,
        OutputLayer,
        SubsamplingLayer,
    )

    gb = (NeuralNetConfiguration.Builder().seed(7).updater("sgd")
          .learning_rate(0.05).weight_init("relu").activation("relu")
          .graph_builder().add_inputs("input"))

    def conv_bn(name, inp, n_out, kernel, stride=(1, 1), act=True):
        gb.add_layer(f"{name}_conv", ConvolutionLayer(
            n_out=n_out, kernel_size=kernel, stride=stride,
            convolution_mode="same", activation="identity"), inp)
        gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        if not act:
            return f"{name}_bn"
        gb.add_layer(f"{name}_act", ActivationLayer(activation="relu"),
                     f"{name}_bn")
        return f"{name}_act"

    x = conv_bn("stem", "input", 8, (3, 3), stride=(2, 2))
    gb.add_layer("pool", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                          convolution_mode="same"), x)
    a = conv_bn("b0a", "pool", 8, (1, 1))
    b = conv_bn("b0b", a, 8, (3, 3))
    c = conv_bn("b0c", b, 16, (1, 1), act=False)
    sc = conv_bn("b0sc", "pool", 16, (1, 1), act=False)
    gb.add_vertex("b0_add", ElementWiseVertex(op="add"), c, sc)
    gb.add_layer("b0_out", ActivationLayer(activation="relu"), "b0_add")
    a = conv_bn("b1a", "b0_out", 8, (1, 1))
    b = conv_bn("b1b", a, 8, (3, 3))
    c = conv_bn("b1c", b, 16, (1, 1), act=False)
    gb.add_vertex("b1_add", ElementWiseVertex(op="add"), c, "b0_out")
    gb.add_layer("b1_out", ActivationLayer(activation="relu"), "b1_add")
    gb.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), "b1_out")
    gb.add_layer("out", OutputLayer(n_out=5, loss="mcxent"), "gap")
    gb.set_outputs("out")
    gb.set_input_types(input=InputType.convolutional(16, 16, 3))
    gb.helpers(helpers)
    conf = gb.build()
    for k, v in conf_attrs.items():
        setattr(conf, k, v)
    return ComputationGraph(conf, compute_dtype=compute_dtype).init()


def _engine_batches(n, seed=2024, rows=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, 16, 16, 3)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, rows)]
        out.append((x, y))
    return out


def _stacked(data):
    return (np.stack([d[0] for d in data]), np.stack([d[1] for d in data]))


@pytest.fixture
def deterministic_cudnn():
    _need_cuda()
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


def _train_state(net):
    from deeplearning4j_tpu_torch.util.tree import leaves

    return (leaves(net.params) + leaves(net.updater_states)
            + leaves(net.states))


def _assert_nets_bitwise(a, b):
    sa, sb = _train_state(a), _train_state(b)
    assert len(sa) == len(sb) and a.iteration == b.iteration
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


ENGINE_CONF = dict(updater="adam", lr_policy="step",
                   lr_policy_decay_rate=0.5, lr_policy_steps=2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("helpers", ["fused", "pallas"])
def test_cuda_run_group_replay_equals_eager_runs_bitwise(
        deterministic_cudnn, helpers, compute_dtype):
    from deeplearning4j_tpu_torch.engine import StepProgram

    data = _engine_batches(6)
    a = _port_mini_resnet(helpers, compute_dtype, **ENGINE_CONF)
    b = _port_mini_resnet(helpers, compute_dtype, **ENGINE_CONF)
    pa, pb = StepProgram(a), StepProgram(b)
    for lo in (0, 3):                    # capture + replay, then replay
        losses = torch.stack([pa.run(x, y) for x, y in data[lo:lo + 3]])
        pb.run_group(*_stacked(data[lo:lo + 3]))
        torch.cuda.synchronize()
        assert torch.equal(losses, pb.last_step_losses)
        _assert_nets_bitwise(a, b)
    assert pb.group_stats["captures"] == 1
    assert pb.group_stats["replays"] == 2


@pytest.mark.cuda
def test_cuda_run_group_replays_after_a_snapshot_restore(
        deterministic_cudnn):
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard

    data = _engine_batches(3, seed=5)
    a = _port_mini_resnet("pallas", **ENGINE_CONF)
    b = _port_mini_resnet("pallas", **ENGINE_CONF)
    pb = StepProgram(b)
    guard = NonFiniteGuard("skip_step")
    snap = guard.snapshot(b)
    pb.run_group(*_stacked(data))
    first = pb.last_step_losses.clone()
    guard.restore(b, snap)
    assert b.iteration == 0
    pb.run_group(*_stacked(data))        # same graph, restored state
    for x, y in data:
        StepProgram(a).run(x, y)
    torch.cuda.synchronize()
    assert torch.equal(first, pb.last_step_losses)
    _assert_nets_bitwise(a, b)
    assert pb.group_stats["captures"] == 1


@pytest.mark.cuda
def test_cuda_run_group_counts_launches_once_per_replay():
    from deeplearning4j_tpu_torch.engine import StepProgram

    _need_cuda()
    data = _engine_batches(4, seed=6)
    net = _port_mini_resnet("pallas")
    prog = StepProgram(net)
    tpc.reset_launch_counts()
    prog.run(*data[0])
    per_step = tpc.launch_counts()
    assert per_step["fused_conv1x1"] > 0 and per_step["dgrad_conv1x1"] > 0
    assert per_step["fused_conv3x3"] > 0 and per_step["wgrad_conv1x1"] > 0
    xs, ys = _stacked(data[1:])
    tpc.reset_launch_counts()
    prog.run_group(xs, ys)               # warm-up step + capture + replay
    first = tpc.launch_counts()
    (launches,) = prog.group_launches().values()
    assert launches == {k: 3 * v for k, v in per_step.items() if v}
    assert first == {k: 4 * v for k, v in per_step.items()}
    tpc.reset_launch_counts()
    for _ in range(2):
        prog.run_group(xs, ys)
    torch.cuda.synchronize()
    assert tpc.launch_counts() == {k: 6 * v for k, v in per_step.items()}


@pytest.mark.cuda
def test_cuda_run_group_raises_when_capture_is_impossible(monkeypatch):
    """A host read inside the step cannot be captured: run_group raises
    and runs no eager step in place of the graph."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    _need_cuda()
    data = _engine_batches(2, seed=7)
    net = _port_mini_resnet("pallas")
    before = [t.clone() for t in _train_state(net)]
    step = net._step

    def step_with_host_read(*args, **kwargs):
        out = step(*args, **kwargs)      # (carry, loss, rnn carries)
        float(out[1])                    # a host sync: not capturable
        return out

    monkeypatch.setattr(net, "_step", step_with_host_read)
    with pytest.raises(RuntimeError, match="into a CUDA graph failed"):
        StepProgram(net).run_group(*_stacked(data))
    torch.cuda.synchronize()
    assert net.iteration == 0
    for x, y in zip(before, _train_state(net)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_device_prefetch_stages_on_a_side_stream():
    from deeplearning4j_tpu_torch.datasets import DevicePrefetchIterator

    _need_cuda()
    data = _engine_batches(3, seed=8)
    it = DevicePrefetchIterator(data, buffer_size=2)
    got = list(it)
    torch.cuda.synchronize()
    assert len(got) == 3 and it._stage._stream is not None
    for (x, y), (sx, sy) in zip(data, got):
        assert sx.is_cuda and sx.dtype == torch.float32
        assert np.array_equal(sx.cpu().numpy(), x)
        assert np.array_equal(sy.cpu().numpy(), y)


@pytest.mark.cuda
def test_cuda_host_stage_converts_into_pinned_memory():
    """The host half of staging, as the producer thread runs it: each
    floating array in the net's dtype in pinned memory, the rest as it
    was, and the pipeline's batches on the card with the same values."""
    from deeplearning4j_tpu_torch.datasets.iterators import host_stage
    from deeplearning4j_tpu_torch.engine import IteratorPipeline

    _need_cuda()
    x, y = _engine_batches(1, seed=11)[0]
    idx = np.arange(len(x), dtype=np.int64)
    hb = host_stage((x.astype(np.float64), y, idx),
                    device=torch.device("cuda"), dtype=torch.float32)
    assert all(t.is_pinned() for t in hb)
    assert [t.dtype for t in hb] == [torch.float32, torch.float32,
                                     torch.int64]
    assert np.array_equal(hb[0].numpy(), x) and np.array_equal(
        hb[2].numpy(), idx)
    data = _engine_batches(3, seed=12)
    with IteratorPipeline(data, depth=2) as pipe:
        got = list(pipe)
    torch.cuda.synchronize()
    for (bx, by), (sx, sy, *_) in zip(data, got):
        assert sx.is_cuda and np.array_equal(sx.cpu().numpy(), bx)
        assert np.array_equal(sy.cpu().numpy(), by)


@pytest.mark.cuda
@pytest.mark.parametrize("helpers", ["pallas", "fused"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_cuda_score_on_the_flat_carry_equals_the_reloaded_score(
        tmp_path, helpers, compute_dtype):
    """score(data) over views of the live flat carry (some of which do
    not start on a 16-byte boundary) gives the bits a net reloaded from
    the written file gives."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_computation_graph,
        write_model,
    )
    from deeplearning4j_tpu_torch.util.tree import leaves

    _need_cuda()
    data = _engine_batches(3, seed=13)
    net = _port_mini_resnet(helpers, compute_dtype, updater="nesterovs")
    prog = StepProgram(net)
    for x, y in data[:2]:
        prog.run(x, y)
    assert net._flat_train is not None
    assert any(t.data_ptr() % 16 for t in leaves(net._params_view()))
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    back = restore_computation_graph(path, compute_dtype=compute_dtype)
    assert net.score(data[2]) == back.score(data[2])
    assert net._flat_train is not None


@pytest.mark.cuda
def test_cuda_early_stopping_pipeline_on_equals_off_bitwise(
        deterministic_cudnn):
    """Batches staged on a side stream by the input pipeline train to the
    same bits as batches the step copies itself."""
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
    )

    data = _engine_batches(4, seed=9)
    held = _engine_batches(1, seed=10)
    nets, results = [], []
    for pipeline in (True, False):
        net = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
            model_saver=InMemoryModelSaver(),
            score_calculator=DataSetLossCalculator(held))
        results.append(EarlyStoppingTrainer(cfg, net, data,
                                            pipeline=pipeline).fit())
        nets.append(net)
    torch.cuda.synchronize()
    assert results[0].score_vs_epoch == results[1].score_vs_epoch
    _assert_nets_bitwise(*nets)


# ----------------------------------------- MultiLayerNetwork and dropout


def _cuda_mln(seed=3, compute_dtype=None):
    """A small conv MLN with dropout on a conv, a dense layer and the
    output layer's input (SimpleCNN's shape at a narrow width)."""
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        DenseLayer,
        OutputLayer,
        SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(seed).updater("nesterovs")
            .learning_rate(1e-2).activation("relu").weight_init("relu")
            .list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    convolution_mode="same"))
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    convolution_mode="same", dropout=0.5))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=32, dropout=0.5))
            .layer(OutputLayer(n_out=5, loss="mcxent", dropout=0.25))
            .set_input_type(InputType.convolutional(16, 16, 3)).build())
    return MultiLayerNetwork(conf, compute_dtype=compute_dtype).init()


def _same_state(a, b):
    sa, sb = _train_state(a), _train_state(b)
    return len(sa) == len(sb) and all(torch.equal(x, y)
                                      for x, y in zip(sa, sb))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_cuda_mln_run_group_with_dropout_equals_eager_runs(
        deterministic_cudnn, compute_dtype):
    """run_group(4) replays a captured graph whose dropout masks come
    from the net's own generator (registered with the graph): from one
    generator state it equals four eager run() calls bit for bit, the
    generator's state after included; a second replay draws new masks."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.layers.base import dropout_mask

    data = _engine_batches(4, seed=51)
    a, b = _cuda_mln(compute_dtype=compute_dtype), \
        _cuda_mln(compute_dtype=compute_dtype)
    pa, pb = StepProgram(a), StepProgram(b)
    losses = torch.stack([pa.run(x, y) for x, y in data])
    pb.run_group(*_stacked(data))
    torch.cuda.synchronize()
    assert _same_state(a, b)
    assert torch.equal(losses, pb.last_step_losses)
    assert torch.equal(a._rng_state(), b._rng_state())
    probe = torch.zeros(64, device="cuda")
    m1 = dropout_mask(probe, 0.5, b._train_rng())
    pb.run_group(*_stacked(data))
    m2 = dropout_mask(probe, 0.5, b._train_rng())
    assert not torch.equal(m1, m2)
    assert not torch.equal(pb.last_step_losses, losses)
    assert pb.group_stats["captures"] == 1


@pytest.mark.cuda
def test_cuda_guard_skip_rewinds_the_dropout_generator(deterministic_cudnn):
    """A skip_step restore between replays rewinds the generator too: the
    replay after it equals the first replay bit for bit."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard

    net = _cuda_mln()
    prog = StepProgram(net)
    xs, ys = _stacked(_engine_batches(4, seed=52))
    guard = NonFiniteGuard("skip_step")
    snap = guard.snapshot(net)
    prog.run_group(xs, ys)
    first = [t.clone() for t in _train_state(net)]
    first_losses = prog.last_step_losses.clone()
    guard.restore(net, snap)
    prog.run_group(xs, ys)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, _train_state(net)))
    assert torch.equal(first_losses, prog.last_step_losses)


@pytest.mark.cuda
def test_cuda_groups_share_one_graph_pool(deterministic_cudnn):
    """A second k captures into the StepProgram's one pool; a window
    shorter than a captured group runs as eager steps, bit for bit the
    same as a replay of that many steps would be."""
    from deeplearning4j_tpu_torch.engine import StepProgram

    data = _engine_batches(4, seed=53)
    net, ref = _cuda_mln(), _cuda_mln()
    prog, pref = StepProgram(net), StepProgram(ref)
    prog.run_group(*_stacked(data[:2]))
    prog.run_group(*_stacked(data))
    pools = {g.graph.pool() for g in prog._groups.values()}
    assert len(prog._groups) == 2 and len(pools) == 1
    prog.run_group(*_stacked(data[:1]))           # shorter: eager
    assert prog.group_stats["eager_windows"] == 1
    assert prog.group_stats["captures"] == 2
    for x, y in data[:2] + data + data[:1]:
        pref.run(x, y)
    torch.cuda.synchronize()
    assert _same_state(net, ref)


@pytest.mark.cuda
def test_cuda_lrn_and_zero_padding_match_the_cpu(rng):
    """AlexNet's LRN and zero padding on the card against the CPU (f32,
    1e-6; bf16, one bf16 ulp)."""
    from deeplearning4j_tpu_torch.nn.layers import (
        LocalResponseNormalization,
        ZeroPaddingLayer,
    )

    _need_cuda()
    x = torch.from_numpy(rng.normal(size=(2, 9, 9, 96)).astype(np.float32))
    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -8)):
        for layer in (LocalResponseNormalization(),
                      ZeroPaddingLayer(padding=(1, 2))):
            cpu = layer.apply({}, x.to(dt))[0].float()
            gpu = layer.apply({}, x.to(dt).cuda())[0].float().cpu()
            torch.testing.assert_close(gpu, cpu, rtol=tol, atol=1e-6)


# ------------------------------------- TrainingMaster and ParallelWrapper


def _windows(prog, data, k):
    """Hand-driven run_group over consecutive k-windows of `data` (a
    shorter last window runs eagerly, as in a fit)."""
    for lo in range(0, len(data), k):
        prog.run_group(*_stacked(data[lo:lo + k]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_cuda_training_master_equals_hand_driven_run_group(
        deterministic_cudnn, k):
    """TrainingMaster (pipeline on: pinned batches, a side stream, the
    window stacked on the card) against hand-driven StepProgram calls on
    the same batches, bit for bit; at k=3 a 7-step fit replays two
    groups and runs its 1-step tail eagerly."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.parallel import TrainingMaster

    data = _engine_batches(7, seed=12)
    a = _port_mini_resnet("pallas", "bfloat16", **ENGINE_CONF)
    b = _port_mini_resnet("pallas", "bfloat16", **ENGINE_CONF)
    tm = TrainingMaster(a, steps_per_dispatch=k)
    tm.fit(lambda s: data[s], 7)
    prog = StepProgram(b)
    if k == 1:
        for x, y in data:
            prog.run(x, y)
    else:
        _windows(prog, data, k)
    torch.cuda.synchronize()
    assert a._flat_train is not None
    _assert_nets_bitwise(a, b)
    if k > 1:
        g = tm._harness.program.group_stats
        assert (g["captures"], g["replays"], g["eager_windows"]) == (1, 2, 1)


@pytest.mark.cuda
def test_cuda_training_master_resume_is_bitwise(deterministic_cudnn,
                                                tmp_path):
    """8 uninterrupted steps (checkpoint_every=4) against a net of
    another seed that restores step 4 and trains to 8."""
    from deeplearning4j_tpu_torch.parallel import TrainingMaster

    data = _engine_batches(8, seed=13)
    a = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    TrainingMaster(a, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                   steps_per_dispatch=4).fit(lambda s: data[s], 8)
    b = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs",
                          seed=99)
    tm = TrainingMaster(b, checkpoint_dir=str(tmp_path),
                        steps_per_dispatch=4)
    assert tm.load_checkpoint_at(4) == 4 and b.iteration == 4
    tm.fit(lambda s: data[s], 8, start_step=4)
    torch.cuda.synchronize()
    _assert_nets_bitwise(a, b)


@pytest.mark.cuda
def test_cuda_rollback_then_replay_needs_no_recapture(deterministic_cudnn,
                                                      tmp_path):
    """A poisoned inner step of the second group rolls back to the step-4
    checkpoint; the window replays without it (eagerly: 3 steps) and the
    next group replays the graph captured first — one capture — ending
    bit for bit where eager steps over the clean batches end."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.parallel import TrainingMaster
    from deeplearning4j_tpu_torch.resilience import NonFiniteGuard, injector

    data = _engine_batches(12, seed=14)
    net = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    tm = TrainingMaster(net, checkpoint_dir=str(tmp_path),
                        checkpoint_every=4, steps_per_dispatch=4,
                        guard=NonFiniteGuard("rollback", check_every=1))
    injector().clear()
    injector().inject("train.grad_nonfinite", at_hit=6)   # step 5
    try:
        tm.fit(lambda s: data[s], 12)
    finally:
        injector().clear()
    g = tm._harness.program.group_stats
    assert sorted(tm._poisoned_steps) == [5]
    assert tm.guard.counters["rollbacks"] == 1
    assert (g["captures"], g["replays"], g["eager_windows"]) == (1, 3, 1)
    ref = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    prog = StepProgram(ref)
    for s in range(12):
        if s != 5:
            prog.run(*data[s])
    torch.cuda.synchronize()
    _assert_nets_bitwise(net, ref)


@pytest.mark.cuda
def test_cuda_parallel_wrapper_equals_hand_driven_run_group(
        deterministic_cudnn):
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    data = _engine_batches(8, seed=15)
    a = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    b = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    ParallelWrapper(a, steps_per_dispatch=4).fit(data)
    _windows(StepProgram(b), data, 4)
    torch.cuda.synchronize()
    _assert_nets_bitwise(a, b)


# ------------------------------------------- observability and supervision


@pytest.mark.cuda
def test_cuda_hang_during_capture_keeps_no_group(deterministic_cudnn):
    """A StepHangError (the watchdog's escalation) raised while a group
    is being captured passes through as itself, keeps no half-captured
    graph, and the next run_group captures afresh and equals eager
    steps bit for bit."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.resilience import StepHangError

    data = _engine_batches(6, seed=16)
    net = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    prog = StepProgram(net)
    step, calls = net._step, {"n": 0}

    def hung_in_capture(*args):
        calls["n"] += 1
        if calls["n"] == 2:          # the warm-up is call 1
            raise StepHangError("watchdog")
        return step(*args)

    net._step = hung_in_capture
    with pytest.raises(StepHangError):
        prog.run_group(*_stacked(data[:3]))
    del net._step
    assert prog.group_launches() == {} and net.iteration == 0
    prog.run_group(*_stacked(data[:3]))
    prog.run_group(*_stacked(data[3:]))
    ref = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
    rprog = StepProgram(ref)
    for x, y in data:
        rprog.run(x, y)
    torch.cuda.synchronize()
    assert prog.group_stats["captures"] == 1
    _assert_nets_bitwise(net, ref)


@pytest.mark.cuda
def test_cuda_capture_collects_dead_graphs_before_not_during(
        deterministic_cudnn):
    """A dead reference cycle holding another captured group must not be
    finalized inside a capture (CUDA forbids destroying a graph while a
    stream captures): run_group collects before it captures and keeps the
    collector off during it. Here a collection falls inside the capture
    (the first captured step calls gc.collect()); the cycle is already
    gone, so the capture holds and the steps equal eager ones."""
    import gc

    from deeplearning4j_tpu_torch.engine import StepProgram

    data = _engine_batches(4, seed=17)
    gc.disable()
    try:
        old = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
        prog = StepProgram(old)
        prog.run_group(*_stacked(data))
        prog.cycle = prog       # dead after del: only the collector frees it
        del prog, old
        net = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
        ref = _port_mini_resnet("pallas", "bfloat16", updater="nesterovs")
        step, calls = net._step, {"n": 0}

        def step_collecting(*args):
            calls["n"] += 1
            if calls["n"] == 2:          # the warm-up is call 1
                gc.collect()
            return step(*args)

        net._step = step_collecting
        StepProgram(net).run_group(*_stacked(data))
    finally:
        gc.enable()
    for x, y in data:
        StepProgram(ref).run(x, y)
    torch.cuda.synchronize()
    _assert_nets_bitwise(net, ref)


@pytest.mark.cuda
def test_cuda_register_perf_counts_a_fused_twin_on_the_card():
    """On the card a "pallas" net's step is counted on a "fused" twin
    (every product an aten op): within 1% of the CPU twin's plain-version
    count, k times it for a captured group."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.observability import CostModel

    _need_cuda()
    data = _engine_batches(3, seed=17)
    net = _port_mini_resnet("pallas")
    prog = StepProgram(net)
    cm = CostModel()
    e1 = prog.register_perf(cm, None, *data[0])
    assert "cuda twin (fused helpers" in e1["source"]
    cpu = ComputationGraph(net.conf, device="cpu").init()
    ec = StepProgram(cpu).register_perf(CostModel(device="cpu"), None,
                                        *data[0])
    assert abs(e1["flops"] / ec["flops"] - 1) < 0.01
    prog.run_group(*_stacked(data))
    (key,) = prog.group_launches()
    eg = prog.register_perf(cm, key)
    assert eg["flops"] == pytest.approx(3 * e1["flops"], rel=1e-9)
    assert cm.device_kind == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_cuda_stats_summaries_equal_the_cpus(rng):
    """StatsListener's device summaries (min, max, mean |x|, 32-bin
    counts by numpy's rule) on the card equal the CPU's: the same f32
    edges and comparisons, mean |x| within f32 summation order."""
    from deeplearning4j_tpu_torch.stats.listener import summarize

    _need_cuda()
    named = [(f"g{i}", torch.from_numpy(
        rng.normal(size=n).astype(np.float32))) for i, n in
        enumerate((1, 7, 1000, 300_000))]
    named.append(("const", torch.full((9,), 3.0)))
    cpu = summarize(named, 32)
    gpu = summarize([(n, t.cuda()) for n, t in named], 32).cpu()
    torch.testing.assert_close(gpu[:, :2], cpu[:, :2], rtol=0, atol=0)
    torch.testing.assert_close(gpu[:, 3:], cpu[:, 3:], rtol=0, atol=0)
    torch.testing.assert_close(gpu[:, 2], cpu[:, 2], rtol=1e-5, atol=0)


# Graph-zoo shapes on the "simple" route in bf16 (channel counts that are
# not multiples of 64): GoogLeNet's i3a_5x5r (192 -> 16 at 28x28) and
# i4a_5x5r (480 -> 16 at 14x14), i4e's 528 -> 32, and 3x3s with C != N
# (96 -> 128 at 28x28, 112 -> 224 at 14x14); 64 -> 192 at 56x56 takes the
# wgmma route. Batch 2 keeps the test small. Bound: the kernel phase's
# normalized one, max |kernel - plain| / max(max |plain|, 1) <= 1e-2 in
# bf16 (one output rounding may land on either side).
ZOO_1X1 = [(2 * 28 * 28, 192, 16), (2 * 14 * 14, 480, 16),
           (2 * 14 * 14, 528, 32)]
ZOO_3X3 = [(2, 28, 96, 128), (2, 14, 112, 224), (2, 56, 64, 192)]
ZOO_TOL = 1e-2


def _norm_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("1x1", s) for s in ZOO_1X1]
                         + [("3x3", s) for s in ZOO_3X3],
                         ids=["k192_n16", "k480_n16", "k528_n32",
                              "c96_n128", "c112_n224", "c64_n192"])
def test_cuda_zoo_forward_shapes_match_plain_in_bf16(rng, case):
    _need_cuda()
    kind, shape = case
    x, w, b, kw = _fwd_inputs(rng, kind, shape)
    m, k, n = ((shape[0], shape[1], shape[2]) if kind == "1x1" else
               (shape[0] * shape[1] ** 2, shape[2], shape[3]))
    want = tpc.forward_route(torch.bfloat16, m, k, n,
                             width=None if kind == "1x1" else shape[1])
    assert want == ("wgmma" if k % 64 == 0 and n % 64 == 0 else "simple")
    tpc.reset_launch_counts()
    got = _fwd(kind)(x, w, b, **kw)
    ref = (tpc.ref_fused_conv1x1 if kind == "1x1"
           else tpc.ref_fused_conv3x3)(x, w, b, **kw)
    torch.cuda.synchronize()
    name = "fused_conv1x1" if kind == "1x1" else "fused_conv3x3"
    assert tpc.FORWARD_ROUTES[name][want] == 1
    for g, r in zip(got[:3], ref[:3]):
        assert _norm_err(g, r) <= ZOO_TOL
    if kind == "1x1":
        assert torch.equal(got[3], ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ZOO_1X1, ids=["k192_n16", "k480_n16",
                                                "k528_n32"])
def test_cuda_zoo_backward_shapes_match_plain_in_bf16(rng, shape):
    _need_cuda()
    kw = _bwd_args(rng, *shape, torch.bfloat16, BWD_CASES[2])
    assert tpc.backward_route(torch.bfloat16, *shape) == "simple"
    got, again = tpc.dgrad_conv1x1(**kw), tpc.dgrad_conv1x1(**kw)
    ref = tpc.ref_dgrad_conv1x1(**kw)
    gw = tpc.wgrad_conv1x1(**_wgrad_kw(kw))
    rw = tpc.ref_wgrad_conv1x1(**_wgrad_kw(kw))
    torch.cuda.synchronize()
    for g, r, a in zip(got, ref, again):
        assert (g is None) == (r is None)
        if g is not None:
            assert _norm_err(g, r) <= ZOO_TOL and torch.equal(g, a)
    assert _norm_err(gw, rw) <= ZOO_TOL


@pytest.mark.cuda
def test_cuda_frozen_prefix_replays_bitwise_without_its_backward(
        deterministic_cudnn):
    """The mini ResNet with its conv block frozen (TransferLearning
    .GraphBuilder): run_group(3) equals three eager runs bit for bit, the
    frozen params keep their bits, and a replay launches the backward
    kernels of the unfrozen block only (b1a: wgrad; b1c: dgrad and
    wgrad)."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearning,
    )

    def frozen_net():
        return (TransferLearning.GraphBuilder(_port_mini_resnet("pallas"))
                .set_feature_extractor("b0_out").build())

    data = _engine_batches(3)
    a, b = frozen_net(), frozen_net()
    frozen = sorted(a._frozen())
    before = {k: [t.clone() for t in a.params[k].values()] for k in frozen}
    pa, pb = StepProgram(a), StepProgram(b)
    tpc.reset_launch_counts()
    losses = torch.stack([pa.run(x, y) for x, y in data])
    torch.cuda.synchronize()
    eager = dict(tpc.LAUNCHES)
    pb.run_group(*_stacked(data))
    torch.cuda.synchronize()
    assert torch.equal(losses, pb.last_step_losses)
    _assert_nets_bitwise(a, b)
    for net in (a, b):
        for k in frozen:
            assert all(torch.equal(t, u) for t, u in
                       zip(before[k], net.params[k].values()))
    assert eager["dgrad_conv1x1"] == 3 and eager["wgrad_conv1x1"] == 6
    (per_replay,) = pb.group_launches().values()
    assert per_replay["dgrad_conv1x1"] == 3
    assert per_replay["wgrad_conv1x1"] == 6


# ------------------------------------------- Keras import, data, eval

KERAS_FIXTURES = ["seq_cnn", "func_merge", "lstm_seq", "func_cnn_merge",
                  "lstm_encoder", "conv1d_stack", "lrn_cnn",
                  "torch/keras_resblock"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERAS_FIXTURES)
def test_cuda_keras_fixture_imports_onto_the_card(name):
    """Each Keras fixture read by the port's own HDF5 reader (no h5py)
    and imported onto the card in f32 matches Keras's outputs at
    tests/test_modelimport.py's bars; the residual block also in
    "pallas", through the kernels."""
    import os

    from deeplearning4j_tpu_torch.modelimport import KerasModelImport

    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(os.path.dirname(__file__), "fixtures", name + ".h5")
    exp = np.load(path.replace(".h5", "_expected.npz"))
    for mode in (("none", "pallas") if "resblock" in name else ("none",)):
        net = KerasModelImport.import_keras_model_and_weights(path)
        assert net.device.type == "cuda"
        net.conf.helper_mode = mode
        tpc.reset_launch_counts()
        out = net.output(exp["x"]).cpu().numpy()
        np.testing.assert_allclose(out, exp["y"], rtol=1e-4, atol=1e-5)
        if mode == "pallas":
            assert tpc.LAUNCHES["fused_conv1x1"] == 3
            assert tpc.LAUNCHES["fused_conv3x3"] == 1


@pytest.mark.cuda
def test_cuda_evaluations_on_card_tensors_equal_the_cpus(rng):
    """Every evaluation fed tensors on the card equals the same evaluation
    fed the tensors copied to the CPU: counts, curves and AUCs exactly;
    float64 sums within 1e-12."""
    from deeplearning4j_tpu_torch import eval as ev
    from deeplearning4j_tpu_torch.datasets import VGG16ImagePreProcessor

    _need_cuda()
    logits = torch.from_numpy(rng.normal(size=(512, 10)) * 2)
    p = torch.softmax(logits, -1).float().cuda()
    lab = torch.eye(10)[torch.from_numpy(rng.integers(0, 10, 512))].cuda()
    mask = torch.from_numpy(rng.random(512) > 0.2).cuda()
    for make, kw in ((ev.ROCMultiClass, {}), (ev.ROCBinary, {}),
                     (ev.EvaluationCalibration, {}),
                     (ev.EvaluationBinary, {})):
        a, b = make(device="cuda"), make(device="cpu")
        a.eval(lab, p, mask)
        b.eval(lab.cpu(), p.cpu(), mask.cpu())
        if hasattr(a, "average_auc"):
            assert a.average_auc() == b.average_auc()
        elif hasattr(a, "expected_calibration_error"):
            for c in range(10):
                for u, v in zip(a.reliability_info(c)[1:],
                                b.reliability_info(c)[1:]):
                    np.testing.assert_array_equal(u, v)
            np.testing.assert_allclose(a.expected_calibration_error(),
                                       b.expected_calibration_error(),
                                       rtol=1e-12)
        else:
            assert a.stats() == b.stats()
    roc_a, roc_b = ev.ROC(device="cuda"), ev.ROC(device="cpu")
    roc_a.eval(lab[:, :2], p[:, :2])
    roc_b.eval(lab[:, :2].cpu(), p[:, :2].cpu())
    assert roc_a.calculate_auc() == roc_b.calculate_auc()
    reg_a, reg_b = (ev.RegressionEvaluation(device="cuda"),
                    ev.RegressionEvaluation(device="cpu"))
    reg_a.eval(lab, p)
    reg_b.eval(lab.cpu(), p.cpu())
    for c in range(10):
        np.testing.assert_allclose(reg_a.r_squared(c), reg_b.r_squared(c),
                                   rtol=1e-12)
    e_a, e_b = ev.Evaluation(), ev.Evaluation()
    e_a.eval(lab, p)
    e_b.eval(lab.cpu(), p.cpu())
    np.testing.assert_array_equal(e_a.confusion.matrix, e_b.confusion.matrix)
    img = torch.rand(2, 8, 8, 3).mul(255).cuda()
    vgg = VGG16ImagePreProcessor()
    assert torch.equal(vgg.transform(img).cpu(), vgg.transform(img.cpu()))


@pytest.mark.cuda
def test_cuda_decode_engine_equals_oracle_under_churn():
    """The decode path on the card: the continuous engine's tokens under
    staggered churn, a shared prefix, ring wrap and an eviction drill
    equal the port's `sequential_decode` bit for bit, and the three
    program keys are built once."""
    _need_cuda()
    import random

    from deeplearning4j_tpu_torch.engine.decode_program import (
        DecodeProgram,
    )
    from deeplearning4j_tpu_torch.resilience.faults import injector
    from deeplearning4j_tpu_torch.serving.continuous import (
        DecodeEngine,
        sequential_decode,
    )
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalTransformer(vocab_size=64, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=64, seed=3).init()
    assert model.params["tok_emb"].is_cuda
    prog = DecodeProgram(model, max_slots=4, page_size=8)
    kv = prog.warmup(prog.init_kv())
    assert kv.is_cuda
    builds = model._jit_cache.trace_counts()
    rng = random.Random(1)
    system = [rng.randrange(64) for _ in range(16)]
    reqs = [((system if i % 3 == 0 else [])
             + [rng.randrange(64) for _ in range(rng.randrange(2, 20))],
             rng.randrange(2, 14)) for i in range(12)]
    reqs.append(([5, 3, 8, 13, 21], 90))          # past max_ctx: wraps
    oracle = [sequential_decode(prog, p, mx)[1] for p, mx in reqs]
    injector().inject("serving.slot_evict", mode="raise", at_hit=9,
                      times=2)
    try:
        eng = DecodeEngine(program=prog, queue_limit=64,
                           max_prefills_per_step=2)
        handles, i, steps = [], 0, 0
        while i < len(reqs) or any(not h.done for h in handles):
            if i < len(reqs) and steps % 2 == 0:
                handles.append(eng.submit(*reqs[i]))
                i += 1
            eng.step_once()
            steps += 1
            assert steps < 4000
    finally:
        injector().clear()
    assert [h.result(timeout_s=0) for h in handles] == oracle
    stats = eng.stats()
    assert stats["evictions"] == 2 and stats["ctx_wraps"] >= 1
    assert stats["prefix_requests_hit"] >= 1
    assert model._jit_cache.trace_counts() == builds


@pytest.mark.cuda
def test_cuda_decode_engine_serves_from_its_loop_thread():
    """The engine served through its own loop thread on the card:
    `start()`, `generate`/`submit`, a StepWatchdog restart after a
    `decode.hang` wedge, and `stop()`; every output equals the port's
    `sequential_decode` bit for bit."""
    _need_cuda()
    import random
    import threading

    from deeplearning4j_tpu_torch.engine.decode_program import (
        DecodeProgram,
    )
    from deeplearning4j_tpu_torch.resilience.faults import injector
    from deeplearning4j_tpu_torch.serving.continuous import (
        DecodeEngine,
        sequential_decode,
    )
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalTransformer(vocab_size=64, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=64, seed=5).init()
    prog = DecodeProgram(model, max_slots=4, page_size=8)
    # a bare "cuda" would name device 0 in the loop thread, whatever
    # device the caller's thread had
    assert prog.device.index == model.params["tok_emb"].device.index
    rng = random.Random(2)
    reqs = [([rng.randrange(64) for _ in range(rng.randrange(2, 20))],
             rng.randrange(2, 14)) for _ in range(6)]
    oracle = [sequential_decode(prog, p, mx)[1] for p, mx in reqs]
    eng = DecodeEngine(program=prog, queue_limit=64)
    eng.start()
    try:
        h = eng.generate(*reqs[0], timeout_s=60.0)
        assert h.result(timeout_s=0) == oracle[0]
        handles = [eng.submit(p, mx) for p, mx in reqs]
        assert [h.result(timeout_s=60.0) for h in handles] == oracle
    finally:
        eng.stop()
    assert not eng.running
    injector().inject("decode.hang", mode="delay", delay_s=1.5,
                      at_hit=3, times=1)
    eng = DecodeEngine(program=prog, queue_limit=64,
                       watchdog_timeout_s=0.25, max_engine_restarts=3)
    eng.start()
    try:
        handles = [eng.submit(p, mx) for p, mx in reqs]
        assert [h.result(timeout_s=60.0) for h in handles] == oracle
        assert eng.stats()["engine_restarts"] == 1
    finally:
        eng.stop()
        injector().clear()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("DecodeEngine-loop") and t.is_alive()]


@pytest.mark.cuda
def test_cuda_model_server_and_hot_swap_on_the_card(tmp_path):
    """A port ModelServer over a narrow "pallas" graph on the card: npz
    responses equal `pi.output` on the same rows (f32, within 1e-5), the
    forward kernels launch on the served path, and a hot swap to a
    second net's zip under 4 clients gives zero failed and zero mixed
    responses (each within 1e-5 of its version's reference and far from
    the other's)."""
    _need_cuda()
    import threading
    import time

    from deeplearning4j_tpu_torch.parallel.serving import (
        ModelClient,
        ModelServer,
    )
    from deeplearning4j_tpu_torch.resilience import Retry
    from deeplearning4j_tpu_torch.util.model_serializer import write_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = _port_mini_resnet("pallas")
    zp = str(tmp_path / "v2.zip")
    write_model(_port_mini_resnet("pallas", seed=8), zp)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 16, 16, 3)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    server = ModelServer(net, model_name="m", batch_limit=8,
                         device="cuda").start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        tpc.reset_launch_counts()
        r = ModelClient(url).predict(x, model="m")
        assert tpc.launch_counts()["fused_conv1x1"] > 0
        assert tpc.launch_counts()["fused_conv3x3"] > 0
        np.testing.assert_allclose(r["outputs"], server.pi.output(x), **tol)
        refs = {"v1": np.asarray(r["outputs"])}
        stop = threading.Event()
        seen, bad = [], []
        lock = threading.Lock()

        def hammer():
            c = ModelClient(url, retry=Retry(max_attempts=1), breaker=None)
            while not stop.is_set():
                try:
                    resp = c.predict(x, model="m")
                except Exception as e:   # noqa: BLE001 - asserted empty
                    with lock:
                        bad.append(repr(e))
                    continue
                with lock:
                    seen.append((resp["version"],
                                 np.asarray(resp["outputs"])))

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            ModelClient(url, timeout=120.0).put_version("m", "v2", zp)
            refs["v2"] = server.pi.output(x)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                with lock:
                    if sum(v == "v2" for v, _ in seen) >= 10:
                        break
                time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60.0)
    finally:
        server.stop()
    assert not bad
    assert {v for v, _ in seen} >= {"v2"}
    assert np.abs(refs["v1"] - refs["v2"]).max() > 1e-3
    for v, out in seen:
        np.testing.assert_allclose(out, refs[v], **tol)
        other = refs["v2" if v == "v1" else "v1"]
        assert np.abs(out - other).max() > 1e-3


# k-NN on the card against an f64 brute force (TF32 off: exact f32
# matmuls), and one chunked t-SNE iteration on the card against the same
# iteration on the CPU from the same state, within TSNE_CARD_TOL of
# max(1, max|y|) (f32 block sums in another order, the reverse-edge
# index_add_ in another order)
TSNE_CARD_TOL = 1e-4


@pytest.mark.cuda
def test_cuda_knn_equals_brute_force(rng):
    _need_cuda()
    from deeplearning4j_tpu_torch.clustering import knn

    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = rng.normal(size=(5000, 64)).astype(np.float32)
    queries = rng.normal(size=(300, 64)).astype(np.float32)
    idx, dist = knn(queries, corpus, k=10, tile=128)
    assert idx.device.type == "cuda"
    brute = np.sqrt(((queries[:, None, :].astype(np.float64)
                      - corpus[None].astype(np.float64)) ** 2).sum(-1))
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  np.argsort(brute, axis=1)[:, :10])
    np.testing.assert_allclose(dist.cpu().numpy(),
                               np.sort(brute, axis=1)[:, :10], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_chunked_tsne_iteration_equals_the_cpus(rng):
    _need_cuda()
    from deeplearning4j_tpu_torch.clustering import Tsne
    from deeplearning4j_tpu_torch.clustering import tsne as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    x = np.concatenate([rng.normal(size=(700, 16)) + c
                        for c in (0.0, 5.0, -5.0)]).astype(np.float32)
    n, blk = x.shape[0], 256
    t = Tsne(perplexity=15.0, method="chunked", row_block=blk,
             device="cpu")
    idx, psym, mutual = t.sparse_affinities(torch.tensor(x))
    tc = Tsne(perplexity=15.0, method="chunked", row_block=blk)
    cidx, cpsym, cmutual = tc.sparse_affinities(torch.tensor(x).cuda())
    # the same neighbours, but where two lie within rounding of each
    # other (either order is right); the affinities agree where they match
    same = (cidx.cpu() == idx).numpy()
    assert same.mean() > 0.999
    np.testing.assert_allclose(cpsym.cpu().numpy()[same],
                               psym.numpy()[same], atol=1e-6)
    assert (cmutual.cpu().numpy() == mutual.numpy())[same].mean() > 0.999
    n_pad = -(-n // blk) * blk
    y = torch.cat([t.initial_embedding(n) * 1e4,
                   torch.full((n_pad - n, 2), 1e6)])
    vel = torch.zeros_like(y)
    args = (idx, psym, mutual, 12.0, 0.5, 200.0, blk, n)
    y1, _, kl = pt._chunked_step(y.clone(), vel.clone(), *args)
    yc, _, klc = pt._chunked_step(
        y.cuda(), vel.cuda(), *(a.cuda() for a in args[:3]), *args[3:])
    yc = yc.cpu().numpy()
    err = np.abs(yc[:n] - y1[:n].numpy()).max() / max(
        1.0, float(np.abs(y1[:n].numpy()).max()))
    assert err < TSNE_CARD_TOL
    assert float(klc) == pytest.approx(float(kl), rel=1e-5)
    assert (yc[n:] == 1e6).all()


# the dense word2vec tier: tables after one slab on the card against the
# CPU path, relative to max(1, max|CPU table|) (the card's scatter sums
# with float atomics, in another order than the CPU's)
NLP_CARD_TOL = 1e-4
NLP_MODES = {"sg-ns": dict(negative=5, use_cbow=False),
             "sg-hs": dict(negative=0, use_cbow=False),
             "cbow-ns": dict(negative=5, use_cbow=True),
             "cbow-hs": dict(negative=0, use_cbow=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NLP_MODES))
def test_cuda_dense_slab_matches_the_cpu(mode):
    """One dense slab (64 batches of 1024 rows, zipf-1.1 words) in each
    mode: the same packed rows on both devices, the trained tables within
    NLP_CARD_TOL."""
    _need_cuda()
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    vocab = 3000
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    c = rng.choice(vocab, size=60000, p=p / p.sum())
    seqs = [[f"w{i}" for i in c[k:k + 1000]]
            for k in range(0, c.size, 1000)]
    runs = {}
    for dev in ("cpu", "cuda"):
        sv = SequenceVectors(layer_size=64, window=5, seed=3, mode="dense",
                             dense_batch_size=1024, device=dev,
                             **NLP_MODES[mode])
        sv.build_vocab(seqs)
        shipped = []
        orig = sv._dispatch_slab

        def first_slab(tables, rows, lrs, W, hs_tabs):
            if shipped:
                return tables
            shipped.append(rows.copy())
            return orig(tables, rows, lrs, W, hs_tabs)

        sv._dispatch_slab = first_slab
        sv.fit(seqs)
        if dev == "cuda":
            assert sv._syn0_dev.device.type == "cuda"
        runs[dev] = (shipped[0], sv.syn0, sv.syn1, sv.syn1neg)
    np.testing.assert_array_equal(runs["cpu"][0], runs["cuda"][0])
    for want, got in zip(runs["cpu"][1:], runs["cuda"][1:]):
        assert (want is None) == (got is None)
        if want is not None:
            err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
            assert np.isfinite(got).all() and err < NLP_CARD_TOL


# ------------------------------------ tensor and sequence parallelism
def _mesh_gang(tmp_path, world, only, data, nets=None):
    """tests/fixtures/torch/mesh_worker.py's gang of `world` gloo ranks
    with CUDA tensors on the one card, over inputs written here with the
    port's own seeded nets; returns rank 0's arrays and every rank's
    facts."""
    import json
    import os
    import sys

    from deeplearning4j_tpu_torch.util.tree import leaves

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures", "torch")
    sys.path.insert(0, fixtures)
    from mesh_worker import launch

    io = str(tmp_path)
    spec, arrays = {"nets": {}, "helpers": {}}, {}
    for name, net in (nets or {}).items():
        spec["nets"][name] = ["mln", net.conf.to_json()]
        for prefix, tree in (("p", net.params), ("s", net.states)):
            for i, t in enumerate(leaves(tree)):
                arrays[f"{name}/{prefix}:{i}"] = t.numpy()
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(io, "nets.npz"), **arrays)
    np.savez(os.path.join(io, "data.npz"), **data)
    launch(os.path.join(fixtures, "mesh_worker.py"), io, world,
           ("--only", only, "--device", "cuda"))
    facts = []
    for r in range(world):
        with open(os.path.join(io, f"out-{r}.json")) as f:
            facts.append(json.load(f))
    return dict(np.load(os.path.join(io, "out-0.npz"))), facts


@pytest.mark.cuda
def test_cuda_ring_attention_over_two_ranks_matches_the_cpu(tmp_path):
    """ring_self_attention over sp 2 (two gloo ranks, CUDA tensors, the
    K/V hop through host buffers) against the port's one-process
    attention on the CPU, causal and not (JAX's ring bar, TF32 off)."""
    _need_cuda()
    from deeplearning4j_tpu_torch.parallel import make_mesh, ring_self_attention

    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    out, facts = _mesh_gang(tmp_path, 2, "ring_sp2",
                            {"ring_q": q, "ring_k": k, "ring_v": v})
    assert all(f["_failed"] == {} for f in facts)
    t = torch.from_numpy
    for name, causal in (("full", False), ("causal", True)):
        want = ring_self_attention(t(q), t(k), t(v), make_mesh(),
                                   causal=causal).numpy()
        np.testing.assert_allclose(out[f"ring_sp2/{name}:0"], want,
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_cuda_tp_fit_over_two_ranks_matches_the_cpu(tmp_path):
    """ParallelWrapper(tp=2) over two gloo ranks with CUDA tensors (the
    bucketed gathers, the column-parallel Dense and Output layers, the
    copy's all-reduce) against the same fit in one process on the CPU,
    at JAX's tp bar (rtol 1e-3, atol 1e-4)."""
    _need_cuda()
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    conf = (NeuralNetConfiguration.Builder().seed(7).updater("sgd")
            .learning_rate(0.1).activation("tanh").weight_init("xavier")
            .list().layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(16)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    out, facts = _mesh_gang(tmp_path, 2, "tp_mlp", {"mlp_x": x, "mlp_y": y},
                            nets={"mlp8": net})
    assert all(f["_failed"] == {} for f in facts)
    assert facts[0]["tp_mlp"]["mesh"] == {"dp": 1, "pp": 1, "sp": 1,
                                          "ep": 1, "tp": 2}
    assert facts[1]["tp_mlp"]["memory"]["param_fraction"] < 0.52
    net.fit([(x, y)] * 3)
    got = [out[f"tp_mlp/params:{i}"] for i in range(len(leaves(net.params)))]
    for a, b in zip(got, leaves(net.params)):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_cuda_flagship_step_record_runs_bf16_wgmma_without_host_reads():
    """The program lint (analysis/program_lint.py) on the card: the
    flagship ResNet-50 "pallas" bf16 train step's record launches every
    call of the four kernels on the bf16 "wgmma" route, with no
    prog-hidden-host-transfer and no prog-unhonored-donation finding."""
    _need_cuda()
    from deeplearning4j_tpu_torch.analysis import program_lint
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(num_classes=16, input_shape=(64, 64, 3),
                   compute_dtype="bfloat16",
                   helpers="pallas").init_model(device="cuda")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    y = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 8)]
    (rec,) = StepProgram(net).lint_records(x, y)
    finds, (rep,) = program_lint.run_with_reports([rec])
    kern = rep["kernels"]
    assert {k.split("/")[0] for k in kern} == {
        "fused_conv1x1", "fused_conv3x3", "dgrad_conv1x1", "wgrad_conv1x1"}
    assert all(k.endswith("/wgmma/bf16") for k in kern), kern
    assert rep["host_sync_ops"] == 0
    bad = {f.rule for f in finds} & {"prog-hidden-host-transfer",
                                     "prog-unhonored-donation"}
    assert not bad, [f.render() for f in finds]


# ------------------------------------- captured groups over NCCL, world 2
@pytest.mark.cuda
def test_cuda_nccl_gang_captures_k_step_groups_at_world_two(tmp_path):
    """ROADMAP F11: run_group(4) with its NCCL collectives captured at
    world 2 (two cards, one rank each; tests/fixtures/torch/
    scaleout_worker.py): ZeRO-1 under TrainingMaster and per-step dp with
    global BatchNorm sums under ParallelWrapper. Each replays its group
    with the collectives inside and equals its k=1 run (rtol 1e-4, atol
    1e-5, the NCCL gang's tolerance against the CPU); an eager all-reduce
    after the replays returns the right sum, and every rank's teardown
    (the process group destroyed after the graphs) returns."""
    import json
    import os
    import subprocess
    import sys

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

    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL takes one rank per card)")
    confs = {
        "conv": (NeuralNetConfiguration.Builder().seed(3).updater("sgd")
                 .learning_rate(0.05).weight_init("xavier").list()
                 .layer(ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                         activation="relu"))
                 .layer(BatchNormalization())
                 .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                 .layer(OutputLayer(n_out=3, loss="mcxent"))
                 .set_input_type(InputType.convolutional(8, 8, 1)).build()),
        "adam24": (NeuralNetConfiguration.Builder().seed(7).updater("adam")
                   .learning_rate(1e-2).activation("tanh")
                   .weight_init("xavier").list()
                   .layer(DenseLayer(n_out=24))
                   .layer(OutputLayer(n_out=24, loss="mcxent"))
                   .set_input_type(InputType.feed_forward(24)).build())}
    io = str(tmp_path)
    spec, arrays = {"nets": {}, "helpers": {}}, {}
    for name, conf in confs.items():
        net = MultiLayerNetwork(conf, device="cpu").init()
        spec["nets"][name] = ["mln", conf.to_json()]
        for prefix, tree in (("p", net.params), ("s", net.states)):
            for i, t in enumerate(leaves(tree)):
                arrays[f"{name}/{prefix}:{i}"] = t.numpy()
    rng = np.random.default_rng(19)
    x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    x[8:] = x[8:] * 3 + 1
    data = {"conv_x": x,
            "conv_y": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)],
            "z_x": rng.normal(size=(8, 16, 24)).astype(np.float32),
            "z_y": np.eye(24, dtype=np.float32)[
                rng.integers(0, 24, (8, 16))]}
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(io, "nets.npz"), **arrays)
    np.savez(os.path.join(io, "data.npz"), **data)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "fixtures", "torch",
                          "scaleout_worker.py")
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, worker, "--rank", str(r), "--world", "2",
         "--port", str(port), "--io", io, "--backend", "nccl", "--only",
         "zero1_groups,dp_groups"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = dict(np.load(os.path.join(io, "out-0.npz")))
    with open(os.path.join(io, "out-0.json")) as f:
        facts = json.load(f)
    for k4, k1, kinds in (("z1_k4", "z1_k1", ("reduce_scatter",
                                              "all_reduce", "all_gather")),
                          ("dp_k4", "dp_k1", ("all_reduce",))):
        keys = [k for k in out if k.startswith(k1 + "/")]
        assert keys
        for key in keys:
            np.testing.assert_allclose(out[k4 + key[len(k1):]], out[key],
                                       rtol=1e-4, atol=1e-5)
        f = facts[k4]
        assert f["replays"] == 2, f
        (coll,) = f["collectives"].values()
        assert all(coll.get(kind, 0) >= 4 for kind in kinds), coll
        assert f["eager_after"] == 3.0
