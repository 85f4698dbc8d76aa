"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; they skip without a CUDA device. This file imports no
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
