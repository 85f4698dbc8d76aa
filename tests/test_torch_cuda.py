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
# fallback); a small grid with a deep K (many chunks per tile)
SHAPES_1X1 = [(200, 72, 136), (77, 13, 9), (100, 1024, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES_1X1,
                         ids=["vec", "scalar", "deep_k"])
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


# (B, H, C, N), as for SHAPES_1X1
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 24, 40), (2, 9, 5, 7),
                                   (1, 5, 128, 40)],
                         ids=["vec", "scalar", "deep_k"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["1x1", "3x3"])
def test_cuda_kernels_without_stats_give_the_same_y(rng, kind):
    _need_cuda()
    dt = torch.bfloat16
    if kind == "1x1":
        x = torch.from_numpy(rng.normal(size=(200, 72))).cuda().to(dt)
        w = torch.from_numpy(rng.normal(size=(72, 136)) * 0.1).cuda().to(dt)
        f = tpc.fused_conv1x1
    else:
        x = torch.from_numpy(rng.normal(size=(2, 9, 9, 24))).cuda().to(dt)
        w = torch.from_numpy(rng.normal(size=(3, 3, 24, 40)) * 0.1) \
            .cuda().to(dt)
        f = tpc.fused_conv3x3
    with_stats = f(x, w, None)
    without = f(x, w, None, stats=False)
    torch.cuda.synchronize()
    assert torch.equal(with_stats[0], without[0])
    assert without[1] is None and without[2] is None


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
