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
