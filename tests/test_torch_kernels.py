"""The port's fused conv kernels (deeplearning4j_tpu_torch/nn/helpers/
pallas_conv.py, fused_ops.py) against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held here against the JAX Pallas kernels (interpret mode, as
tests/test_pallas_kernels.py runs them) and the `ref_*` oracles, at that
file's tolerances. The CUDA kernels themselves are held against the plain
versions by the `cuda`-marked tests/test_torch_cuda.py (skipped without a
card) and by chip_smoke.py on the H100."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.nn.helpers import fused_ops as jfo
from deeplearning4j_tpu.nn.helpers import pallas_conv as jpc
from deeplearning4j_tpu_torch.nn.helpers import fused_ops as tfo
from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as tpc


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(a):
    return None if a is None else np.asarray(a)


VARIANTS_1X1 = ["plain", "affine", "affine_relu", "full", "add_only"]


def _args_1x1(rng, variant, M=128, K=32, N=16):
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


def _conv(f, a, kw, cast):
    kw = {k: (cast(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return f(cast(a["x"]), cast(a["w"]), cast(a["b"]), **kw)


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("variant", VARIANTS_1X1)
def test_conv1x1_plain_matches_jax(rng, variant, oracle):
    a, kw = _args_1x1(rng, variant)
    jf = jpc.fused_conv1x1 if oracle == "pallas" else jpc.ref_fused_conv1x1
    y, ssum, ssq, u = _conv(tpc.fused_conv1x1, a, kw, _t)   # CPU: plain
    yr, sr, qr, ur = _conv(jf, a, kw, _j)
    np.testing.assert_allclose(y.numpy(), _np(yr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ssum.numpy(), _np(sr), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ssq.numpy(), _np(qr), rtol=1e-4, atol=1e-3)
    if kw.get("emit_u"):
        np.testing.assert_allclose(u.numpy(), _np(ur), rtol=1e-5, atol=1e-6)
    else:
        assert u is None


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("variant", ["plain", "affine", "affine_relu",
                                     "relu_only"])
def test_conv3x3_plain_matches_jax(rng, variant, oracle):
    B, H, C, N = 2, 8, 8, 8
    a = {"x": rng.normal(size=(B, H, H, C)).astype(np.float32),
         "w": (rng.normal(size=(3, 3, C, N)) * 0.1).astype(np.float32),
         "b": rng.normal(size=(N,)).astype(np.float32)}
    kw = {}
    if variant in ("affine", "affine_relu"):
        kw["scale"] = (rng.normal(size=(C,)) * 0.5 + 1).astype(np.float32)
        kw["shift"] = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    if variant in ("affine_relu", "relu_only"):
        kw["relu"] = True
    jf = jpc.fused_conv3x3 if oracle == "pallas" else jpc.ref_fused_conv3x3
    y, ssum, ssq = _conv(tpc.fused_conv3x3, a, kw, _t)
    yr, sr, qr = _conv(jf, a, kw, _j)
    np.testing.assert_allclose(y.numpy(), _np(yr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ssum.numpy(), _np(sr), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(ssq.numpy(), _np(qr), rtol=1e-4, atol=1e-2)


def test_cpu_wrappers_take_plain_version_and_count_nothing(rng):
    a, kw = _args_1x1(rng, "full")
    tpc.reset_launch_counts()
    got = _conv(tpc.fused_conv1x1, a, kw, _t)
    ref = _conv(tpc.ref_fused_conv1x1, a, kw, _t)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    y, ssum, ssq, u = _conv(tpc.fused_conv1x1, a, dict(kw, stats=False), _t)
    assert torch.equal(y, got[0]) and torch.equal(u, got[3])
    assert ssum is None and ssq is None
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 2)).astype(np.float32))
    for g, r in zip(tpc.fused_conv3x3(x, w, None),
                    tpc.ref_fused_conv3x3(x, w, None)):
        assert torch.equal(g, r)
    assert tpc.LAUNCHES == {"fused_conv1x1": 0, "fused_conv3x3": 0,
                            "dgrad_conv1x1": 0, "wgrad_conv1x1": 0}


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    x = torch.empty((4, 4), device="meta")
    w = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpc.fused_conv1x1(x, w, None)
    with pytest.raises(ValueError, match="CUDA"):
        tpc.fused_conv3x3(torch.empty((1, 4, 4, 4), device="meta"),
                          torch.empty((3, 3, 4, 2), device="meta"), None)


def test_conv_bn_act_inference_form_matches_jax(rng):
    M, K, N = 64, 16, 8
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    gamma = np.full((N,), 1.5, np.float32)
    beta = np.full((N,), 0.2, np.float32)
    mean = rng.normal(size=(N,)).astype(np.float32)
    var = (rng.random(N) + 0.5).astype(np.float32)
    args = (x, w, b, gamma, beta, mean, var)
    out = tpc.fused_conv_bn_act(*[_t(v) for v in args])
    ref = jpc.fused_conv_bn_act(*[_j(v) for v in args])
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-4, atol=1e-4)
    x3 = rng.normal(size=(2, 6, 6, K)).astype(np.float32)
    w3 = (rng.normal(size=(3, 3, K, N)) * 0.1).astype(np.float32)
    args3 = (x3, w3, b, gamma, beta, mean, var)
    out3 = tpc.fused_conv_bn_act(*[_t(v) for v in args3])
    ref3 = jpc.fused_conv_bn_act(*[_j(v) for v in args3])
    np.testing.assert_allclose(out3.numpy(), _np(ref3), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="3x3"):
        tpc.fused_conv_bn_act(torch.zeros((2, 8, 8, 4)),
                              torch.zeros((5, 5, 4, 8)), None,
                              *[_t(v) for v in (gamma, beta, mean, var)])


# (kernel, stride, two_branch, scaled_x2, relu, with_stats)
FUSED_CASES = [
    ((1, 1), (1, 1), False, False, True, 1),
    ((1, 1), (1, 1), True, True, True, 1),
    ((1, 1), (1, 1), True, False, True, 0),
    ((1, 1), (1, 1), False, False, False, 0),
    ((3, 3), (1, 1), False, False, True, 1),
    ((3, 3), (1, 1), True, True, True, 0),
    ((3, 3), (2, 2), False, False, True, 1),
    ((1, 1), (2, 2), True, True, True, 1),
    ((7, 7), (2, 2), False, False, False, 1),
]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=[f"k{c[0][0]}s{c[1][0]}x2{int(c[2])}"
                              f"sc{int(c[3])}r{int(c[4])}st{c[5]}"
                              for c in FUSED_CASES])
def test_fused_conv_forward_matches_jax(rng, case, impl):
    kernel, stride, two, scaled, relu, with_stats = case
    B, H, C, N = 2, 9, 6, 5
    x = rng.normal(size=(B, H, H, C)).astype(np.float32)
    w = (rng.normal(size=kernel + (C, N)) * 0.2).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    s1 = (rng.normal(size=(C,)) * 0.3 + 1).astype(np.float32)
    t1 = (rng.normal(size=(C,)) * 0.2).astype(np.float32)
    x2 = rng.normal(size=(B, H, H, C)).astype(np.float32) if two else None
    s2 = (rng.normal(size=(C,)) * 0.3 + 1).astype(np.float32) \
        if two and scaled else None
    t2 = (rng.normal(size=(C,)) * 0.2).astype(np.float32) \
        if two and scaled else None
    args = (x, w, b, s1, t1, x2, s2, t2)
    yt, st, qt, ut = tfo.fused_conv(*[_t(a) for a in args], stride, "SAME",
                                    relu, with_stats, impl)
    yj, sj, qj, uj = jfo.fused_conv(*[_j(a) for a in args], stride, "SAME",
                                    relu, with_stats, impl)
    np.testing.assert_allclose(yt.numpy(), _np(yj), rtol=1e-4, atol=1e-4)
    if with_stats:
        np.testing.assert_allclose(st.numpy(), _np(sj), rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(qt.numpy(), _np(qj), rtol=1e-4, atol=1e-2)
    else:   # the port computes no statistics that were not asked for
        assert st is None and qt is None
        assert not np.any(_np(sj)) and not np.any(_np(qj))
    np.testing.assert_allclose(ut.numpy(), _np(uj), rtol=1e-6, atol=1e-6)


def test_kernel_route_by_geometry():
    assert tfo.kernel_route((1, 1, 8, 8), (1, 1), "SAME", (14, 14)) \
        == "conv1x1"
    assert tfo.kernel_route((3, 3, 8, 8), (1, 1), "SAME", (14, 14)) \
        == "conv3x3"
    assert tfo.kernel_route((3, 3, 8, 8), (1, 1), ((1, 1), (1, 1)),
                            (14, 14)) == "conv3x3"
    assert tfo.kernel_route((3, 3, 8, 8), (1, 1), "VALID", (14, 14)) is None
    assert tfo.kernel_route((3, 3, 8, 8), (2, 2), "SAME", (14, 14)) is None
    assert tfo.kernel_route((1, 1, 8, 8), (2, 2), "SAME", (14, 14)) is None
    assert tfo.kernel_route((7, 7, 3, 8), (2, 2), "SAME", (224, 224)) is None
