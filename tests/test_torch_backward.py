"""The port's fused conv backward against the JAX package.

On the CPU the dgrad/wgrad wrappers run their plain PyTorch versions;
those are held here against the JAX Pallas kernels (interpret mode, as
tests/test_pallas_kernels.py runs them). The port's `fused_conv` autograd
Function is held against `jax.grad` of the JAX package's custom-VJP op,
for both impls, at the JAX test's tolerance (rtol 5e-4, atol 5e-5), and
checked by `torch.autograd.gradcheck` in float64. The CUDA kernels are
held against the plain versions by tests/test_torch_cuda.py on a card and
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.helpers import fused_ops as jfo
from deeplearning4j_tpu.nn.helpers import pallas_conv as jpc
from deeplearning4j_tpu_torch.nn.helpers import fused_ops as tfo
from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as tpc

GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(a):
    return None if a is None else np.asarray(a)


# (two_branch, scaled_x2, with_duo, relu): the four cases of
# test_pallas_backward_matches_xla, plus a plain (unscaled) second branch
BWD_CASES = [(False, False, False, True), (True, True, False, True),
             (False, False, True, False), (True, True, True, True),
             (True, False, True, True)]


def _bwd_inputs(rng, case, with_stats, M=128, K=8, N=16):
    two, scaled, duo, relu = case
    f = lambda *s, sc=1.0, off=0.0: (rng.normal(size=s) * sc + off).astype(
        np.float32)
    a = dict(dy=f(M, N), y=f(M, N), w=f(K, N, sc=0.2), x=f(M, K),
             x2=f(M, K) if two else None, du_out=f(M, K) if duo else None,
             scale=f(K, sc=0.3, off=1.0), shift=f(K, sc=0.2),
             scale2=f(K, sc=0.3, off=1.0) if two and scaled else None,
             shift2=f(K, sc=0.2) if two and scaled else None,
             dssum=f(N, sc=0.1) if with_stats else None,
             dssq=f(N, sc=0.05) if with_stats else None)
    return a, relu


def _ids(cases):
    return [f"x2{int(c[0])}sc{int(c[1])}duo{int(c[2])}r{int(c[3])}"
            for c in cases]


@pytest.mark.parametrize("with_stats", [0, 1])
@pytest.mark.parametrize("case", BWD_CASES, ids=_ids(BWD_CASES))
def test_ref_dgrad_matches_jax_kernel(rng, case, with_stats):
    a, relu = _bwd_inputs(rng, case, with_stats)
    order = ("dy", "y", "w", "x", "x2", "du_out", "scale", "shift", "scale2",
             "shift2", "dssum", "dssq")
    got = tpc.dgrad_conv1x1(*[_t(a[k]) for k in order], relu=relu)
    ref = jpc.dgrad_conv1x1(*[_j(a[k]) for k in order], relu=relu)
    names = ("dx1", "dx2", "ds1", "dt1", "ds2", "dt2", "db")
    for name, g, r in zip(names, got, ref):
        assert (g is None) == (r is None), name
        if g is not None:
            np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-5,
                                       atol=1e-4, err_msg=name)


@pytest.mark.parametrize("with_stats", [0, 1])
@pytest.mark.parametrize("case", BWD_CASES, ids=_ids(BWD_CASES))
def test_ref_wgrad_matches_jax_kernel(rng, case, with_stats):
    a, relu = _bwd_inputs(rng, case, with_stats)
    order = ("dy", "y", "x", "x2", "scale", "shift", "scale2", "shift2",
             "dssum", "dssq")
    got = tpc.wgrad_conv1x1(*[_t(a[k]) for k in order], relu=relu)
    ref = jpc.wgrad_conv1x1(*[_j(a[k]) for k in order], relu=relu)
    assert got.dtype == torch.float32 and got.shape == (8, 16)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-4)


def test_cpu_backward_wrappers_take_plain_version_and_count_nothing(rng):
    a, relu = _bwd_inputs(rng, BWD_CASES[3], 1)
    tpc.reset_launch_counts()
    order = ("dy", "y", "w", "x", "x2", "du_out", "scale", "shift", "scale2",
             "shift2", "dssum", "dssq")
    args = [_t(a[k]) for k in order]
    for g, r in zip(tpc.dgrad_conv1x1(*args, relu=relu),
                    tpc.ref_dgrad_conv1x1(*args, relu=relu)):
        assert torch.equal(g, r)
    wargs = [args[i] for i in (0, 1, 3, 4, 6, 7, 8, 9, 10, 11)]
    assert torch.equal(tpc.wgrad_conv1x1(*wargs, relu=relu),
                       tpc.ref_wgrad_conv1x1(*wargs, relu=relu))
    assert tpc.LAUNCHES["dgrad_conv1x1"] == tpc.LAUNCHES["wgrad_conv1x1"] == 0


def test_backward_wrappers_refuse_non_cpu_non_cuda_tensors():
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpc.dgrad_conv1x1(m(4, 2), m(4, 2), m(3, 2), m(4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tpc.wgrad_conv1x1(m(4, 2), m(4, 2), m(4, 3))


def test_wgrad_splits_bound_blocks_rows_and_scratch():
    # stage-2 shape at batch 128: one 64x64 output tile, M split widely
    assert tpc.wgrad_splits(401408, 64, 64) == tpc.WGRAD_BLOCKS
    # 7x7 stage: many output tiles, few splits, scratch within its limit
    s = tpc.wgrad_splits(6272, 512, 2048)
    assert 1 <= s <= 4 and s * 512 * 2048 <= tpc.WGRAD_SCRATCH
    assert tpc.wgrad_splits(100, 8, 8) == 1       # fewer rows than a split


# ----------------------------------------------- fused_conv gradients


# (kernel, stride, two_branch, scaled_x2, relu, with_stats, with_duo)
GRAD_CASES = [
    ((1, 1), (1, 1), False, False, True, 1, False),
    ((1, 1), (1, 1), True, True, True, 1, True),
    ((1, 1), (1, 1), True, False, True, 1, True),
    ((1, 1), (1, 1), False, False, False, 0, False),
    ((1, 1), (1, 1), False, False, True, 2, False),
    ((3, 3), (1, 1), False, False, True, 1, False),
    ((3, 3), (1, 1), True, True, True, 1, True),
    ((3, 3), (1, 1), False, False, True, 2, True),
    ((3, 3), (2, 2), False, False, True, 1, False),
    ((1, 1), (2, 2), True, True, True, 1, False),
    ((7, 7), (2, 2), False, False, False, 1, False),
]


def _grad_inputs(rng, case, B=3, H=8, C=6, N=5):
    kernel, stride, two, scaled, relu, with_stats, duo = case
    f = lambda *s, sc=1.0, off=0.0: (rng.normal(size=s) * sc + off).astype(
        np.float32)
    args = [f(B, H, H, C), f(*kernel, C, N, sc=0.2), f(N),
            f(C, sc=0.3, off=1.0), f(C, sc=0.2),
            f(B, H, H, C) if two else None,
            f(C, sc=0.3, off=1.0) if two and scaled else None,
            f(C, sc=0.2) if two and scaled else None]
    return args


def _objective(y, ssum, ssq, u, with_duo, lib):
    out = lib.sum(y * y)
    if ssum is not None:
        out = out + lib.sum(ssum * ssum) + 0.1 * lib.sum(ssq)
    if with_duo:
        out = out + lib.sum(u * u)
    return out


def _grad_ids(cases):
    return [f"k{c[0][0]}s{c[1][0]}x2{int(c[2])}sc{int(c[3])}r{int(c[4])}"
            f"st{c[5]}duo{int(c[6])}" for c in cases]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=_grad_ids(GRAD_CASES))
def test_fused_conv_gradients_match_jax(rng, case, impl):
    kernel, stride, two, scaled, relu, with_stats, duo = case
    args = _grad_inputs(rng, case)
    live = [i for i, a in enumerate(args) if a is not None]

    def jf(*xs):
        full = list(args)
        for i, v in zip(live, xs):
            full[i] = v
        full = [_j(v) for v in full]
        y, ssum, ssq, u = jfo.fused_conv(*full, stride, "SAME", relu,
                                         with_stats, impl)
        return _objective(y, ssum, ssq, u, duo, jnp)

    jg = jax.grad(jf, argnums=tuple(range(len(live))))(
        *[_j(args[i]) for i in live])
    tin = [_t(a) for a in args]
    for i in live:
        tin[i].requires_grad_(True)
    y, ssum, ssq, u = tfo.fused_conv(*tin, stride, "SAME", relu, with_stats,
                                     impl, emit_u=duo)
    assert (ssum is None) == (with_stats == 0)
    assert (u is None) == (not duo)
    _objective(y, ssum, ssq, u, duo, torch).backward()
    for i, g in zip(live, jg):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(g),
                                   err_msg=f"arg {i}", **GRAD_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kernel", [(1, 1), (3, 3)])
def test_fused_conv_gradcheck_float64(impl, kernel):
    gen = torch.Generator().manual_seed(3)
    r = lambda *s, sc=1.0, off=0.0: (torch.randn(
        *s, generator=gen, dtype=torch.float64) * sc + off).requires_grad_()
    B, H, C, N = 1, 4, 2, 3
    args = (r(B, H, H, C), r(*kernel, C, N, sc=0.3), r(N),
            r(C, sc=0.3, off=1.0), r(C, sc=0.2), r(B, H, H, C),
            r(C, sc=0.3, off=1.0), r(C, sc=0.2))

    def f(*xs):
        y, ssum, ssq, u = tfo.fused_conv(*xs, (1, 1), "SAME", True, 1, impl,
                                         emit_u=True)
        return y, ssum, ssq, u

    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def test_pallas_and_composed_backward_agree_in_port(rng):
    """Within the port, f32: the dgrad/wgrad route and the composed
    route give the same gradients up to f32 summation order."""
    case = GRAD_CASES[1]
    args = _grad_inputs(rng, case)
    grads = {}
    for impl in ("xla", "pallas"):
        tin = [None if a is None else _t(a).requires_grad_() for a in args]
        y, ssum, ssq, u = tfo.fused_conv(*tin, (1, 1), "SAME", True, 1, impl)
        _objective(y, ssum, ssq, u, True, torch).backward()
        grads[impl] = [None if t is None else t.grad for t in tin]
    for i, (a, b) in enumerate(zip(grads["xla"], grads["pallas"])):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=f"arg {i}")
