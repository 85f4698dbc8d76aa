"""Fused convolution kernels for Hopper (counterpart of
deeplearning4j_tpu/nn/helpers/pallas_conv.py).

The JAX package's Pallas kernels for the TPU become CUDA C++ kernels for
sm_90a (csrc/fused_conv1x1.cu, csrc/fused_conv3x3.cu; built and bound by
kernel_build.py). Each kernel keeps its TPU counterpart's contract:

  PROLOGUE  u = relu?(scale*x + shift [+ add]) as the input is loaded —
            BN-apply/activation/residual-add never round-trip memory;
  MATMUL    1x1: rows [M=B*H*W, K] @ W [K, N]; 3x3 SAME stride 1: an
            implicit GEMM over K = 9*C with the zero padding applied to u;
  EPILOGUE  bias, rounding to the compute dtype, and per-channel
            sum / sum-of-squares of the rounded output (`stats=False`:
            skipped, for the inference path that reads no statistics).

Every kernel has a plain PyTorch version beside it with the same
signature and rounding points (`ref_fused_conv1x1`, `ref_fused_conv3x3`).
The wrappers take the plain version only for tensors on the CPU; for a
CUDA tensor they launch the kernel or raise. `LAUNCHES` counts kernel
launches (one per wrapper call that launched), so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.helpers import kernel_build

# launches per kernel wrapper; reset with reset_launch_counts()
LAUNCHES = {"fused_conv1x1": 0, "fused_conv3x3": 0}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _vec_f32(v, n: int, what: str, device):
    """Optional [n] vector as a contiguous f32 CUDA tensor (the wrapper's
    `.astype(f32)`, as in the TPU launcher)."""
    if v is None:
        return None
    _require(tuple(v.shape) in ((n,), (1, n)), f"{what} must be [{n}], got {tuple(v.shape)}")
    _require(v.device == device, f"{what} is on {v.device}, x on {device}")
    return v.reshape(n).to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_operand(t, what, shape, dtype, device):
    _require(t.device == device, f"{what} is on {t.device}, x on {device}")
    _require(tuple(t.shape) == tuple(shape),
             f"{what} must be {tuple(shape)}, got {tuple(t.shape)}")
    _require(t.dtype == dtype, f"{what} must be {dtype}, got {t.dtype}")
    _require(t.is_contiguous(), f"{what} must be contiguous")


def _check_x(x, ndim):
    if x.device.type != "cuda":
        raise ValueError(
            f"fused conv kernels run on CUDA tensors (or their plain "
            f"version on CPU tensors); got a tensor on {x.device}")
    _require(x.ndim == ndim, f"x must be {ndim}-D, got {tuple(x.shape)}")
    _require(x.dtype in _KERNEL_DTYPES,
             f"x dtype {x.dtype} not supported (float32, bfloat16)")
    _require(x.is_contiguous(), "x must be contiguous")


def _stats_buffers(m, n, device, lib, stats):
    """Per-row-tile statistics partials and the ssum/ssq outputs (all
    None when no statistics are asked for)."""
    if not stats:
        return None, None, None
    f32 = dict(dtype=torch.float32, device=device)
    tiles = -(-m // lib.dl4j_conv_row_tile())
    return (torch.empty((2, tiles, n), **f32), torch.empty((n,), **f32),
            torch.empty((n,), **f32))


# --------------------------------------------------------------- 1x1 conv


def fused_conv1x1(x, w, b, scale=None, shift=None, add=None,
                  relu: bool = False, emit_u: bool = False,
                  stats: bool = True):
    """Fused 1x1 conv: y = relu(scale*x + shift [+ add]) @ w + b, with
    per-channel sum/sumsq of y as byproducts.

    x: [M, K] (flattened B*H*W rows), w: [K, N], b: [N] or None,
    scale/shift: [K] (f32), add: [M, K] (plain tensor, post-affine,
    pre-relu). Returns (y [M, N], ssum [N] f32, ssq [N] f32, u or None);
    ssum/ssq are None when `stats` is False.
    """
    if x.device.type == "cpu":
        return ref_fused_conv1x1(x, w, b, scale, shift, add, relu, emit_u,
                                 stats)
    _check_x(x, 2)
    m, k = x.shape
    dev = x.device
    _require(w.ndim == 2 and w.shape[0] == k, f"w must be [{k}, N], got {tuple(w.shape)}")
    n = w.shape[1]
    _check_operand(w, "w", (k, n), x.dtype, dev)
    _require((scale is None) == (shift is None), "scale and shift go together")
    if add is not None:
        _check_operand(add, "add", (m, k), x.dtype, dev)
    b32 = _vec_f32(b, n, "b", dev)
    s32 = _vec_f32(scale, k, "scale", dev)
    t32 = _vec_f32(shift, k, "shift", dev)
    lib = kernel_build.load("fused_conv1x1")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    u = torch.empty((m, k), dtype=x.dtype, device=dev) if emit_u else None
    partial, ssum, ssq = _stats_buffers(m, n, dev, lib, stats)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_conv1x1_launch(
        int(x.dtype == torch.bfloat16), _ptr(x), _ptr(w), _ptr(b32),
        _ptr(s32), _ptr(t32), _ptr(add), _ptr(y), _ptr(partial), _ptr(ssum),
        _ptr(ssq), _ptr(u), m, k, n, int(bool(relu)), stream)
    kernel_build.check(lib, rc, "fused_conv1x1")
    LAUNCHES["fused_conv1x1"] += 1
    return y, ssum, ssq, u


# --------------------------------------------------------------- 3x3 conv


def fused_conv3x3(x, w, b, scale=None, shift=None, relu: bool = False,
                  stats: bool = True):
    """Fused 3x3 SAME stride-1 conv over NHWC with affine+relu prologue
    and channel-stats epilogue.

    x: [B, H, W, C]; w: [3, 3, C, N] (HWIO); b: [N] or None.
    Returns (y [B, H, W, N], ssum [N] f32, ssq [N] f32); ssum/ssq are
    None when `stats` is False.
    """
    if x.device.type == "cpu":
        return ref_fused_conv3x3(x, w, b, scale, shift, relu, stats)
    _check_x(x, 4)
    bsz, h, wd, c = x.shape
    dev = x.device
    _require(w.ndim == 4 and tuple(w.shape[:3]) == (3, 3, c),
             f"w must be [3, 3, {c}, N], got {tuple(w.shape)}")
    n = w.shape[3]
    _check_operand(w, "w", (3, 3, c, n), x.dtype, dev)
    _require((scale is None) == (shift is None), "scale and shift go together")
    b32 = _vec_f32(b, n, "b", dev)
    s32 = _vec_f32(scale, c, "scale", dev)
    t32 = _vec_f32(shift, c, "shift", dev)
    lib = kernel_build.load("fused_conv3x3")
    y = torch.empty((bsz, h, wd, n), dtype=x.dtype, device=dev)
    partial, ssum, ssq = _stats_buffers(bsz * h * wd, n, dev, lib, stats)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_conv3x3_launch(
        int(x.dtype == torch.bfloat16), _ptr(x), _ptr(w), _ptr(b32),
        _ptr(s32), _ptr(t32), _ptr(y), _ptr(partial), _ptr(ssum), _ptr(ssq),
        bsz, h, wd, c, n, int(bool(relu)), stream)
    kernel_build.check(lib, rc, "fused_conv3x3")
    LAUNCHES["fused_conv3x3"] += 1
    return y, ssum, ssq


# --------------------------------------------------------- plain versions


def affine(x, scale, shift):
    """scale*x + shift with scale/shift rounded to x's dtype first and
    each op rounding to x's dtype: the kernels' prologue rounding points."""
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def prologue(x, scale=None, shift=None, add=None, relu=False):
    """u = relu?(affine(x) [+ add]) — the one torch form of the kernels'
    prologue, shared by the plain versions and the fused executor."""
    u = x if scale is None else affine(x, scale, shift)
    if add is not None:
        u = u + add
    if relu:
        u = torch.clamp_min(u, 0)
    return u


def _channel_stats(y, dims, stats):
    if not stats:
        return None, None
    yf = y.float()
    return yf.sum(dims), (yf * yf).sum(dims)


def ref_fused_conv1x1(x, w, b, scale=None, shift=None, add=None,
                      relu=False, emit_u=False, stats=True):
    """Plain PyTorch version of fused_conv1x1 (same rounding points:
    each prologue op rounds to x's dtype, the product accumulates in
    f32, the bias joins in f32, one rounding to x's dtype)."""
    u = prologue(x, scale, shift, add, relu)
    acc = u.float() @ w.float()
    if b is not None:
        acc = acc + b.float()
    y = acc.to(x.dtype)
    return (y, *_channel_stats(y, 0, stats), (u if emit_u else None))


def ref_fused_conv3x3(x, w, b, scale=None, shift=None, relu=False,
                      stats=True):
    """Plain PyTorch version of fused_conv3x3."""
    u = prologue(x, scale, shift, None, relu)
    acc = F.conv2d(u.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1), padding=1)
    acc = acc.permute(0, 2, 3, 1)
    if b is not None:
        acc = acc + b.float()
    y = acc.to(x.dtype)
    return (y, *_channel_stats(y, (0, 1, 2), stats))


def fused_conv_bn_act(x, w, b, gamma, beta, mean, var, eps=1e-5,
                      relu=True):
    """One conv with BN-apply(+relu) of the GIVEN statistics on its output
    side — the standalone inference form.

    w: [K, N] (1x1 conv over flattened rows x [M, K]) or [3, 3, C, N]
    (x [B, H, W, C])."""
    if w.ndim == 4 and tuple(w.shape[:2]) != (3, 3):
        raise ValueError(
            f"pallas helper supports 1x1 (2-D w) or 3x3 kernels, got "
            f"{tuple(w.shape[:2])}; use the torch path for other geometries")
    s = gamma * torch.rsqrt(var + eps)
    t = beta - mean * s
    if w.ndim == 2:
        y = fused_conv1x1(x, w, b, stats=False)[0]
    else:
        y = fused_conv3x3(x, w, b, stats=False)[0]
    return prologue(y, s, t, relu=relu)
