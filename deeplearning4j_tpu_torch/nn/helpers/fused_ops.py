"""Fused conv+BN+activation op (counterpart of
deeplearning4j_tpu/nn/helpers/fused_ops.py).

Activations cross layers as (raw conv output, per-channel affine) pairs:

    u     = relu(scale*x + shift [+ scale2*x2 + shift2])  # BN-apply(+add)
    y_raw = conv(u, W) + b
    ssum, ssq = channel sums of y_raw                     # stats epilogue

`fused_conv` is a `torch.autograd.Function` (the JAX package's custom VJP):
its forward saves only x, x2, y and the [C] vectors — never u — and its
backward recomputes u. The BN backward needs no hand derivation: the
scale/shift cotangents arrive from the next conv's backward through the
[C]-vector algebra of `bn_affine`, and the statistics cotangents
(dssum, dssq) flow into this op's backward.

impl="xla" (the "fused" helper mode) composes torch ops, as the JAX
package composes lax ops. impl="pallas" dispatches by geometry to the
hand-written kernels of pallas_conv.py, which compute exactly this
forward for the geometry they cover:
  * 1x1 stride 1                       -> fused_conv1x1
  * 3x3 stride 1, SAME                 -> fused_conv3x3
  * anything else (the 7x7 stem, the stride-2 1x1s) -> torch convolution
    with the prologue applied in torch.
A part of the prologue a kernel does not take is materialized in torch
first, at the same rounding points as `_prologue`: for the 1x1 kernel the
second affine term scale2*x2+shift2 becomes the kernel's plain `add`; for
the 3x3 kernel any x2 term means the whole of u is materialized first.
The backward of a 1x1 stride-1 conv with statistics of the full batch
(with_stats <= 1) runs on the dgrad_conv1x1/wgrad_conv1x1 kernels under
"pallas"; every other backward is the composed one, with torch's
convolution gradients on the recomputed u (the JAX package computes
those outside Pallas too). Either computes only the gradients autograd
asks for (`ctx.needs_input_grad`): a conv whose input comes from frozen
layers forms no du (no dgrad launch), a frozen conv no dW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.helpers import pallas_conv
from deeplearning4j_tpu_torch.nn.helpers.pallas_conv import to_acc
from deeplearning4j_tpu_torch.nn.layers.conv import conv2d_nhwc, resolve_padding


def _conv(u, w, stride, padding):
    return conv2d_nhwc(u, w, tuple(stride), padding)


def _second_term(x2, scale2, shift2):
    """The residual term scale2*x2+shift2 (or plain x2), or None."""
    if x2 is None or scale2 is None:
        return x2
    return pallas_conv.affine(x2, scale2, shift2)


def _prologue(x, scale, shift, x2, scale2, shift2, relu):
    return pallas_conv.prologue(x, scale, shift,
                                _second_term(x2, scale2, shift2), relu)


def kernel_route(w_shape, stride, padding, in_hw):
    """Which hand-written kernel computes conv(u, W) for this geometry:
    "conv1x1", "conv3x3" or None (torch convolution). `in_hw` (H, W)
    resolves "SAME"/explicit padding."""
    kh, kw = int(w_shape[0]), int(w_shape[1])
    if tuple(int(s) for s in stride) != (1, 1):
        return None
    pads = resolve_padding(padding, in_hw[0], in_hw[1], kh, kw, 1, 1)
    if (kh, kw) == (1, 1) and pads == ((0, 0), (0, 0)):
        return "conv1x1"
    if (kh, kw) == (3, 3) and pads == ((1, 1), (1, 1)):
        return "conv3x3"
    return None


def fused_conv(x, w, b, scale, shift, x2, scale2, shift2,
               stride, padding, relu, with_stats, impl="xla",
               emit_u: bool = True):
    """y_raw = conv(act(scale*x+shift [+ scale2*x2+shift2]), w) + b, plus
    channel sum/sumsq of y_raw and the materialized activation u.

    x/x2: [B,H,W,C] raw (pre-BN) inputs; scale*/shift*: [C] f32 affines
    (None = plain tensor); stride: (sh, sw); padding: lax padding spec;
    with_stats: 0/False = no statistics (eval), 1 = statistics of the full
    y, k>1 = statistics of the leading ceil(B/k) batch rows.

    Returns (y_raw [B,H,W,N], ssum [N] f32, ssq [N] f32, u). Port-only,
    as PyTorch runs eagerly and nothing eliminates unread results: u is
    returned only when `emit_u` (None otherwise), and ssum/ssq are None
    when with_stats is 0. Differentiable in every tensor argument.
    """
    return FusedConv.apply(x, w, b, scale, shift, x2, scale2, shift2,
                           tuple(int(s) for s in stride), padding,
                           bool(relu), int(with_stats), impl, emit_u)


class FusedConv(torch.autograd.Function):
    """`fused_conv` with the JAX package's custom VJP: the forward saves
    x, x2, y and the [C] vectors; the backward recomputes u. Outputs
    nobody differentiates (u not emitted, statistics in eval) come back
    as None cotangents and count as absent."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, x2, scale2, shift2, stride,
                padding, relu, with_stats, impl, emit_u):
        y, ssum, ssq, u = _forward(x, w, b, scale, shift, x2, scale2,
                                   shift2, stride, padding, relu,
                                   with_stats, impl, emit_u)
        if u is x:   # identity prologue: an output may not be an input
            u = x.clone()
        ctx.save_for_backward(x, w, b, scale, shift, x2, scale2, shift2, y)
        ctx.cfg = (stride, padding, relu, with_stats, impl)
        ctx.set_materialize_grads(False)
        return y, ssum, ssq, u

    @staticmethod
    def backward(ctx, dy, dssum, dssq, du_out):
        x, w, b, scale, shift, x2, scale2, shift2, y = ctx.saved_tensors
        stride, padding, relu, with_stats, impl = ctx.cfg
        if dy is None:
            dy = torch.zeros_like(y)
        if not with_stats or (dssum is None and dssq is None):
            dssum = dssq = None
        else:
            n = y.shape[-1]
            zero = lambda v: torch.zeros(n, dtype=torch.float32,
                                         device=y.device) if v is None else v
            dssum, dssq = zero(dssum), zero(dssq)
        # the gradients autograd asks for: an input from a frozen layer
        # (or none at all) needs no dx, its affine no ds/dt
        need = tuple(ctx.needs_input_grad[:8])
        if (impl == "pallas" and with_stats <= 1 and kernel_route(
                w.shape, stride, padding, x.shape[1:3]) == "conv1x1"):
            grads = _bwd_pallas_1x1(x, w, b, scale, shift, x2, scale2,
                                    shift2, y, dy, dssum, dssq, du_out,
                                    relu, need)
        else:
            grads = _bwd_composed(x, w, b, scale, shift, x2, scale2, shift2,
                                  y, dy, dssum, dssq, du_out, stride,
                                  padding, relu, with_stats, need)
        return grads + (None,) * 6


def _forward(x, w, b, scale, shift, x2, scale2, shift2, stride, padding,
             relu, with_stats, impl, emit_u):
    if impl == "pallas" and int(with_stats) <= 1:
        route = kernel_route(w.shape, stride, padding, x.shape[1:3])
        if route is not None:
            return _fwd_kernel(route, x, w, b, scale, shift, x2, scale2,
                               shift2, relu, with_stats, emit_u)
    y, ssum, ssq, u = _fwd_impl(x, w, b, scale, shift, x2, scale2, shift2,
                                stride, padding, relu, with_stats)
    return y, ssum, ssq, (u if emit_u else None)


def _fwd_impl(x, w, b, scale, shift, x2, scale2, shift2,
              stride, padding, relu, with_stats):
    u = _prologue(x, scale, shift, x2, scale2, shift2, relu)
    y = _conv(u, w, stride, padding)
    if b is not None:
        y = y + b.to(y.dtype)
    ssum = ssq = None
    if with_stats:
        yf = to_acc(_stat_rows(y, int(with_stats)))
        ssum = yf.sum((0, 1, 2))
        ssq = (yf * yf).sum((0, 1, 2))
    return y, ssum, ssq, u


def _stat_rows(y, k):
    """Leading ceil(B/k) batch rows of y (k=1: y itself)."""
    if k <= 1:
        return y
    nb = (y.shape[0] - 1) // k + 1
    return y[:nb]


def _fwd_kernel(route, x, w, b, scale, shift, x2, scale2, shift2, relu,
                with_stats, emit_u):
    bsz, h, wd, k = x.shape
    n = w.shape[-1]
    stats = bool(with_stats)
    if route == "conv1x1":
        add = _second_term(x2, scale2, shift2)
        if add is not None:
            add = add.reshape(-1, k).contiguous()
        y, ssum, ssq, u = pallas_conv.fused_conv1x1(
            x.reshape(-1, k).contiguous(), w.reshape(k, n).contiguous(), b,
            scale, shift, add, relu=relu, emit_u=emit_u, stats=stats)
        y = y.reshape(bsz, h, wd, n)
        u = None if u is None else u.reshape(bsz, h, wd, k)
    else:
        if x2 is not None or emit_u:
            u = _prologue(x, scale, shift, x2, scale2, shift2, relu)
            y, ssum, ssq = pallas_conv.fused_conv3x3(
                u.contiguous(), w.contiguous(), b, stats=stats)
        else:
            u = None
            y, ssum, ssq = pallas_conv.fused_conv3x3(
                x.contiguous(), w.contiguous(), b, scale, shift, relu=relu,
                stats=stats)
    return y, ssum, ssq, (u if emit_u else None)


# --------------------------------------------------------------- backward


# of FusedConv's eight differentiable inputs (x, w, b, scale, shift, x2,
# scale2, shift2), the ones whose gradients need du
_INPUT_SIDE = (0, 3, 4, 5, 6, 7)


def _conv_grads(u, w, ybar, stride, padding, need_du=True, need_dw=True):
    """(du, dw) of conv2d_nhwc(u, w, stride, padding) for the cotangent
    ybar: torch's convolution backward on the explicitly padded u; a
    gradient not asked for is None and not computed."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    h, wd = u.shape[1], u.shape[2]
    (pt, pb), (pl, pr) = resolve_padding(padding, h, wd, kh, kw, *stride)
    up = F.pad(u, (0, 0, pl, pr, pt, pb)) if pt or pb or pl or pr else u
    gi, gw, _ = torch.ops.aten.convolution_backward(
        ybar.permute(0, 3, 1, 2), up.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1), None, list(stride), [0, 0], [1, 1], False,
        [0, 0], 1, [need_du, need_dw, False])
    du = None if gi is None else \
        gi.permute(0, 2, 3, 1)[:, pt:pt + h, pl:pl + wd, :]
    return du, None if gw is None else gw.permute(2, 3, 1, 0)


def _keep(grads, need):
    """`grads` with each one not asked for replaced by None."""
    return tuple(g if n else None for g, n in zip(grads, need))


def _bwd_composed(x, w, b, scale, shift, x2, scale2, shift2, y, dy, dssum,
                  dssq, du_out, stride, padding, relu, with_stats, need):
    """The JAX package's composed backward (fused_ops.py _fused_conv_bwd):
    ybar rounded to the compute dtype, u recomputed, torch's convolution
    gradients, then the relu mask and the two branches' affine grads.
    `need`: which of the eight gradients to compute (`ctx.needs_input_grad`;
    the rest are None); without an input-side gradient no du is formed."""
    dtype = x.dtype
    ybar = dy
    if dssum is not None:
        if with_stats <= 1:
            ybar = pallas_conv.ybar_acc(dy, y, dssum, dssq).to(dtype)
        else:
            # sampled statistics: only the leading ghost rows carry a
            # statistics contribution (the JAX package's zero tail pad)
            nb = _stat_rows(y, with_stats).shape[0]
            corr = (to_acc(dssum) + 2.0 * to_acc(y[:nb]) * to_acc(dssq))
            corr = corr.to(dtype)
            ybar = torch.cat([dy[:nb] + corr, dy[nb:]])
    u = _prologue(x, scale, shift, x2, scale2, shift2, relu)
    db = None if b is None or not need[2] else \
        to_acc(ybar).sum((0, 1, 2)).to(b.dtype)
    need_du = any(need[i] for i in _INPUT_SIDE)
    du, dw = (_conv_grads(u, w, ybar, stride, padding, need_du, need[1])
              if need_du or need[1] else (None, None))
    if not need_du:
        return None, dw, db, None, None, None, None, None
    if du_out is not None:
        du = du + du_out.to(du.dtype)
    if relu:
        du = du * (u > 0).to(dtype)

    def branch(xb, sb):
        if sb is None:
            return du, None, None
        duf = to_acc(du)
        return (du * sb.to(dtype), (to_acc(xb) * duf).sum((0, 1, 2)),
                duf.sum((0, 1, 2)))

    dx, ds1, dt1 = branch(x, scale)
    dx2, ds2, dt2 = (None,) * 3 if x2 is None else branch(x2, scale2)
    return _keep((dx, dw, db, ds1, dt1, dx2, ds2, dt2), need)


def _bwd_pallas_1x1(x, w, b, scale, shift, x2, scale2, shift2, y, dy,
                    dssum, dssq, du_out, relu, need):
    """Backward on the dgrad/wgrad kernels: each big tensor is read once
    per kernel; ybar and du never round-trip device memory. `need` as
    `_bwd_composed`'s: dgrad runs only for an input-side gradient (it
    also sums db; without it torch sums db, as the composed backward
    does), wgrad only for dW."""
    bsz, h, wd, k = x.shape
    m, n = bsz * h * wd, w.shape[-1]
    rows = lambda t, c: None if t is None else t.reshape(m, c).contiguous()
    dy2, y2, x1, xx2 = rows(dy, n), rows(y, n), rows(x, k), rows(x2, k)
    dx1 = dx2 = ds1 = dt1 = ds2 = dt2 = db = dw = None
    if any(need[i] for i in _INPUT_SIDE):
        dx1, dx2, ds1, dt1, ds2, dt2, db = pallas_conv.dgrad_conv1x1(
            dy2, y2, w.reshape(k, n).contiguous(), x1, xx2, rows(du_out, k),
            scale, shift, scale2, shift2, dssum, dssq, relu)
        dx1 = dx1.reshape(x.shape)
        dx2 = None if x2 is None else dx2.reshape(x2.shape)
    elif b is not None and need[2]:
        db = pallas_conv.ybar_acc(dy2, y2, dssum, dssq).sum(0)
    if need[1]:
        dw = pallas_conv.wgrad_conv1x1(
            dy2, y2, x1, xx2, scale, shift, scale2, shift2, dssum, dssq,
            relu).reshape(w.shape).to(w.dtype)
    return _keep((dx1, dw, None if b is None or db is None
                  else db.to(b.dtype), ds1, dt1, dx2, ds2, dt2), need)


# ---------------------------------------------------------------- helpers


def bn_affine(gamma, beta, ssum, ssq, count, eps):
    """Fold BN statistics into the next conv's prologue affine (one-pass
    variance, as the JAX package). Returns (scale, shift, mean, var), f32."""
    mean = ssum / count
    var = torch.clamp_min(ssq / count - mean * mean, 0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return scale, shift, mean, var


def bn_affine_inference(gamma, beta, mean, var, eps):
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return scale, shift
