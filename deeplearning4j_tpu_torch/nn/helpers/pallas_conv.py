"""Fused convolution kernels for Hopper (counterpart of
deeplearning4j_tpu/nn/helpers/pallas_conv.py).

The JAX package's Pallas kernels for the TPU become CUDA C++ kernels for
sm_90a (csrc/fused_conv1x1.cu, csrc/fused_conv3x3.cu, csrc/dgrad_conv1x1.cu,
csrc/wgrad_conv1x1.cu; built and bound by kernel_build.py). The forward
kernels keep their TPU counterparts' contract:

  PROLOGUE  u = relu?(scale*x + shift [+ add]) as the input is loaded —
            BN-apply/activation/residual-add never round-trip memory;
  MATMUL    1x1: rows [M=B*H*W, K] @ W [K, N]; 3x3 SAME stride 1: an
            implicit GEMM over K = 9*C with the zero padding applied to u;
  EPILOGUE  bias, rounding to the compute dtype, and per-channel
            sum / sum-of-squares of the rounded output (`stats=False`:
            skipped, for the inference path that reads no statistics).

The 1x1 backward kernels fold everything around their two products:
dgrad recomputes ybar = dy + dssum + 2*y*dssq as it loads, forms
du = ybar @ W^T, masks it with the relu of the recomputed u and writes
dx = du*scale, with the [C]-sized ds/dt/db reductions as byproducts;
wgrad recomputes u and ybar per tile and accumulates dW = u^T @ ybar.

Every kernel has a plain PyTorch version beside it with the same
signature and rounding points (`ref_fused_conv1x1`, `ref_fused_conv3x3`,
`ref_dgrad_conv1x1`, `ref_wgrad_conv1x1`).
The wrappers take the plain version only for tensors on the CPU; for a
CUDA tensor they launch the kernel or raise. `LAUNCHES` counts kernel
launches (one per wrapper call that launched), so a run can show that
its main path went through the kernels.

Every kernel has two routes. "wgmma" is the Hopper design (cp.async
ring, the prologue or the cotangent applied in shared memory, wgmma) for
bf16 with the channel counts multiples of 64 and 16-byte aligned operands,
which every bf16 ResNet-50 call takes; "simple", the first, plainer
kernels (64x64 tiles, mma.sync or FMA), takes f32 and every other shape.
`forward_route` / `backward_route` pick it; `FORWARD_ROUTES` /
`BACKWARD_ROUTES` count each launch's route and `LAUNCHES_BY_DTYPE` its
(kernel, route, dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.helpers import kernel_build

# launches per kernel wrapper; reset with reset_launch_counts()
LAUNCHES = {"fused_conv1x1": 0, "fused_conv3x3": 0, "dgrad_conv1x1": 0,
            "wgrad_conv1x1": 0}

# launches of each 1x1 backward kernel by route (backward_route); reset
# with reset_launch_counts()
BACKWARD_ROUTES = {"dgrad_conv1x1": {"wgmma": 0, "simple": 0},
                   "wgrad_conv1x1": {"wgmma": 0, "simple": 0}}
# launches of each forward kernel by route (forward_route); reset with
# reset_launch_counts()
FORWARD_ROUTES = {"fused_conv1x1": {"wgmma": 0, "simple": 0},
                  "fused_conv3x3": {"wgmma": 0, "simple": 0}}
_ROUTE_IDS = {"simple": 0, "wgmma": 1}
# launches by (kernel, route, dtype) — "bf16"/"f32"/"f64" — beside the
# counts above (the program lint reads a call's routes and dtypes from
# it); a CUDA graph replay moves only LAUNCHES and the route counts;
# reset with reset_launch_counts()
LAUNCHES_BY_DTYPE = {}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float64: "f64", torch.float16: "f16"}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_DTYPE.clear()
    for routes in (*FORWARD_ROUTES.values(), *BACKWARD_ROUTES.values()):
        for r in routes:
            routes[r] = 0


def launch_counts() -> dict:
    """A flat copy of every launch counter: {kernel: launches,
    "kernel/route": launches on that route}."""
    out = dict(LAUNCHES)
    for name, routes in {**FORWARD_ROUTES, **BACKWARD_ROUTES}.items():
        for r, v in routes.items():
            out[f"{name}/{r}"] = v
    return out


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add `times` x `delta` (launch_counts' keys) to the counters. A
    CUDA graph launches the kernels it captured on every replay without
    calling the wrappers, so its owner records what one replay launches
    at capture and adds it here per replay (engine/step_program.py)."""
    for key, v in delta.items():
        name, _, route = key.partition("/")
        if route:
            {**FORWARD_ROUTES, **BACKWARD_ROUTES}[name][route] += v * times
        else:
            LAUNCHES[name] += v * times


def _count_dtype(name: str, route: str, dtype) -> None:
    key = (name, route, _DTYPE_NAMES.get(dtype, str(dtype)))
    LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + 1


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


def _stats_buffers(tiles, n, device, stats):
    """Per-row-tile statistics partials ([2, tiles, n]; `tiles` from the
    library's row-tile count of the route) and the ssum/ssq outputs (all
    None when no statistics are asked for)."""
    if not stats:
        return None, None, None
    f32 = dict(dtype=torch.float32, device=device)
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
    route = forward_route(x.dtype, m, k, n, _aligned(x, w, add, y, u))
    rid = _ROUTE_IDS[route]
    partial, ssum, ssq = _stats_buffers(
        lib.dl4j_conv1x1_row_tiles(rid, m, n), n, dev, stats)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_conv1x1_launch(
        int(x.dtype == torch.bfloat16), _ptr(x), _ptr(w), _ptr(b32),
        _ptr(s32), _ptr(t32), _ptr(add), _ptr(y), _ptr(partial), _ptr(ssum),
        _ptr(ssq), _ptr(u), m, k, n, int(bool(relu)), rid, stream)
    kernel_build.check(lib, rc, f"fused_conv1x1 ({route})")
    LAUNCHES["fused_conv1x1"] += 1
    FORWARD_ROUTES["fused_conv1x1"][route] += 1
    _count_dtype("fused_conv1x1", route, x.dtype)
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
    route = forward_route(x.dtype, bsz * h * wd, c, n, _aligned(x, w, y),
                          width=wd)
    rid = _ROUTE_IDS[route]
    partial, ssum, ssq = _stats_buffers(
        lib.dl4j_conv3x3_row_tiles(rid, bsz, h, wd, c, n), n, dev, stats)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_conv3x3_launch(
        int(x.dtype == torch.bfloat16), _ptr(x), _ptr(w), _ptr(b32),
        _ptr(s32), _ptr(t32), _ptr(y), _ptr(partial), _ptr(ssum), _ptr(ssq),
        bsz, h, wd, c, n, int(bool(relu)), rid, stream)
    kernel_build.check(lib, rc, f"fused_conv3x3 ({route})")
    LAUNCHES["fused_conv3x3"] += 1
    FORWARD_ROUTES["fused_conv3x3"][route] += 1
    _count_dtype("fused_conv3x3", route, x.dtype)
    return y, ssum, ssq


# ------------------------------------------------------------ 1x1 backward


def _check_backward(dy, y, x, x2, scale, shift, scale2, shift2, dssum,
                    dssq, k):
    """Checks shared by the two backward wrappers; returns (m, n)."""
    _check_x(dy, 2)
    m, n = dy.shape
    dev, dt = dy.device, dy.dtype
    _check_operand(y, "y", (m, n), dt, dev)
    _check_operand(x, "x", (m, k), dt, dev)
    if x2 is not None:
        _check_operand(x2, "x2", (m, k), dt, dev)
    _require((scale is None) == (shift is None), "scale and shift go together")
    _require((scale2 is None) == (shift2 is None),
             "scale2 and shift2 go together")
    _require(scale2 is None or x2 is not None, "scale2 needs x2")
    _require((dssum is None) == (dssq is None), "dssum and dssq go together")
    return m, n


def dgrad_conv1x1(dy, y, w, x, x2=None, du_out=None, scale=None,
                  shift=None, scale2=None, shift2=None, dssum=None,
                  dssq=None, relu=False):
    """Fused input-gradient of fused_conv (1x1, stride 1): one pass over
    (dy, y, x[, x2]) producing dx1[, dx2] plus the [C]-sized ds/dt/db
    reductions.

    dy, y: [M, N]; w: [K, N]; x, x2, du_out: [M, K]; scale*/shift*: [K];
    dssum/dssq: [N] (None: no statistics cotangent). Returns
    (dx1, dx2, ds1, dt1, ds2, dt2, db) with None for absent outputs.
    """
    if dy.device.type == "cpu":
        return ref_dgrad_conv1x1(dy, y, w, x, x2, du_out, scale, shift,
                                 scale2, shift2, dssum, dssq, relu)
    k = w.shape[0] if w.ndim == 2 else -1
    m, n = _check_backward(dy, y, x, x2, scale, shift, scale2, shift2,
                           dssum, dssq, k)
    dev, dt = dy.device, dy.dtype
    _check_operand(w, "w", (k, n), dt, dev)
    if du_out is not None:
        _check_operand(du_out, "du_out", (m, k), dt, dev)
    s1, t1 = _vec_f32(scale, k, "scale", dev), _vec_f32(shift, k, "shift", dev)
    s2 = _vec_f32(scale2, k, "scale2", dev)
    t2 = _vec_f32(shift2, k, "shift2", dev)
    dsum = _vec_f32(dssum, n, "dssum", dev)
    dsq = _vec_f32(dssq, n, "dssq", dev)
    lib = kernel_build.load("dgrad_conv1x1")
    f32 = dict(dtype=torch.float32, device=dev)
    dx1 = torch.empty((m, k), dtype=dt, device=dev)
    dx2 = None if x2 is None else torch.empty((m, k), dtype=dt, device=dev)
    route = backward_route(dt, m, k, n, _aligned(dy, y, w, x, x2, du_out,
                                                  dx1, dx2, dsum, dsq))
    tiles = -(-m // lib.dl4j_dgrad_row_tile(_ROUTE_IDS[route]))
    # per-row-tile partials of ds1, dt, ds2 ([tiles, K] each) and db
    # ([tiles, N]), reduced in a fixed order by a second kernel
    partial = torch.empty((tiles * (3 * k + n),), **f32)
    ds1 = None if s1 is None else torch.empty((k,), **f32)
    ds2 = None if s2 is None else torch.empty((k,), **f32)
    dt_ = None if s1 is None and s2 is None else torch.empty((k,), **f32)
    db = torch.empty((n,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dgrad_conv1x1_launch(
        int(dt == torch.bfloat16), _ptr(dy), _ptr(y), _ptr(w), _ptr(x),
        _ptr(x2), _ptr(du_out), _ptr(s1), _ptr(t1), _ptr(s2), _ptr(t2),
        _ptr(dsum), _ptr(dsq), _ptr(dx1), _ptr(dx2), _ptr(partial),
        _ptr(ds1), _ptr(dt_), _ptr(ds2), _ptr(db), m, k, n, int(bool(relu)),
        _ROUTE_IDS[route], stream)
    kernel_build.check(lib, rc, f"dgrad_conv1x1 ({route})")
    LAUNCHES["dgrad_conv1x1"] += 1
    BACKWARD_ROUTES["dgrad_conv1x1"][route] += 1
    _count_dtype("dgrad_conv1x1", route, dt)
    # both branches' shift gradients are the same sum over du
    dt1 = dt_ if s1 is not None else None
    dt2 = None if s2 is None else (dt_.clone() if s1 is not None else dt_)
    return dx1, dx2, ds1, dt1, ds2, dt2, db


def _aligned(*tensors) -> bool:
    """Every given tensor starts on a 16-byte boundary (None: no
    constraint)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


# the 3x3 "wgmma" route's warpgroup covers 64 positions of the padded
# (W+2)-wide grid: at least one image row
FORWARD_MAX_WIDTH = 62
# the "wgmma" routes keep the prologue's [K] scale/shift in shared memory
# beside their rings: 4*K bytes next to the 1x1's largest ring (192 KB)
FORWARD_MAX_K = 8192


def forward_route(dtype, m: int, k: int, n: int, aligned: bool = True,
                  width=None) -> str:
    """Which kernel a forward call launches: "wgmma" (bf16, K — C for the
    3x3 — and N multiples of 64, every operand 16-byte aligned, and for
    the 3x3 (`width` given) an image at most FORWARD_MAX_WIDTH wide) or
    "simple" (the rest: f32 has no tensor-core product that keeps its f32
    contract, wgmma's f32 form being TF32)."""
    if (dtype == torch.bfloat16 and m > 0 and k % 64 == 0 and n % 64 == 0
            and 0 < k <= FORWARD_MAX_K and n > 0 and aligned
            and (width is None or 0 < width <= FORWARD_MAX_WIDTH)):
        return "wgmma"
    return "simple"


def backward_route(dtype, m: int, k: int, n: int,
                   aligned: bool = True) -> str:
    """Which kernel a 1x1 backward call launches: "wgmma" (bf16, K and N
    multiples of 64, every operand 16-byte aligned) or "simple" (the rest:
    f32 has no tensor-core product that keeps its f32 contract)."""
    if (dtype == torch.bfloat16 and m > 0 and k % 64 == 0 and n % 64 == 0
            and aligned):
        return "wgmma"
    return "simple"


def wgrad_tile(k: int, n: int, route: str):
    """The dW tile one wgrad block computes on `route`."""
    if route == "wgmma":
        return (128 if k % 128 == 0 else 64), (128 if n % 128 == 0 else 64)
    return 64, 64


# wgrad splits M over blocks: aim at WGRAD_BLOCKS blocks (simple route: 4
# blocks of 128 threads per SM of an H100; wgmma route: 2 blocks of 256
# threads and ~100 KB of shared memory per SM, two waves), give each split
# at least WGRAD_MIN_ROWS rows, and keep the f32 split partials within
# WGRAD_SCRATCH elements (64 MB; the 7x7 stage's K*N is 512*2048)
WGRAD_BLOCKS = 528
WGRAD_MIN_ROWS = 512
WGRAD_SCRATCH = 16 * 2 ** 20
WGRAD_CHUNK = 32               # rows: a split is a whole number of chunks


def wgrad_splits(m: int, k: int, n: int, route: str = "simple") -> int:
    """How many row ranges wgrad_conv1x1 splits M into on `route`."""
    tk, tn = wgrad_tile(k, n, route)
    tiles = -(-k // tk) * -(-n // tn)
    return max(1, min(-(-WGRAD_BLOCKS // tiles), m // WGRAD_MIN_ROWS,
                      WGRAD_SCRATCH // (k * n)))


def wgrad_split_rows(m: int, splits: int):
    """(rows per range, ranges launched): the kernels' split of M into
    ranges of whole chunks; ranges past M are not launched."""
    rows = -(-m // splits)
    rows = -(-rows // WGRAD_CHUNK) * WGRAD_CHUNK
    return rows, -(-m // rows)


def wgrad_conv1x1(dy, y, x, x2=None, scale=None, shift=None, scale2=None,
                  shift2=None, dssum=None, dssq=None, relu=False):
    """Fused weight-gradient of fused_conv (1x1, stride 1): recomputes u
    and ybar per tile and accumulates dW = u^T @ ybar in f32. Returns
    dW [K, N] f32."""
    if dy.device.type == "cpu":
        return ref_wgrad_conv1x1(dy, y, x, x2, scale, shift, scale2, shift2,
                                 dssum, dssq, relu)
    k = x.shape[1] if x.ndim == 2 else -1
    m, n = _check_backward(dy, y, x, x2, scale, shift, scale2, shift2,
                           dssum, dssq, k)
    dev = dy.device
    s1, t1 = _vec_f32(scale, k, "scale", dev), _vec_f32(shift, k, "shift", dev)
    s2 = _vec_f32(scale2, k, "scale2", dev)
    t2 = _vec_f32(shift2, k, "shift2", dev)
    dsum = _vec_f32(dssum, n, "dssum", dev)
    dsq = _vec_f32(dssq, n, "dssq", dev)
    lib = kernel_build.load("wgrad_conv1x1")
    route = backward_route(dy.dtype, m, k, n, _aligned(dy, y, x, x2))
    splits = wgrad_splits(m, k, n, route)
    f32 = dict(dtype=torch.float32, device=dev)
    dw = torch.empty((k, n), **f32)
    scratch = torch.empty((splits, k, n), **f32) if splits > 1 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.wgrad_conv1x1_launch(
        int(dy.dtype == torch.bfloat16), _ptr(dy), _ptr(y), _ptr(x),
        _ptr(x2), _ptr(s1), _ptr(t1), _ptr(s2), _ptr(t2), _ptr(dsum),
        _ptr(dsq), _ptr(dw), _ptr(scratch), m, k, n, splits,
        int(bool(relu)), _ROUTE_IDS[route], stream)
    kernel_build.check(lib, rc, f"wgrad_conv1x1 ({route})")
    LAUNCHES["wgrad_conv1x1"] += 1
    BACKWARD_ROUTES["wgrad_conv1x1"][route] += 1
    _count_dtype("wgrad_conv1x1", route, dy.dtype)
    return dw


# --------------------------------------------------------- plain versions


def to_acc(t):
    """`t` in the kernels' accumulation dtype: f32, or f64 for f64 inputs
    (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
    yf = to_acc(y)
    return yf.sum(dims), (yf * yf).sum(dims)


def ref_fused_conv1x1(x, w, b, scale=None, shift=None, add=None,
                      relu=False, emit_u=False, stats=True):
    """Plain PyTorch version of fused_conv1x1 (same rounding points:
    each prologue op rounds to x's dtype, the product accumulates in
    f32, the bias joins in f32, one rounding to x's dtype)."""
    u = prologue(x, scale, shift, add, relu)
    acc = to_acc(u) @ to_acc(w)
    if b is not None:
        acc = acc + to_acc(b)
    y = acc.to(x.dtype)
    return (y, *_channel_stats(y, 0, stats), (u if emit_u else None))


def ref_fused_conv3x3(x, w, b, scale=None, shift=None, relu=False,
                      stats=True):
    """Plain PyTorch version of fused_conv3x3."""
    u = prologue(x, scale, shift, None, relu)
    acc = F.conv2d(to_acc(u).permute(0, 3, 1, 2),
                   to_acc(w).permute(3, 2, 0, 1), padding=1)
    acc = acc.permute(0, 2, 3, 1)
    if b is not None:
        acc = acc + to_acc(b)
    y = acc.to(x.dtype)
    return (y, *_channel_stats(y, (0, 1, 2), stats))


def ybar_acc(dy, y, dssum=None, dssq=None):
    """The effective output cotangent dy + dssum + 2*y*dssq, unrounded
    (f32): the order of the kernels' f32 operations."""
    dyf = to_acc(dy)
    if dssum is not None:
        dyf = dyf + to_acc(dssum) + 2.0 * to_acc(y) * to_acc(dssq)
    return dyf


def recompute_u(x, x2=None, scale=None, shift=None, scale2=None,
                shift2=None, relu=False):
    """u of the fused conv's prologue, recomputed from its raw inputs."""
    add = x2 if x2 is None or scale2 is None else affine(x2, scale2, shift2)
    return prologue(x, scale, shift, add, relu)


def ref_dgrad_conv1x1(dy, y, w, x, x2=None, du_out=None, scale=None,
                      shift=None, scale2=None, shift2=None, dssum=None,
                      dssq=None, relu=False):
    """Plain PyTorch version of dgrad_conv1x1, at the kernel's rounding
    points: ybar formed in f32 and rounded once for the product, which
    accumulates in f32; db sums the unrounded ybar; the relu mask compares
    the recomputed u in f32; dx = du*scale in f32, rounded once."""
    dtype = dy.dtype
    dyf = ybar_acc(dy, y, dssum, dssq)
    du = to_acc(dyf.to(dtype)) @ to_acc(w).t()
    if du_out is not None:
        du = du + to_acc(du_out)
    if relu:
        u = recompute_u(x, x2, scale, shift, scale2, shift2)
        du = torch.where(to_acc(u) > 0, du, 0.0)

    def branch(xb, s):
        if s is None:
            return du.to(dtype), None, None
        return ((du * to_acc(s)).to(dtype), (to_acc(xb) * du).sum(0),
                du.sum(0))

    dx1, ds1, dt1 = branch(x, scale)
    dx2, ds2, dt2 = (None,) * 3 if x2 is None else branch(x2, scale2)
    return dx1, dx2, ds1, dt1, ds2, dt2, dyf.sum(0)


def ref_wgrad_conv1x1(dy, y, x, x2=None, scale=None, shift=None,
                      scale2=None, shift2=None, dssum=None, dssq=None,
                      relu=False):
    """Plain PyTorch version of wgrad_conv1x1: u recomputed in the
    compute dtype, times ybar rounded to u's dtype, accumulated in f32."""
    u = recompute_u(x, x2, scale, shift, scale2, shift2, relu)
    ybar = ybar_acc(dy, y, dssum, dssq).to(u.dtype)
    return to_acc(u).t() @ to_acc(ybar)


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
