"""The port's collectives: the one module that calls `torch.distributed`.

Parallelism in the port is one process per rank and one device per
process. A mesh (parallel/mesh.py) lays the ranks out over the five axes
("dp", "pp", "sp", "ep", "tp"; tp fastest), and every axis of size > 1
that does not span the whole world gets one process group per coordinate
set of the other axes (`axis_groups`). Everything that exchanges tensors
between ranks (the per-step gradient all-reduce, the global BatchNorm
statistics, ZeRO-1's reduce-scatter and all-gather, the local-SGD
rendezvous, the stale trainer's gradient average, tensor parallelism's
gathers, ring attention's hops, the embedding rendezvous) calls the
functions below, each over one AXIS: an `AxisGroup` (mesh-aware callers
pass `mesh.group(name)`), or None, the default: the dp axis of a purely
data-parallel world, which is the whole world.

  init_process_group(address, n, rank, backend=None, device=None)
        the group (TrainingMaster.initialize_distributed calls it):
        `backend=None` is NCCL for a CUDA device and gloo for the CPU; an
        NCCL group is bound to its device (`device_id`), so its
        communicator exists before any capture.
  AxisGroup (DPGroup) / dp_group()
        one axis as this rank sees it: its size (`world`), this rank's
        coordinate (`rank`), the member ranks and the torch group.
  axis_groups(sizes)
        the groups of a mesh of `sizes` (AXES order), created on every
        rank in the same order (`new_group` is collective over the world)
        and cached per sizes until the process group is destroyed.
  dp_all_reduce_mean(t, axis), all_reduce_sum(t, axis)
        in place, on one tensor (callers pack many into one bucket).
  reduce_scatter(flat, axis), all_gather(mine, axis)
        of flat buffers whose length is a multiple of the axis size:
        coordinate r keeps / contributes chunk r.
  broadcast(t, src, axis)
  ppermute(t, axis, shift=1)
        one ring hop along the axis: coordinate r sends to r + shift and
        receives from r - shift (`batch_isend_irecv`).
  dp_sum(x)
        a DIFFERENTIABLE sum over the ranks of the enclosing `dp_scope`
        whose backward is itself an all-reduce sum: the route of
        BatchNorm's per-channel sums and the loss's live-row count under
        per-step dp.

Gloo has no reduce-scatter or all-gather into one tensor on CUDA tensors
(and not in every release on CPU tensors), so for every gloo group both
are expressed through `all_reduce`: a reduce-scatter is the all-reduce of
the whole buffer followed by taking this rank's chunk, and an all-gather
is the all-reduce of a zero buffer holding only this rank's chunk. They
move W times the bytes of the NCCL collectives and give the same values
(each element of an all-gather is one rank's value plus zeros). Gloo's
point-to-point send and receive take CPU tensors only, so a gloo
`ppermute` of a CUDA tensor goes through pinned host buffers (a copy to
the host, the hop, a copy back). These are the documented ways a gloo
group runs them, on the CPU as on the card, not fallbacks: an NCCL group
always takes `reduce_scatter_tensor`, `all_gather_into_tensor` and
device-to-device sends.

Without a process group the world is one process and every collective
is the identity (a copy where it returns a new tensor): a single-process
run needs no group. An axis of size 1 inside a larger world is the
identity too; the world group itself issues its collectives whenever a
group is initialized, even at world 1. `COUNTS` counts the collectives
issued per kind (a CUDA graph capture reads them before and after, so a
captured group records which collectives it holds).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

COUNTS = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0,
          "broadcast": 0, "ppermute": 0}

AXES = ("dp", "pp", "sp", "ep", "tp")


def _dist():
    return torch.distributed


def initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return _dist().get_world_size() if initialized() else 1


def rank() -> int:
    return _dist().get_rank() if initialized() else 0


def backend() -> Optional[str]:
    return str(_dist().get_backend()) if initialized() else None


def init_process_group(coordinator_address: str, num_processes: int,
                       process_id: int, backend: Optional[str] = None,
                       device=None, timeout_s: float = 300.0) -> None:
    """Join the default process group of `num_processes` ranks as rank
    `process_id`, rendezvousing at `coordinator_address` ("host:port" or
    a "tcp://" URL). `backend=None`: NCCL when `device` (None means
    "cuda", as every port entry point) is a CUDA device, gloo on the
    CPU. An NCCL group binds `device` (the current CUDA device when it
    has no index), which creates the communicator eagerly.
    `DL4J_TPU_PG_TIMEOUT_S`, when set, replaces `timeout_s` (a gang
    drill's short timeout, with TORCH_NCCL_BLOCKING_WAIT=1, turns a hung
    collective into an error that names it)."""
    from deeplearning4j_tpu_torch.device import resolve_device

    timeout_s = float(os.environ.get("DL4J_TPU_PG_TIMEOUT_S", timeout_s))

    dist = _dist()
    if initialized():
        raise RuntimeError("a process group is initialized already "
                           f"(world {world_size()}, rank {rank()})")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    kw = {}
    if backend == "nccl":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def destroy_process_group() -> None:
    """Leave and destroy the default group and every axis group (no-op
    without one)."""
    _MESH_GROUPS.clear()
    if initialized():
        _dist().destroy_process_group()


@dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it: the axis size (`world`), this
    rank's coordinate along it (`rank`), the backend, the member ranks in
    coordinate order and the torch group (`pg`; None: the default group,
    which the axis spans, or an axis of size 1)."""

    world: int
    rank: int
    backend: Optional[str]
    ranks: Tuple[int, ...] = ()
    pg: Any = field(default=None, compare=False, repr=False)
    axis: str = "dp"


# the dp axis's historical name: per-step dp, ZeRO-1 and the trainers
# hold the dp AxisGroup under it
DPGroup = AxisGroup


def dp_group() -> AxisGroup:
    """The dp axis over the whole live world (world 1, rank 0 without a
    group)."""
    w = world_size()
    return AxisGroup(w, rank(), backend(), tuple(range(w)), None, "dp")


# ------------------------------------------------------- the axis groups
# the process groups of each mesh shape made since the process group
# was initialized: like the default group, they live as long as it does
_MESH_GROUPS: Dict[Tuple[int, ...], Dict[str, AxisGroup]] = {}


def axis_groups(sizes: Sequence[int]) -> Dict[str, AxisGroup]:
    """The AxisGroup of every axis of a mesh of `sizes` (one per name of
    AXES, their product the world; the last axis varies fastest). Every
    rank calls this with the same sizes: each axis of size > 1 that does
    not span the world creates one `new_group` per coordinate set of the
    other axes, in the same order on every rank (a mismatch deadlocks
    `new_group`, which is collective over the world). Cached per sizes,
    so a second mesh of the same shape creates nothing."""
    sizes = tuple(int(n) for n in sizes)
    groups = _MESH_GROUPS.get(sizes)
    if groups is None:
        groups = _build_axis_groups(sizes)
        _MESH_GROUPS[sizes] = groups
    return dict(groups)


def _build_axis_groups(sizes: Tuple[int, ...]) -> Dict[str, AxisGroup]:
    w, me, be = world_size(), rank(), backend()
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    coord = lambda r, i: (r // strides[i]) % sizes[i]
    out = {}
    for i, name in enumerate(AXES):
        n = sizes[i]
        if n == 1:
            out[name] = AxisGroup(1, 0, be, (me,), None, name)
            continue
        if n == w:
            out[name] = AxisGroup(w, me, be, tuple(range(w)), None, name)
            continue
        bases = sorted({r - coord(r, i) * strides[i] for r in range(w)})
        for base in bases:
            ranks = tuple(base + j * strides[i] for j in range(n))
            pg = _dist().new_group(list(ranks))
            if me in ranks:
                out[name] = AxisGroup(n, ranks.index(me), be, ranks, pg, name)
    return out


def _axis(axis: Optional[AxisGroup]) -> AxisGroup:
    """The group a collective runs over: `axis`, or the whole world."""
    if axis is None:
        return dp_group()
    if not isinstance(axis, AxisGroup):
        raise TypeError("a collective's axis is an AxisGroup (mesh.group("
                        f"name)) or None, got {type(axis).__name__}")
    return axis


def _live(g: AxisGroup) -> bool:
    """Does a collective over `g` reach torch.distributed? The world group
    does whenever a group is initialized (even at world 1: a captured
    program records its collectives); an axis group of size 1 is the
    identity."""
    if not initialized():
        return False
    return g.pg is not None or g.world == world_size()


def _kw(g: AxisGroup) -> dict:
    return {} if g.pg is None else {"group": g.pg}


# ------------------------------------------------------- the dp scope
_SCOPE = threading.local()


@contextlib.contextmanager
def dp_scope(group: Optional[AxisGroup]):
    """Within the block, BatchNorm's batch statistics and the loss's
    live-row count are global over `group` (when its size exceeds 1):
    the per-step dp semantics of one program over the global batch."""
    prev = getattr(_SCOPE, "group", None)
    _SCOPE.group = group if group is not None and group.world > 1 else None
    try:
        yield
    finally:
        _SCOPE.group = prev


def current() -> Optional[AxisGroup]:
    """The dp group of the enclosing `dp_scope` (None outside one, or for
    a group of 1)."""
    return getattr(_SCOPE, "group", None)


# -------------------------------------------------------- collectives
def all_reduce_sum(t: torch.Tensor, axis=None) -> torch.Tensor:
    """In-place sum over the axis; returns `t`."""
    g = _axis(axis)
    if _live(g):
        COUNTS["all_reduce"] += 1
        _dist().all_reduce(t, op=_dist().ReduceOp.SUM, **_kw(g))
    return t


def dp_all_reduce_mean(t: torch.Tensor, axis=None) -> torch.Tensor:
    """In-place mean over the axis (a sum, then divided by its size);
    returns `t`."""
    g = _axis(axis)
    all_reduce_sum(t, g)
    if g.world > 1:
        t.div_(g.world)
    return t


def _chunk(n: int, w: int) -> int:
    if n % w:
        raise ValueError(f"buffer of {n} elements does not split over "
                         f"world {w}")
    return n // w


def reduce_scatter(flat: torch.Tensor, axis=None) -> torch.Tensor:
    """Chunk `rank` of the sum over the axis of the 1-D `flat` (its
    length a multiple of the axis size): a new tensor of len(flat) / size
    elements. Gloo: the all-reduce of a copy, then the chunk (module
    docstring)."""
    g = _axis(axis)
    w, r = g.world, g.rank
    c = _chunk(flat.numel(), w)
    if not _live(g):
        return flat.clone()
    COUNTS["reduce_scatter"] += 1
    if g.backend == "gloo":
        buf = flat.clone()
        _dist().all_reduce(buf, op=_dist().ReduceOp.SUM, **_kw(g))
        return buf[r * c:(r + 1) * c].clone()
    out = torch.empty(c, dtype=flat.dtype, device=flat.device)
    _dist().reduce_scatter_tensor(out, flat.contiguous(),
                                  op=_dist().ReduceOp.SUM, **_kw(g))
    return out


def all_gather(mine: torch.Tensor, axis=None) -> torch.Tensor:
    """The 1-D chunks of the axis's ranks concatenated in coordinate
    order: a new tensor of size * len(mine) elements. Gloo: the
    all-reduce of a zero buffer holding this rank's chunk (module
    docstring)."""
    g = _axis(axis)
    w, r = g.world, g.rank
    c = mine.numel()
    if not _live(g):
        return mine.reshape(-1).clone()
    COUNTS["all_gather"] += 1
    if g.backend == "gloo":
        buf = torch.zeros(w * c, dtype=mine.dtype, device=mine.device)
        buf[r * c:(r + 1) * c] = mine.reshape(-1)
        _dist().all_reduce(buf, op=_dist().ReduceOp.SUM, **_kw(g))
        return buf
    out = torch.empty(w * c, dtype=mine.dtype, device=mine.device)
    _dist().all_gather_into_tensor(out, mine.reshape(-1).contiguous(),
                                   **_kw(g))
    return out


def broadcast(t: torch.Tensor, src: int = 0, axis=None) -> torch.Tensor:
    """In place from coordinate `src` of the axis; returns `t`."""
    g = _axis(axis)
    if _live(g):
        COUNTS["broadcast"] += 1
        peer = g.ranks[src] if g.ranks else src
        _dist().broadcast(t, src=peer, **_kw(g))
    return t


def ppermute(t: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """One ring hop along the axis (JAX's `lax.ppermute` with the
    permutation i -> (i + shift) % n): returns the tensor that coordinate
    `rank - shift` held, as a new tensor on `t`'s device. Gloo moves a
    CUDA tensor through pinned host buffers (module docstring)."""
    g = _axis(axis)
    n = g.world
    if not _live(g) or n == 1 or shift % n == 0:
        return t.clone()
    COUNTS["ppermute"] += 1
    dist = _dist()
    to = g.ranks[(g.rank + shift) % n]
    frm = g.ranks[(g.rank - shift) % n]
    src = t.contiguous()
    staged = g.backend == "gloo" and src.device.type != "cpu"
    if staged:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        src = host
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, to, group=g.pg),
           dist.P2POp(dist.irecv, out, frm, group=g.pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(t.device, non_blocking=False) if staged else out


class _DPSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward is the all-reduce sum of
    the incoming gradient (each rank's input reaches every rank's
    output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of the enclosing
    `dp_scope` (the whole world outside one; module docstring)."""
    return _DPSum.apply(x, current() or dp_group())


def warm_up(device) -> None:
    """Every collective kind a captured step may issue (all-reduce,
    reduce-scatter, all-gather) over the world and over every mesh axis
    group made so far, on the current stream of `device`: NCCL creates
    its communicators and per-stream state lazily, which must not happen
    inside a CUDA graph capture. Counted in COUNTS like any collective."""
    if not initialized():
        return
    groups = [dp_group()] + [g for gs in _MESH_GROUPS.values()
                             for g in gs.values() if g.pg is not None]
    for g in groups:
        all_reduce_sum(torch.zeros(1, device=device), g)
        if backend() == "nccl":
            reduce_scatter(torch.zeros(g.world, device=device), g)
            all_gather(torch.zeros(1, device=device), g)


__all__ = ["AXES", "COUNTS", "AxisGroup", "DPGroup", "all_gather",
           "all_reduce_sum", "axis_groups", "backend",
           "broadcast", "current", "destroy_process_group",
           "dp_all_reduce_mean", "dp_group", "dp_scope", "dp_sum",
           "init_process_group", "initialized", "ppermute", "rank",
           "reduce_scatter", "warm_up", "world_size"]
