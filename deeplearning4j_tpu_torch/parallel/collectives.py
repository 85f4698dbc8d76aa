"""The port's collectives: the one module that calls `torch.distributed`.

Data parallelism in the port is one process per rank and one device per
process, so the data-parallel extent `dp` is the size of the live
process group. Everything that exchanges tensors between ranks (the
per-step gradient all-reduce, the global BatchNorm statistics, ZeRO-1's
reduce-scatter and all-gather, the local-SGD rendezvous, the stale
trainer's gradient average) calls the functions below.

  init_process_group(address, n, rank, backend=None, device=None)
        the group (TrainingMaster.initialize_distributed calls it):
        `backend=None` is NCCL for a CUDA device and gloo for the CPU; an
        NCCL group is bound to its device (`device_id`), so its
        communicator exists before any capture.
  DPGroup / dp_group()
        the dp axis over the live default group (world, rank, backend).
  dp_all_reduce_mean(t), all_reduce_sum(t)
        in place, on one tensor (callers pack many into one bucket).
  reduce_scatter(flat), all_gather(mine)
        of flat buffers whose length is a multiple of the world size:
        rank r keeps / contributes chunk r.
  broadcast(t, src)
  dp_sum(x)
        a DIFFERENTIABLE sum over ranks whose backward is itself an
        all-reduce sum: the route of BatchNorm's per-channel sums and the
        loss's live-row count under per-step dp (`dp_scope`).

Gloo has no reduce-scatter or all-gather into one tensor on CUDA tensors
(and not in every release on CPU tensors), so for every gloo group both
are expressed through `all_reduce`: a reduce-scatter is the all-reduce of
the whole buffer followed by taking this rank's chunk, and an all-gather
is the all-reduce of a zero buffer holding only this rank's chunk. They
move W times the bytes of the NCCL collectives and give the same values
(each element of an all-gather is one rank's value plus zeros). This is
the documented way a gloo group runs them, on the CPU as on the card, not
a fallback: an NCCL group always takes `reduce_scatter_tensor` and
`all_gather_into_tensor`.

Without a process group the world is one process and every collective
is the identity (a copy where it returns a new tensor): a single-process
run needs no group. `COUNTS` counts the collectives issued per kind (a CUDA graph capture
reads them before and after, so a captured group records which
collectives it holds).
"""

from __future__ import annotations

import contextlib
import datetime
import threading
from dataclasses import dataclass
from typing import Optional

import torch

COUNTS = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0,
          "broadcast": 0}


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
    has no index), which creates the communicator eagerly."""
    from deeplearning4j_tpu_torch.device import resolve_device

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
    """Leave and destroy the default group (no-op without one)."""
    if initialized():
        _dist().destroy_process_group()


@dataclass(frozen=True)
class DPGroup:
    """The dp axis over the live default process group."""
    world: int
    rank: int
    backend: Optional[str]


def dp_group() -> DPGroup:
    """The dp axis of the live world (world 1, rank 0 without a group)."""
    return DPGroup(world_size(), rank(), backend())


# ------------------------------------------------------- the dp scope
_SCOPE = threading.local()


@contextlib.contextmanager
def dp_scope(group: Optional[DPGroup]):
    """Within the block, BatchNorm's batch statistics and the loss's
    live-row count are global over `group` (when its world exceeds 1):
    the per-step dp semantics of one program over the global batch."""
    prev = getattr(_SCOPE, "group", None)
    _SCOPE.group = group if group is not None and group.world > 1 else None
    try:
        yield
    finally:
        _SCOPE.group = prev


def current() -> Optional[DPGroup]:
    """The dp group of the enclosing `dp_scope` (None outside one, or for
    a world of 1)."""
    return getattr(_SCOPE, "group", None)


# -------------------------------------------------------- collectives
def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over ranks; returns `t`."""
    if initialized():
        COUNTS["all_reduce"] += 1
        _dist().all_reduce(t, op=_dist().ReduceOp.SUM)
    return t


def dp_all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """In-place mean over ranks (a sum, then divided by the world);
    returns `t`."""
    all_reduce_sum(t)
    w = world_size()
    if w > 1:
        t.div_(w)
    return t


def _chunk(n: int, w: int) -> int:
    if n % w:
        raise ValueError(f"buffer of {n} elements does not split over "
                         f"world {w}")
    return n // w


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """Chunk `rank` of the sum over ranks of the 1-D `flat` (its length a
    multiple of the world): a new tensor of len(flat) / world elements.
    Gloo: the all-reduce of a copy, then the chunk (module docstring)."""
    w, r = world_size(), rank()
    c = _chunk(flat.numel(), w)
    if not initialized():
        return flat.clone()
    COUNTS["reduce_scatter"] += 1
    if backend() == "gloo":
        buf = flat.clone()
        _dist().all_reduce(buf, op=_dist().ReduceOp.SUM)
        return buf[r * c:(r + 1) * c].clone()
    out = torch.empty(c, dtype=flat.dtype, device=flat.device)
    _dist().reduce_scatter_tensor(out, flat.contiguous(),
                                  op=_dist().ReduceOp.SUM)
    return out


def all_gather(mine: torch.Tensor) -> torch.Tensor:
    """The ranks' 1-D chunks concatenated in rank order: a new tensor of
    world * len(mine) elements. Gloo: the all-reduce of a zero buffer
    holding this rank's chunk (module docstring)."""
    w, r = world_size(), rank()
    c = mine.numel()
    if not initialized():
        return mine.reshape(-1).clone()
    COUNTS["all_gather"] += 1
    if backend() == "gloo":
        buf = torch.zeros(w * c, dtype=mine.dtype, device=mine.device)
        buf[r * c:(r + 1) * c] = mine.reshape(-1)
        _dist().all_reduce(buf, op=_dist().ReduceOp.SUM)
        return buf
    out = torch.empty(w * c, dtype=mine.dtype, device=mine.device)
    _dist().all_gather_into_tensor(out, mine.reshape(-1).contiguous())
    return out


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In place from rank `src`; returns `t`."""
    if initialized():
        COUNTS["broadcast"] += 1
        _dist().broadcast(t, src=src)
    return t


class _DPSum(torch.autograd.Function):
    """Sum over ranks; the backward is the all-reduce sum of the incoming
    gradient (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone())


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks (module docstring)."""
    return _DPSum.apply(x)


def warm_up(device) -> None:
    """One all-reduce on the current stream of `device`: NCCL creates its
    communicator and per-stream state lazily, which must not happen
    inside a CUDA graph capture."""
    if initialized():
        all_reduce_sum(torch.zeros(1, device=device))


__all__ = ["COUNTS", "DPGroup", "all_gather", "all_reduce_sum", "backend",
           "broadcast", "current", "destroy_process_group",
           "dp_all_reduce_mean", "dp_group", "dp_scope", "dp_sum",
           "init_process_group", "initialized", "rank", "reduce_scatter",
           "warm_up", "world_size"]
