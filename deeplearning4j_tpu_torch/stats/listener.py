"""StatsListener: collects training telemetry into a StatsStorage
(counterpart of deeplearning4j_tpu/stats/listener.py).

Parity: ui/stats/BaseStatsListener.java:106 — score, throughput, ETL
time, memory, and histograms + mean magnitudes of parameters and
updates, sampled every `frequency` iterations.

The summaries are computed on the net's device in one pass over the
parameter groups: every group is laid end to end in one f32 vector; a
tree reduction per group gives its min, max and mean |x|, and a few
whole-vector kernels (each element's bin, one sort of the (group, bin)
keys, one `searchsorted`) give every group's histogram counts, for the
params and for the update over the window, packed into one small tensor
and copied to the host once — only on collection iterations; the other iterations
read nothing from the device. "Updates" are the parameter deltas across
the collection window. The params are read through the net's views of
its train carry (`_params_view`), so the listener never drops the flat
carry; the window's baseline is a copy of them, never a view: the carry
(and a captured group's static buffers) are rewritten by the next
steps.

Histograms follow `jnp.histogram(x, bins, range=None)` (numpy's rule):
`bins` equal bins over [min, max] (widened by 0.5 each side when
min == max), each bin closed on the left, the last one closed on both
sides; a value is placed by searching the f32 bin edges. The edges are
computed in f32 here and by jnp there, and may differ in their last bit,
so a value lying exactly on an interior edge may land one bin apart
between the packages.
"""

from __future__ import annotations

import resource
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.stats.report import Histogram, StatsReport
from deeplearning4j_tpu_torch.stats.storage import StatsStorage


def _score_once(model):
    """At most ONE score() call per report (score() reads the device)."""
    s = model.score()
    return None if s is None else float(s)


def _named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(group_name, leaf), ...] in jax.tree_util order with the JAX
    package's names: '0/W' (layer list), 'conv1/gamma' (graph)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, v in items:
        out.extend(_named_leaves(v, f"{prefix}/{name}" if prefix else name))
    return out


# elements per chunk of the per-group reductions (summarize_flat)
_CHUNK = 1 << 16


def _flat(named):
    """(sizes, one f32 vector of every group in order) of `named`."""
    sizes = [int(t.numel()) for _, t in named]
    x = torch.cat([t.detach().reshape(-1).float() for _, t in named])
    return sizes, x


def summarize_flat(x, sizes, bins: int):
    """One [groups, 3 + bins] float64 tensor on `x`'s device: per group
    (the consecutive runs of `sizes` elements of the f32 vector `x`)
    min, max, mean |x| and the `bins` histogram counts (module
    docstring's rule, by numpy's own algorithm: the bin from the affine
    formula, then corrected against the group's f32 edges). A fixed
    number of whole-vector kernels, whatever the number of groups, and
    no atomics on a few hot addresses (a segment reduction by scatter
    serializes on them): min, max and the float64 sum of |x| reduce per
    chunk, then per group; each element's (group, bin) key is sorted and
    the counts read off by `searchsorted`. No host read."""
    dev, g, n = x.device, len(sizes), x.numel()
    # the groups laid out in whole chunks of _CHUNK (the last one of
    # each padded): a chunk belongs to one group, so min, max and sum
    # reduce per chunk (trees), then per group over its few chunks
    nch = [-(-k // _CHUNK) for k in sizes]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cstarts = np.concatenate([[0], np.cumsum(nch)[:-1]]) * _CHUNK
    host = torch.from_numpy(np.stack([
        np.asarray(sizes, np.int64), np.asarray(nch, np.int64),
        (cstarts - starts).astype(np.int64)]))
    if dev.type == "cuda":   # pinned: the copy does not wait for the card
        host = host.pin_memory()
    lengths, chunks, shift = host.to(dev, non_blocking=True)
    seg = torch.repeat_interleave(torch.arange(g, device=dev), lengths,
                                  output_size=n)
    dst = torch.arange(n, device=dev) + shift[seg]
    owner = torch.repeat_interleave(torch.arange(g, device=dev), chunks,
                                    output_size=sum(nch))
    inf = float("inf")

    def per_group(fill, values, reduce, dtype=torch.float32):
        pad = torch.full((sum(nch) * _CHUNK,), fill, dtype=dtype,
                         device=dev)
        pad[dst] = values
        part = getattr(pad.view(-1, _CHUNK), reduce)(1)
        out = torch.full((g,), fill, dtype=dtype, device=dev)
        return out.scatter_reduce_(0, owner, part, reduce)

    lo = per_group(inf, x, "amin")
    hi = per_group(-inf, x, "amax")
    mean = per_group(0.0, x.abs().double(), "sum", torch.float64) / lengths
    same = lo == hi
    first = torch.where(same, lo - 0.5, lo)
    last = torch.where(same, hi + 0.5, hi)
    fracs = torch.arange(bins + 1, dtype=torch.float32, device=dev) / bins
    edges = first[:, None] + (last - first)[:, None] * fracs[None, :]
    edges[:, -1] = last
    idx = ((x - first[seg]) * (bins / (last - first))[seg]).long()
    idx.clamp_(0, bins - 1)
    row = seg * (bins + 1)
    flat_edges = edges.reshape(-1)
    idx -= (x < flat_edges[row + idx]).long()
    idx += ((x >= flat_edges[row + idx + 1])
            & (idx != bins - 1)).long()
    keys = torch.sort(seg * bins + idx).values
    bounds = torch.searchsorted(
        keys, torch.arange(g * bins + 1, device=dev))
    counts = (bounds[1:] - bounds[:-1]).reshape(g, bins)
    return torch.cat([torch.stack([lo.double(), hi.double(), mean], 1),
                      counts.double()], 1)


def summarize(named, bins: int):
    """`summarize_flat` of [(name, tensor), ...]."""
    sizes, x = _flat(named)
    return summarize_flat(x, sizes, bins)


class StatsListener:
    """Attach with `net.listeners.append(StatsListener(storage))`.

    collect_histograms/collect_updates mirror the reference's
    DefaultStatsUpdateConfiguration toggles."""

    def __init__(self, storage: StatsStorage, frequency: int = 10,
                 session_id: Optional[str] = None,
                 worker_id: str = "local",
                 collect_histograms: bool = True,
                 collect_updates: bool = True,
                 num_bins: int = 32):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"session-{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.collect_updates = collect_updates
        self.num_bins = num_bins
        self._prev_params = None
        self._last_time = None
        self._last_iter = None

    # ------------------------------------------------------------ device side
    @staticmethod
    def _snapshot(model):
        """The params as one f32 vector (a copy: the next window's
        baseline)."""
        return _flat(_named_leaves(model._params_view()))[1]

    def _collect_summaries(self, net) -> Dict[str, Any]:
        named = _named_leaves(net._params_view())
        sizes, x = _flat(named)
        parts = [summarize_flat(x, sizes, self.num_bins)]
        kinds = ["params"]
        if self.collect_updates and self._prev_params is not None:
            parts.append(summarize_flat(x - self._prev_params, sizes,
                                        self.num_bins))
            kinds.append("updates")
        host = torch.cat(parts).cpu().numpy()   # the one device read
        out = {}
        for j, kind in enumerate(kinds):
            block = host[j * len(named):(j + 1) * len(named)]
            hists, means = {}, {}
            for (name, _), row in zip(named, block):
                means[name] = float(row[2])
                if self.collect_histograms:
                    hists[name] = Histogram(
                        min=float(row[0]), max=float(row[1]),
                        counts=[int(c) for c in row[3:]])
            out[kind] = (means, hists)
        if self.collect_updates:
            self._prev_params = x
        return out

    # -------------------------------------------------------------- listener
    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            # baseline snapshot so the first collected window has updates
            if self.collect_updates and model._initialized():
                self._prev_params = self._snapshot(model)
            return
        if iteration % self.frequency != 0:
            return

        dt = now - self._last_time
        n = max(iteration - self._last_iter, 1)
        batches_per_sec = n / dt if dt > 0 else None
        batch = getattr(model, "_last_batch_size", None)
        report = StatsReport(
            session_id=self.session_id,
            worker_id=self.worker_id,
            iteration=iteration,
            epoch=getattr(model, "epoch", 0),
            score=_score_once(model),
            batches_per_sec=batches_per_sec,
            samples_per_sec=(batches_per_sec * batch
                             if batches_per_sec and batch else None),
            iter_ms=dt / n * 1e3,
            etl_ms=getattr(model, "_last_etl_ms", None),
            mem=self._memory(model),
        )
        summaries = self._collect_summaries(model)
        report.param_mean_magnitudes, report.param_histograms = \
            summaries["params"]
        if "updates" in summaries:
            (report.update_mean_magnitudes,
             report.update_histograms) = summaries["updates"]
        self.storage.put_report(report)
        self._last_time = time.perf_counter()
        self._last_iter = iteration

    @staticmethod
    def _memory(model) -> Dict[str, Any]:
        mem = {"host_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0}
        dev = getattr(model, "device", None)
        if dev is not None and dev.type == "cuda":
            mem["device_in_use_mb"] = torch.cuda.memory_allocated(dev) / 1e6
            mem["device_limit_mb"] = torch.cuda.get_device_properties(
                dev).total_memory / 1e6
        return mem
