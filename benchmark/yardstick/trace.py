"""torch.profiler over a short steady sub-window, reduced to summaries
(no chrome trace is written).

`profile(fn)` runs fn() under the profiler (host and device activity),
synchronizes, and returns:
  window_s     the sub-window's length on the host clock
  busy_s       seconds in which any operation (kernel, copy, set) ran on
               the device: the union of their intervals
  kernel_s     {device operation name: summed seconds}
  device_ops   the 10 device operations with the most summed time
  idle_gaps    the device's idle time in the window (before the first
               operation, between operations, after the last), summed by
               what the host was doing when each gap began (the innermost
               host event open then), the 10 largest; gaps beyond the
               NAMED longest are summed as one entry, so the reduction
               stays short however many kernels the window ran
"""

from __future__ import annotations

import bisect
import time

import torch

TOP = 10
# host events looked back through to name an idle gap
SCAN = 5000
# idle gaps named by their host event, longest first
NAMED = 256


def _device_events(events):
    dev = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type == dev
            and e.time_range.end > e.time_range.start]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_at(host, starts, t):
    """Name of the latest-starting host event open at time t (us): the
    innermost one of its thread. `host` is sorted by start."""
    hi = bisect.bisect_right(starts, t)
    for i in range(hi - 1, max(-1, hi - 1 - SCAN), -1):
        if host[i].time_range.end > t:
            return host[i].name
    return "(no host event)"


def profile(fn):
    from torch.profiler import ProfilerActivity, profile as _profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = _device_events(events)
    kernel_s = {}
    for e in dev:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(e - s for s, e in merged) / 1e6
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    starts = [e.time_range.start for e in host]
    lo = min(starts) if starts else (merged[0][0] if merged else 0.0)
    hi = max([e.time_range.end for e in host] or [lo])
    gaps = []
    edge = lo
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if hi > edge:
        gaps.append((edge, hi))
    host.sort(key=lambda e: e.time_range.start)
    host_starts = [e.time_range.start for e in host]
    by_host = {}
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    for s, e in gaps[:NAMED]:
        name = _host_at(host, host_starts, s)
        by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
    if len(gaps) > NAMED:
        rest = f"(the {len(gaps) - NAMED} gaps shorter than the {NAMED} named)"
        by_host[rest] = sum(e - s for s, e in gaps[NAMED:]) / 1e6
    top = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)
    return result, {
        "window_s": wall, "busy_s": busy, "kernel_s": kernel_s,
        "device_ops": [[k[:120], v] for k, v in top[:TOP]],
        "idle_gaps": [[k[:120], v] for k, v in sorted(
            by_host.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]}
