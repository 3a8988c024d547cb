"""Readings taken around the program: host syncs, and a torch.profiler
trace of one call reduced to device busy time, kernel time by name, the
conv kernel's events and the idle gaps with what the host was doing.

Busy time is the union of the device's intervals (kernels, copies,
memsets): a sum of event durations would count overlapping events twice.
"""

from __future__ import annotations

import collections
import os
import time
import warnings

import torch


def count_syncs(fn):
    """(fn's result, host syncs, {call site: syncs}) of one call of fn under
    torch.cuda.set_sync_debug_mode('warn'): every synchronizing CUDA call
    warns, and the warning names the Python line that made it."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    return out, len(syncs), dict(sites.most_common())


def is_conv_kernel(name):
    """A launch of the program's conv kernel: every tile family's kernel
    is named conv3x3_*_kernel."""
    return "conv3x3_" in name and "_kernel" in name


def _raw_events(prof):
    """[(name, on_device, start_us, end_us)] of a finished profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), "CUDA" in str(e.device_type()), start,
                    start + e.duration_ns() / 1e3))
    return out


def _union(intervals):
    """Merged [start, end] segments of `intervals`, sorted."""
    segs = []
    for s, e in sorted(intervals):
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], e)
        else:
            segs.append([s, e])
    return segs


# idle gaps shorter than this are the device's own spacing between
# launches, not the host holding it back
SMALL_GAP_US = 10.0


def short_name(name, n=96):
    return name if len(name) <= n else name[:n - 3] + "..."


def profile(fn):
    """One call of fn under torch.profiler (CPU and CUDA activity), reduced
    to a dict: wall_s, busy_s (union of device intervals), device_events,
    conv_events, conv_s, device_ops (the ten kernels of most device time,
    [name, seconds]), idle_gaps (the device's idle time inside the window
    by the host op that ran across it, the ten largest, [name, seconds]),
    and fn's result under 'out'."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _raw_events(prof)
    dev = [(s, e, n) for n, d, s, e in events if d and e > s]
    host = [(s, e, n) for n, d, s, e in events if not d and e > s]
    segs = _union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in segs) / 1e6
    by_name = collections.Counter()
    conv_n, conv_us = 0, 0.0
    for s, e, n in dev:
        by_name[n] += e - s
        if is_conv_kernel(n):
            conv_n += 1
            conv_us += e - s
    gaps = collections.Counter()
    host.sort()
    active, i = [], 0
    for (_, a), (b, _) in zip(segs, segs[1:]):
        if b - a < SMALL_GAP_US:
            gaps[f"between kernels, under {SMALL_GAP_US:g} us"] += \
                (b - a) / 1e6
            continue
        while i < len(host) and host[i][0] < b:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > a]
        gaps[_host_across(active, a, b)] += (b - a) / 1e6
    return {"out": out, "wall_s": wall, "busy_s": busy,
            "device_events": len(dev), "conv_events": conv_n,
            "conv_s": conv_us / 1e6,
            "device_ops": [[short_name(n), us / 1e6]
                           for n, us in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}


def _host_across(host, a, b):
    """The host op that covers most of the gap [a, b] (the innermost of
    those that cover as much), or 'host, no op'."""
    best, best_key = "host, no op", None
    for s, e, n in host:
        cover = min(e, b) - max(s, a)
        if cover <= 0:
            continue
        key = (cover, -(e - s))
        if best_key is None or key > best_key:
            best, best_key = n, key
    return short_name(best)
