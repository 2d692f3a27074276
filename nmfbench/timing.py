"""Clocks and the device trace: the benchmark's own copies.

``wall`` is the host clock around work that ends in a synchronise, as
``chip_smoke.py``'s ``wall_ms`` takes it.  ``profile`` follows its
``profile_device_ms``: ``torch.profiler`` over one call, CPU and CUDA
activities, in a fresh window; instead of summing ``key_averages`` it
reads the exported trace, so that the device's busy time is the union of
its operations' intervals (overlaps count once), and the idle gaps
between them can be named by what the host was doing meanwhile.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10  # entries of each list of the breakdown


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(torch, device, fn):
    """(fn(), seconds) by the host clock, synchronised on both sides."""
    sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, device)
    return out, time.perf_counter() - t0


def profile(torch, device, fn):
    """Run ``fn`` once under ``torch.profiler``; return ``(fn(), trace)``
    with ``trace`` the reading of :func:`read_trace` and ``window_s`` the
    call's seconds by the host clock."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(torch, device)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(torch, device)
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    reading = read_trace(events)
    reading["window_s"] = window
    return out, reading


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(events):
    """Busy seconds (the union of device operations), device seconds by
    operation name, and the idle gaps between device operations summed by
    the innermost host event that covers each gap's middle, from a Chrome
    trace's events (times in microseconds)."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, s + d, e.get("name", "?")))
        elif e.get("cat") in HOST_CATS:
            host.append((s, s + d, e.get("name", "?")))
    by_op = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    merged = _union((s, e) for s, e, _ in dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps, active, nxt = {}, [], 0
    host.sort()
    for (_, e0), (s1, _) in zip(merged, merged[1:]):  # gaps in time order
        mid = 0.5 * (e0 + s1)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        label = (min(active, key=lambda h: h[1] - h[0])[2] if active
                 else "host, no traced op")
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    return {"busy_s": busy, "device_ops": top(by_op), "idle_gaps": top(gaps),
            "device_op_counts": _counts(dev)}


def _counts(dev):
    out = {}
    for _, _, name in dev:
        out[name] = out.get(name, 0) + 1
    return out


def top(d):
    """The largest TOP entries of a {name: seconds} map, as [name, seconds]."""
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
