"""One profiled slice of a cell's loop, reduced to what the per-layer
readers and the result's `breakdown` take.

`torch.profiler` (CPU and CUDA activities) records the slice; its Chrome
trace is written under the run's TMPDIR, read back and deleted. The slice is
the host range `bench.slice`; every device interval (kernel, memcpy, memset)
is clipped to it. A kernel belongs to a benchmark range (`bench.*`) when the
runtime call that launched it lies inside that range on the host.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench.slice"


@contextmanager
def profiled(out: dict):
    """Profile the body; on exit fill `out` with `summarize`'s dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.update(summarize(json.load(f)["traceEvents"]))
    finally:
        os.unlink(path)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events) -> dict:
    """Seconds: `window_s` (the slice), `busy_s` (union of device
    intervals), `device_ops` (device time by name), `ranges` (device time of
    the device operations launched in each bench.* range), `range_kernels`
    (the same, kernels alone), `memcpy` (device time by
    copy kind), `kernels` (durations of each kernel name's launches) and
    `idle_gaps` (idle device time by the innermost host event at the gap)."""
    xs = [e for e in events if e.get("ph") == "X"]
    sl = [e for e in xs if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not sl:
        raise RuntimeError("the profiled slice has no bench.slice range")
    s0, s1, tid = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"], sl[0]["tid"]

    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and e["ts"] < s1 and e["ts"] + e["dur"] > s0]
    busy = _union([(max(e["ts"], s0), min(e["ts"] + e["dur"], s1)) for e in dev])
    ops, memcpy, kernels = defaultdict(float), defaultdict(float), defaultdict(list)
    for e in dev:
        ops[e["name"][:160]] += e["dur"] * 1e-6
        if e["cat"] == "gpu_memcpy":
            memcpy[e["name"]] += e["dur"] * 1e-6
        if e["cat"] == "kernel":
            kernels[e["name"]].append(e["dur"] * 1e-6)

    host = [e for e in xs if e.get("tid") == tid and e.get("cat") in ("cpu_op", "user_annotation")
            and e["ts"] < s1 and e["ts"] + e["dur"] > s0]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    bench = defaultdict(list)  # name -> sorted (start, end) on the host
    for e in sorted(host, key=lambda e: e["ts"]):
        if e["name"].startswith("bench.") and e["name"] != SLICE:
            bench[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    ranges, range_kernels = defaultdict(float), defaultdict(float)
    for e in dev:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for name, spans in bench.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                ranges[name] += e["dur"] * 1e-6
                if e["cat"] == "kernel":
                    range_kernels[name] += e["dur"] * 1e-6

    # idle gaps, each named by the innermost host event open at its middle
    # (host events of one thread nest, so a stack sweep finds it)
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    mids = sorted(((a + b) / 2, (b - a) * 1e-6) for a, b in zip(edges[0::2], edges[1::2]) if b > a)
    starts = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    gaps, stack, i = defaultdict(float), [], 0
    for mid, length in mids:
        while i < len(starts) and starts[i]["ts"] <= mid:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < starts[i]["ts"]:
                stack.pop()
            stack.append(starts[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        gaps[stack[-1]["name"] if stack else "host outside any op"] += length
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return dict(window_s=(s1 - s0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
                device_ops=top(ops), idle_gaps=top(gaps), ranges=dict(ranges),
                range_kernels=dict(range_kernels),
                memcpy=dict(memcpy), kernels=dict(kernels))
