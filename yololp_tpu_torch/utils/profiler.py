"""Profiling and timing for the port (counterpart of
yololp_tpu/utils/profiler.py; the names are kept).

`trace(logdir)` captures a torch.profiler trace of everything inside the
context (host operators and, on the card, CUDA kernels and copies) and writes
it to `logdir` as a chrome / tensorboard trace; `annotate(name)` adds a named
region (a `record_function`, and an NVTX range on the card). `model_flops`
counts the operators' flops with torch's FlopCounterMode and reads the peak
device memory of one call.

Timing. A "scan" is a Python loop of K chained steps, each step's input
computed from the previous step's output, so no step can be skipped. The
timed call ends with a small reduction of the output. On the card the call
is timed by CUDA events around the launches (the device time of the K steps
plus whatever the host leaves the card idle); on the CPU by the host clock,
ending with an `.item()` of the reduction.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Any

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block into `logdir` (chrome
    trace, readable by tensorboard's profiler plugin and perfetto)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region: torch.profiler.record_function, and an NVTX range
    when a card is present."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _leaves(tree) -> list:
    """Tensor leaves of nested tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def model_flops(fn, *example_args) -> dict:
    """Operator flops of one call of `fn` (FlopCounterMode: matmuls and
    convolutions, 2 flops a multiply-add; a kernel launched through ctypes
    is not seen), and `peak_memory_bytes`, the peak of
    torch.cuda.max_memory_allocated over the call on the card (None on the
    CPU). XLA's "bytes accessed" has no PyTorch counterpart, so that key is
    left out."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = next((t.device for t in _leaves(example_args)), torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    out = {"flops": counter.get_total_flops(), "peak_memory_bytes": None}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def kernel_device_ms(fn, name: str, calls: int = 10, attempts: int = 3) -> float:
    """Device milliseconds per call of `fn` spent in the CUDA kernels whose
    name contains `name`, by torch.profiler over `calls` calls after one
    warm call: the kernel's own time, without the host's launch gaps. A
    profiling session that records none of the kernel's launches (CUPTI
    dropped them once on the H100 machine, right after a profile that saw
    the same kernel) is repeated, up to `attempts` sessions in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key)
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError(f"the profiler saw no device time in a kernel named *{name}* "
                       f"in {attempts} sessions")


def fresh_operands(op):
    """Operands rebuilt as new tensors on their device, each tensor of
    ndim > 0 rolled by one along axis 0 (distribution unchanged)."""
    def one(t):
        return torch.roll(t, 1, 0) if t.dim() else t.clone()

    return tuple(_map_tensors(one, x) for x in op)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _reduce_to_scalar(out) -> torch.Tensor:
    """fp32 scalar that depends on every tensor leaf of `out`."""
    return sum(x.float().sum() * 1e-9 for x in _leaves(out))


def _fresh_rolled(op, shift: int):
    """The operands with the first tensor leaf of ndim > 0 (anywhere in the
    operand trees) rolled along axis 0 by `shift`, on its device; the rest
    unchanged. Rolling one leaf is irrelevant for timing; it gives each timed
    call contents it has not seen."""
    found = []

    def roll(t):
        if found or t.dim() == 0:
            return t
        found.append(t)
        return torch.roll(t, shift, 0)

    rolled = _map_tensors(roll, op)
    return rolled if found else op


def _device(op) -> torch.device:
    return next((t.device for t in _leaves(op)), torch.device("cpu"))


def _timed_value_fetch(fn, op) -> float:
    """Seconds of one call of `fn` (which ends in a small reduction): CUDA
    events around it on the card; on the CPU the host clock, ending with the
    reduction's `.item()`."""
    dev = _device(op)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*op)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(fn(*op).item())
    return time.perf_counter() - t0


_TS_SHIFT = itertools.count(1)


def _reduced(make_fn):
    def fn(*a: Any):
        return _reduce_to_scalar(make_fn(*a))
    return fn


def timed_scan(make_fn, iters: int, *op) -> float:
    """Per-step seconds of `make_fn(*op)`, a K = `iters`-step chained loop:
    one warm call, then one timed call on rolled operand contents."""
    fn = _reduced(make_fn)
    _timed_value_fetch(fn, op)  # warm-up: builds kernels, fills caches
    return _timed_value_fetch(fn, _fresh_rolled(op, next(_TS_SHIFT))) / iters


def timed_scan_delta(make_fn_of_k, iters: int, *op) -> float:
    """Per-step seconds from the difference of two single timed calls:
    (time of the 2K-step loop - time of the K-step loop) / K, which cancels
    the cost that does not grow with K (launch of the first step, the final
    reduction). `make_fn_of_k(K)` returns the K-step loop."""
    t1 = timed_scan(make_fn_of_k(iters), iters, *op) * iters
    t2 = timed_scan(make_fn_of_k(2 * iters), 2 * iters, *op) * 2 * iters
    return max(t2 - t1, 1e-12) / iters


def timed_scan_delta2(make_fn_of_k, iters: int, *op, repeats: int = 3,
                      attempts: int = 3) -> float:
    """Per-step seconds: the median of `repeats` timed calls of the 2K-step
    loop minus the median of the K-step loop, over K; each timed call on
    freshly rolled operand contents, after one warm call of each loop. The K
    and 2K calls alternate, so a drift of the card's or the host's speed
    (the first calls after an idle spell can run slower) weighs on both.

    The K -> 2K scaling guard stays: if the 2K loop does not take more than
    1.05x the K loop, the difference would be noise. The measurement is then
    taken anew at twice the K, up to `attempts` measurements in all, and it
    raises if none scaled."""
    import numpy as np

    shift = itertools.count(1001)  # disjoint from timed_scan's shifts
    k = iters
    tried = []
    for _ in range(attempts):
        fns = (_reduced(make_fn_of_k(k)), _reduced(make_fn_of_k(2 * k)))
        for fn in fns:
            _timed_value_fetch(fn, op)  # warm-up
        walls = [[], []]
        for _ in range(repeats):
            for fn, w in zip(fns, walls):
                w.append(_timed_value_fetch(fn, _fresh_rolled(op, next(shift))))
        t1, t2 = (float(np.median(w)) for w in walls)
        if t2 > t1 * 1.05:
            return (t2 - t1) / k
        tried.append(f"K={k}: {t1 * 1e3:.3f} ms, 2K: {t2 * 1e3:.3f} ms")
        k *= 2
    raise RuntimeError(
        f"K->2K wall did not scale in {attempts} measurements ({'; '.join(tried)}): "
        "the signal is below the timer's noise; increase iters")
