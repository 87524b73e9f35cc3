"""Profiling and timing for the port (counterpart of
yololp_tpu/utils/profiler.py; the names are kept).

`trace(logdir)` captures a torch.profiler trace of everything inside the
context (host operators and, on the card, CUDA kernels and copies) and writes
it to `logdir` as a chrome / tensorboard trace. `model_flops` counts the
operators' flops with torch's FlopCounterMode and reads the peak device
memory of one call.

Spans and counters. `annotate(name, device)` is the program's span and
`count(name, value)` its counter; both record only while a torch.profiler
session records (and never while torch.export or torch.compile traces), so
with the profiler off a span is one C call and a shared no-op context, and a
counter nothing. A recorded span is a `record_function` range (in the
device trace, on the profiler's clock), a CUDA event pair on the current
stream when `device` is a card, its host start and end in epoch nanoseconds
(`time.time_ns`, the clock of the profiler's Chrome trace: an event's `ts`
plus `baseTimeNanoseconds`), and its name, id, parent's id and request id.
The outermost span of a thread opens a request id; the spans inside it
inherit it. `span_totals()`, `spans()` and `counters()` read what was
recorded (the events are resolved on read); `reset_spans()` empties it.

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
import threading
import time
from collections import defaultdict, deque
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


# -- spans and counters ------------------------------------------------------

MAX_SPANS = 1 << 14    # individual spans kept (the oldest are dropped; totals keep all)
MAX_PENDING = 1 << 12  # spans whose events wait to be read before a read is forced

_OFF = contextlib.nullcontext()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()


class _Store:
    """What the spans and counters recorded: the last MAX_SPANS spans, the
    totals of every span by name, the counters, and a pool of CUDA events
    by device index."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events: dict = defaultdict(list)
        self.reset()

    def reset(self):
        with self.lock:
            self.spans = deque(maxlen=MAX_SPANS)
            self.pending = []  # closed spans whose events are not read yet
            self.totals = {}   # name -> [count, host_s, device_count, device_s]
            self.counters = {}

    def close(self, span: "_Span"):
        """Keep a closed span. When it is a request's outermost span, read
        the spans whose work has ended and return their events to the pool
        (in a served loop, the last request's: the device is busy with this
        one's, so the read costs it no idle time)."""
        with self.lock:
            self.spans.append(span)
            t = self.totals.setdefault(span.name, [0, 0.0, 0, 0.0])
            t[0] += 1
            t[1] += (span.end_ns - span.start_ns) * 1e-9
            if span.events is not None:
                self.pending.append(span)
            if len(self.pending) >= MAX_PENDING:
                self.resolve()
            elif span.parent is None:
                self.resolve(wait=False)

    def resolve(self, wait: bool = True):
        """Read the device time of the pending spans and return their events
        to the pool; the caller holds the lock. `wait`: every pending span,
        waiting for its end event; else only those whose work has ended."""
        left = []
        for span in self.pending:
            start, end = span.events
            if wait:
                end.synchronize()
            elif not end.query():
                left.append(span)
                continue
            span.device_s = start.elapsed_time(end) * 1e-3
            t = self.totals[span.name]
            t[2] += 1
            t[3] += span.device_s
            self.events[span.device_index] += (start, end)
            span.events = None
        self.pending = left

    def event_pair(self, index: int) -> tuple:
        """Two events of device `index` from the pool (new ones when it is
        empty)."""
        with self.lock:
            pool = self.events[index]
            if len(pool) >= 2:
                return pool.pop(), pool.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def add(self, name: str, value):
        with self.lock:
            prev = self.counters.get(name)
            self.counters[name] = value if prev is None else prev + value


_STORE = _Store()


def recording() -> bool:
    """Whether spans and counters record now: a torch.profiler session is
    recording and no torch.export or torch.compile trace is running."""
    return torch._C._autograd._profiler_enabled() and not torch.compiler.is_compiling()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "device_s",
                 "device_index", "events", "_stream", "_range")

    def __init__(self, name: str, device):
        self.name, self.device_s, self.events = name, None, None
        dev = torch.device(device) if device is not None else None
        self.device_index = (dev.index if dev.index is not None else torch.cuda.current_device()
                             ) if dev is not None and dev.type == "cuda" else None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.request = stack[-1].request if stack else next(_request_ids)
        self.id = next(_span_ids)
        if self.device_index is not None:
            self.events = _STORE.event_pair(self.device_index)
            self._stream = torch.cuda.current_stream(self.device_index)
            self.events[0].record(self._stream)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(self._stream)
            self._stream = None
        _stack().pop()
        self._range.__exit__(*exc)
        self._range = None
        _STORE.close(self)
        return False


def annotate(name: str, device=None):
    """The program's span `name` around a block (a context manager).
    `device`: the device the block's tensors are on; on a card the span
    also times the block's work on the current stream with a CUDA event
    pair. With no profiler recording, a shared no-op context."""
    if not recording():
        return _OFF
    return _Span(name, device)


def count(name: str, value):
    """Add `value` (an int, or a 0-d tensor, summed on its device) to the
    counter `name`; nothing unless spans record (`recording()`). A caller
    that computes `value` on the device checks `recording()` first, and
    launches that work after the span it describes has closed."""
    if recording():
        _STORE.add(name, value)


def span_totals() -> dict:
    """{name: {"count", "host_s", "device_count", "device_s"}} over every
    span recorded since `reset_spans()`: occurrences, host seconds, the
    occurrences timed on a card and their device seconds (None when none
    was). Waits for the spans' device work to end."""
    with _STORE.lock:
        _STORE.resolve()
        return {k: {"count": c, "host_s": h, "device_count": dc, "device_s": ds if dc else None}
                for k, (c, h, dc, ds) in _STORE.totals.items()}


def spans() -> list:
    """The last MAX_SPANS spans, oldest first, each a dict: name, id,
    parent (None for a request's outermost span), request, start_ns and
    end_ns (epoch nanoseconds), device_s (None off the card)."""
    with _STORE.lock:
        _STORE.resolve()
        return [{"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
                 "start_ns": s.start_ns, "end_ns": s.end_ns, "device_s": s.device_s}
                for s in _STORE.spans]


def counters() -> dict:
    """{name: int} of every counter since `reset_spans()` (reads device
    values once)."""
    with _STORE.lock:
        return {k: int(v) for k, v in _STORE.counters.items()}


def reset_spans():
    """Forget every span and counter recorded so far."""
    _STORE.reset()


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
