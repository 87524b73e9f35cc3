"""quantize_fused.int8: the share of the int8 plan's float -> code quantizes
that ran as one launch of the kernel csrc/quantize.cu, from the program's
own counter and spans over the profiled slice: `int8.quantize_fused` (counted
by the kernel's launcher after each launch) over the occurrences of the span
`int8.quantize`, in percent. Nothing when no quantize ran, or no quantize
launched the kernel (the plain version, or a program without the kernel)."""

from benchmark.program_spans import counters
from yololp_tpu_torch.utils import profiler


def read(rec):
    totals = getattr(profiler, "span_totals", None)
    t = totals().get("int8.quantize") if totals else None
    fused = counters().get("int8.quantize_fused")
    if not t or not t["count"] or fused is None:
        return None
    return fused / t["count"] * 100.0
