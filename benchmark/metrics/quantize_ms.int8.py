"""quantize_ms.int8: the float -> int8 code quantize passes of a batch, in
device ms: the program's span `int8.quantize` (its CUDA event pair; one
occurrence a quantize), summed over its occurrences in the profiled slice
and divided by the slice's batches. Nothing when the program recorded no
such span on a card."""

from yololp_tpu_torch.utils import profiler


def read(rec):
    tr = rec.get("trace")
    totals = getattr(profiler, "span_totals", None)
    t = totals().get("int8.quantize") if totals else None
    if not tr or not t or not t["device_count"]:
        return None
    return t["device_s"] * 1e3 / tr["iters"]
