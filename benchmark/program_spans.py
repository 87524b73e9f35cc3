"""The program's own spans and counters (yololp_tpu_torch/utils/profiler.py:
`annotate`, `count`), as the program recorded them while the profiled slice
ran; nothing else in a run records them. A program without them (a checkout
older than the facility) gives None here, and raises nothing."""

from __future__ import annotations

from yololp_tpu_torch.utils import profiler


def span_device_ms(name: str):
    """Mean device milliseconds an occurrence of the program's span `name`
    (its CUDA event pair), or None where no occurrence was timed on a card."""
    totals = getattr(profiler, "span_totals", None)
    t = totals().get(name) if totals else None
    if not t or not t["device_count"]:
        return None
    return t["device_s"] / t["device_count"] * 1e3


def counters() -> dict:
    """The program's counters by name ({} where it keeps none)."""
    read = getattr(profiler, "counters", None)
    return read() if read else {}
