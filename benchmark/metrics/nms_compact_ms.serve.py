"""nms_compact_ms.serve: the NMS compaction: the stable order of kept slots,
the gathers, the zeroing and the count (ops/nms.py:non_max_suppression), in
mean device ms an occurrence of the program's own span `nms.compact` (its
CUDA event pair; benchmark/program_spans.py), over the profiled slice.
Nothing when the program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("nms.compact")
