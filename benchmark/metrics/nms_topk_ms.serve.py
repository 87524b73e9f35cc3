"""nms_topk_ms.serve: the NMS top-K: the stable sort, the first K, the
candidates' rows gathered (ops/nms.py:select_candidates), in mean device ms
an occurrence of the program's own span `nms.topk` (its CUDA event pair;
benchmark/program_spans.py), over the profiled slice. Nothing when the
program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("nms.topk")
