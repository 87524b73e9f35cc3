"""head_ms.serve: the head's convs up to its pred maps
(models/effidehead.py:Detect.pred_maps), in mean device ms an occurrence of
the program's own span `model.head` (its CUDA event pair;
benchmark/program_spans.py), over the profiled slice. Nothing when the
program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("model.head")
