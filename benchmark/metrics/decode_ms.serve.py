"""decode_ms.serve: the decode of the head's maps: flatten, fp32 widening,
sigmoid, anchors, boxes and corners, the 290-column concat
(models/effidehead.py:Detect.decode), in mean device ms an occurrence of the
program's own span `model.decode` (its CUDA event pair;
benchmark/program_spans.py), over the profiled slice. Nothing when the
program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("model.decode")
