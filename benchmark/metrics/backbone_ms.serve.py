"""backbone_ms.serve: the backbone's forward (models/yolo.py:Model.forward), in
mean device ms an occurrence of the program's own span `model.backbone` (its
CUDA event pair; benchmark/program_spans.py), over the profiled slice.
Nothing when the program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("model.backbone")
