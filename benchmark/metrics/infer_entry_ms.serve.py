"""infer_entry_ms.serve: the inferer's entry: the uint8 batch's H2D copy and
the /255 in the compute dtype (core/inferer.py:deploy_decode), in mean
device ms an occurrence of the program's own span `infer.entry` (its CUDA
event pair; benchmark/program_spans.py), over the profiled slice. Nothing
when the program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("infer.entry")
