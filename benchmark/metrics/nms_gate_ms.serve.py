"""nms_gate_ms.serve: the NMS gate: xyxy boxes, the 8 task maxima and
argmaxima, the mean-of-8 score and the gate (ops/nms.py:select_candidates),
in mean device ms an occurrence of the program's own span `nms.gate` (its
CUDA event pair; benchmark/program_spans.py), over the profiled slice.
Nothing when the program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("nms.gate")
