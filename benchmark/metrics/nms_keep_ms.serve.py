"""nms_keep_ms.serve: the greedy keep-mask, the kernel csrc/greedy_nms.cu
(ops/cuda_nms.py:greedy_nms_mask), in mean device ms an occurrence of the
program's own span `nms.keep` (its CUDA event pair;
benchmark/program_spans.py), over the profiled slice. Nothing when the
program recorded no such span."""

from benchmark.program_spans import span_device_ms


def read(rec):
    return span_device_ms("nms.keep")
