"""p6_ms.serve: what a batch spends on the stride-64 level of a P6 model:
the sum of the mean device ms an occurrence of the program's own spans
`model.backbone.p6` (ERBlock_6: its down block, BepC3 and SPPF),
`model.neck.p6` (downsample0 and Rep_n6) and `model.head.p6` (the head's
stride-64 level up to its pred maps), each its CUDA event pair
(benchmark/program_spans.py), over the profiled slice. Nothing unless the
program timed all three (a P5 model opens none of them)."""

from benchmark.program_spans import span_device_ms

SPANS = ("model.backbone.p6", "model.neck.p6", "model.head.p6")


def read(rec):
    ms = [span_device_ms(name) for name in SPANS]
    return None if None in ms else sum(ms)
