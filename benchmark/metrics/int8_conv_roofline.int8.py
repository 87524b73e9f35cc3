"""int8_conv_roofline.int8: the least time the H100 could take for one
batch's int8 conv launches (each launch the larger of its operations over
the int8 peak and its bytes over HBM bandwidth, summed; benchmark/flops/
int8.py counts them on the int8 plan's shapes) over the summed device time
of the `int8_conv_kernel` launches of a batch in the profiled slice, in
percent. Nothing unless the trace holds as many of those launches as the
program's own counter `int8.convs` counted over the slice, and as many as
the plan has a batch: CUPTI can drop kernels from a long trace, and a time
that misses launches would overstate the share."""

from benchmark.flops.int8 import launch_bound_s
from benchmark.program_spans import counters


def read(rec):
    tr, work = rec.get("trace"), rec.get("int8_work")
    if not tr or not work:
        return None
    launches = [d for k, v in tr["kernels"].items() if "int8_conv_kernel" in k for d in v]
    n = tr["iters"]
    if not launches or len(launches) != counters().get("int8.convs") or \
            len(launches) != work["convs"] * n:
        return None
    return launch_bound_s(work["launches"]) / (sum(launches) / n) * 100.0
