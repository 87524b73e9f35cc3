"""nms_gate_fused.serve: the share of the NMS gates that ran as one pass
(the op `yololp_torch::nms_gate`: the kernel csrc/nms_gate.cu on the card),
from the program's own counters over the profiled slice: `nms.gate_fused`
over `nms.gate_calls`, in percent. Nothing when the program keeps no such
counters."""

from benchmark.program_spans import counters


def read(rec):
    c = counters()
    if not c.get("nms.gate_calls"):
        return None
    return c.get("nms.gate_fused", 0) / c["nms.gate_calls"] * 100.0
