"""nms_slot_use.serve: the share of the NMS keep step's slots that hold an
anchor at or above the gate, from the program's own counters over the
profiled slice: `nms.gated` (per image, min(gated anchors, K)) over
`nms.slots` (per image, K), in percent. Nothing when the program keeps no
such counters."""

from benchmark.program_spans import counters


def read(rec):
    c = counters()
    if not c.get("nms.slots"):
        return None
    return c["nms.gated"] / c["nms.slots"] * 100.0
