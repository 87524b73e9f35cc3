"""decode_anchors.serve: the anchor rows an image that the decode hands the
NMS gate: the program's own counter `decode.anchors` (B x A at each call of
`Detect.decode`) over the images decoded in the profiled slice (its batches
times the batch). Nothing when the program keeps no such counter."""

from benchmark.program_spans import counters


def read(rec):
    n = counters().get("decode.anchors")
    tr = rec.get("trace")
    if not n or not tr:
        return None
    return n / (tr["iters"] * rec["batch"])
