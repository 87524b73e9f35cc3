"""mfu.int8: the whole served int8 step's share of the card's peaks: per
image, the int8 plan's int8 operations over the int8 peak plus its float
convs' FLOPs over the bf16 peak (benchmark/flops/int8.py), times the
untraced window's images_per_s, in percent. Its time is all of a request's
(H2D copy, quantize passes, int8 and float convs, decode, NMS, D2H copy),
so it bounds what any one kernel's share can claim. Nothing where the
run counted no int8 work (`kinds/serve_int8.py` counts it)."""

from benchmark.flops import peaks
from benchmark.flops.int8 import INT8_OPS


def read(rec):
    work = rec.get("int8_work")
    if not work or not rec.get("window_s"):
        return None
    busy = work["int8_ops"] / INT8_OPS + work["float_flops"] / peaks.BF16_FLOPS
    return busy * rec["images"] / rec["window_s"] * 100.0
