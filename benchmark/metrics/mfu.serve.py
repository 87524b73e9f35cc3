"""mfu.serve: the whole served step's share of the card's bf16 peak: the
fused forward's FLOPs an image (benchmark/flops/model.py) times the
untraced window's images_per_s, over the peak, in percent. Its time is all
of a request's (H2D copy, forward, decode, NMS, D2H copy), so it bounds
what any one kernel's share can claim."""

from benchmark.flops import peaks


def read(rec):
    if not rec.get("window_s"):
        return None
    return rec["flops_per_image"] * rec["images"] / rec["window_s"] / peaks.BF16_FLOPS * 100.0
