"""forward_mfu.serve: the forward's own share of the card's bf16 peak: the
fused forward's FLOPs (benchmark/flops/model.py) of the images in the
profiled slice over the device time of the kernels launched inside the
benchmark's `bench.predict` range (the forward and the decode; the H2D copy
is left out), in percent. Nothing when the split of `Inferer._run` into
predict + NMS did not reproduce `_run`'s outputs at set-up."""

from benchmark.flops import peaks


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("split_ok"):
        return None
    t = tr.get("range_kernels", {}).get("bench.predict", 0.0)
    if t <= 0:
        return None
    return rec["flops_per_image"] * rec["batch"] * tr["iters"] / t / peaks.BF16_FLOPS * 100.0
