"""nms_ms.serve: device time per batch of the kernels launched inside the
benchmark's `bench.nms` range around `non_max_suppression` (gate, top-K,
keep-mask, compaction). Nothing when the split of `Inferer._run` into
predict + NMS did not reproduce `_run`'s outputs at set-up."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("split_ok") or "bench.nms" not in tr["ranges"]:
        return None
    return tr["ranges"]["bench.nms"] / tr["iters"] * 1e3
