"""greedy_nms_roofline.serve: the least time the H100 could take for one
greedy-NMS launch's work (operations over the fp32 peak or bytes over HBM
bandwidth, whichever is larger; benchmark/flops/nms.py counts them on the
reference's keep masks of the same inputs) over the kernel's mean device
time per launch, in percent."""

from benchmark.flops import peaks


def read(rec):
    tr, work = rec.get("trace"), rec.get("nms_work")
    if not tr or not work:
        return None
    launches = [d for k, v in tr["kernels"].items() if "greedy_nms_kernel" in k for d in v]
    if not launches:
        return None
    bound = max(work["ops"] / peaks.FP32_FLOPS, work["bytes"] / peaks.HBM_BYTES)
    return bound / (sum(launches) / len(launches)) * 100.0
