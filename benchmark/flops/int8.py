"""Work of one batch of the int8 plan (reference/int8.py's `plan`): each
int8 conv launch's operations and bytes, the float convs' FLOPs left over,
and the elements quantized from float, from the configuration's layer shapes
on the meta device.

An int8 conv launch does 2 operations a multiply-add and moves, each once:
its input codes (1 byte an element), its weight codes (1 byte each) and
epilogue constants (a and b, 4 bytes each an output channel), and its output:
1 byte an element where it hands codes off, else the served float dtype
(`out_bytes`, 2 for bf16). A deploy RepBlock chain is one launch a link. The
float convs (the skipped stem, the transposed convs) count 2 FLOPs a
multiply-add, as flops/model.py counts them; the decode's elementwise work
is not counted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import int8 as ref_int8
from benchmark.reference import model as ref

INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core operations a second (data sheet, 700 W)


class Count:
    def __init__(self, cfg, amax, out_bytes: int, skip=ref_int8.SKIP):
        self.amax, self.skip, self.out_bytes = amax, skip, out_bytes
        self.handoffs = ref_int8.plan(cfg, amax, skip)
        self.fed = set(self.handoffs.values())
        self.launches = []  # per image (ops, activation bytes, weight bytes)
        self.float_flops = 0
        self.quantized = 0

    def conv(self, prefix, x, cout, k, s=1):
        y = F.conv2d(x, torch.empty(cout, x.shape[1], k, k, device="meta"), None, s, k // 2)
        macs = y.numel() * x.shape[1] * k * k
        if not ref_int8.int8_unit(prefix, self.amax, self.skip):
            self.float_flops += 2 * macs
            return y
        if prefix not in self.fed:
            self.quantized += x.numel()
        out = y.numel() * (1 if prefix in self.handoffs else self.out_bytes)
        self.launches.append((2 * macs, x.numel() + out, cout * x.shape[1] * k * k + 8 * cout))
        return y

    def convt(self, prefix, x, cout):
        y = F.conv_transpose2d(x, torch.empty(x.shape[1], cout, 2, 2, device="meta"), None,
                               stride=2)
        self.float_flops += 2 * x.numel() * cout * 4
        return y

    def alpha(self, prefix):
        return 1.0


def int8_work(cfg, amax, height: int, width: int, batch: int, out_bytes: int = 2) -> dict:
    """The plan's work on a batch of `batch` (height, width) images:
    `launches`, each int8 conv launch's (operations, bytes); per image
    `int8_ops`, `float_flops` and `quantized` (elements quantized from
    float); `convs`, the int8 conv launches a batch."""
    P = Count(cfg, amax, out_bytes)
    mc = cfg["model"]
    x = torch.empty(1, 3, height, width, device="meta")
    ref.head_maps(P, ref.neck(P, ref.backbone(P, x, mc), mc), mc, ref.ncls_of(cfg))
    launches = [(ops * batch, act * batch + w) for ops, act, w in P.launches]
    return dict(launches=launches, int8_ops=sum(ops for ops, _, _ in P.launches),
                float_flops=P.float_flops, quantized=P.quantized, convs=len(launches))


def launch_bound_s(launches) -> float:
    """The least time the H100 could take for `launches`: per launch the
    larger of operations over the int8 peak and bytes over HBM bandwidth,
    summed."""
    from benchmark.flops import peaks

    return sum(max(ops / INT8_OPS, nbytes / peaks.HBM_BYTES) for ops, nbytes in launches)
