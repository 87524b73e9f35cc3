"""Conv FLOPs of one image's fused deploy forward, from the configuration's
layer shapes: the reference forward (reference/model.py) walked on the meta
device with a provider that counts 2 FLOPs a multiply-add of every conv and
transposed conv and computes nothing. The decode's elementwise work (and
DFL's 17-term expectation) is not counted."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref


class Count:
    def __init__(self):
        self.flops = 0

    def conv(self, prefix, x, cout, k, s=1):
        y = F.conv2d(x, torch.empty(cout, x.shape[1], k, k, device="meta"), None, s, k // 2)
        self.flops += 2 * y.numel() * x.shape[1] * k * k
        return y

    def convt(self, prefix, x, cout):
        y = F.conv_transpose2d(x, torch.empty(x.shape[1], cout, 2, 2, device="meta"), None, stride=2)
        self.flops += 2 * x.numel() * cout * 4
        return y

    def alpha(self, prefix):
        return 1.0


def forward_flops(cfg, height: int, width: int) -> int:
    """FLOPs of one (height, width) image through the fused forward."""
    P = Count()
    mc = cfg["model"]
    x = torch.empty(1, 3, height, width, device="meta")
    ref.head_maps(P, ref.neck(P, ref.backbone(P, x, mc), mc), mc, ref.ncls_of(cfg))
    return P.flops
