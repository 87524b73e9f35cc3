"""Conv FLOPs of one image's fused deploy forward of a P6 configuration:
the P6 reference forward (reference/p6.py) walked on the meta device with
flops/model.py's `Count`, 2 FLOPs a multiply-add of every conv and
transposed conv. The decode's elementwise work (and DFL's 17-term
expectation) is not counted."""

from __future__ import annotations

import torch

from benchmark.flops.model import Count
from benchmark.reference import p6
from benchmark.reference.model import ncls_of


def forward_flops(cfg, height: int, width: int) -> int:
    """FLOPs of one (height, width) image through the fused forward."""
    P = Count()
    mc = p6.model_of(cfg)
    x = torch.empty(1, 3, height, width, device="meta")
    p6.head_maps(P, p6.neck(P, p6.backbone(P, x, mc), mc), mc, ncls_of(cfg))
    return P.flops
