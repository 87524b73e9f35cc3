"""LP Efficient Decoupled Head in NCHW, eval decode only (mirrors
yololp_tpu/models/effidehead.py).

Per level: a 1x1 stem, a 3x3 cls conv feeding ONE fused 1x1 classification
pred with npro+nalp+6*nads channels ('cls_pred{i}'), and a 3x3 reg conv
feeding one fused box+corner pred ('reg_pred{i}'). Pred kernels start at
zero with the prior-prob cls bias and a reg bias of 1.0.

The eval output is the 290-column tensor
[bbox_xywh(4), obj(=1), corners(8), pro(31), alp(24), ads(6*37)] per anchor.
Maps are permuted to NHWC before flattening, so anchors run H-then-W as in
the JAX head and ops/anchors.py; the sigmoid and the decode run in fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from yololp_tpu_torch.layers.blocks import ConvBNAct
from yololp_tpu_torch.ops.anchors import anchor_points_from_shapes
from yololp_tpu_torch.ops.geometry import dist2bbox, dist2cor

PRIOR_PROB = 1e-2


class Detect(nn.Module):
    """Anchor-free LP detection head over 3 FPN levels (eval decode)."""

    def __init__(self, in_channels: Sequence[int], npro: int = 31, nalp: int = 24,
                 nads: int = 37, num_layers: int = 3, use_dfl: bool = True,
                 reg_max: int = 16, deploy: bool = False,
                 grid_cell_offset: float = 0.5):
        super().__init__()
        if num_layers != 3:
            raise NotImplementedError("only the 3-level (P3-P5) head is ported")
        self.npro, self.nalp, self.nads = npro, nalp, nads
        self.ncls = npro + nalp + 6 * nads
        self.use_dfl, self.reg_max = use_dfl, reg_max
        self.nreg = 4 * (reg_max + 1)
        self.strides = (8, 16, 32)
        self.grid_cell_offset = grid_cell_offset
        for i, c in enumerate(in_channels):
            self.add_module(f"stem{i}", ConvBNAct(c, c, 1, 1, act="silu", deploy=deploy))
            self.add_module(f"cls_conv{i}", ConvBNAct(c, c, 3, 1, act="silu", deploy=deploy))
            self.add_module(f"reg_conv{i}", ConvBNAct(c, c, 3, 1, act="silu", deploy=deploy))
            self.add_module(f"cls_pred{i}", nn.Conv2d(c, self.ncls, 1, bias=True))
            self.add_module(f"reg_pred{i}", nn.Conv2d(c, self.nreg + 8, 1, bias=True))
        self.num_layers = len(in_channels)

    @torch.no_grad()
    def reset_pred_parameters(self):
        """Zero pred kernels, prior-prob cls bias, reg/cor bias 1.0."""
        for i in range(self.num_layers):
            cls_pred, reg_pred = getattr(self, f"cls_pred{i}"), getattr(self, f"reg_pred{i}")
            cls_pred.weight.zero_()
            cls_pred.bias.fill_(-math.log((1 - PRIOR_PROB) / PRIOR_PROB))
            reg_pred.weight.zero_()
            reg_pred.bias.fill_(1.0)

    def forward(self, xs):
        if self.training:
            raise NotImplementedError(
                "the train-mode head output is not ported yet; call .eval()")
        cls_flat, reg_flat, cor_flat = [], [], []
        for i, x in enumerate(xs):
            stem = getattr(self, f"stem{i}")(x)
            cls_out = getattr(self, f"cls_pred{i}")(getattr(self, f"cls_conv{i}")(stem))
            regcor = getattr(self, f"reg_pred{i}")(getattr(self, f"reg_conv{i}")(stem))
            b = x.shape[0]
            cls_flat.append(cls_out.permute(0, 2, 3, 1).reshape(b, -1, self.ncls))
            regcor = regcor.permute(0, 2, 3, 1).reshape(b, -1, self.nreg + 8)
            reg_flat.append(regcor[..., :self.nreg])
            cor_flat.append(regcor[..., self.nreg:])

        cls_scores = torch.sigmoid(torch.cat(cls_flat, 1).float())
        reg_distri = torch.cat(reg_flat, 1).float()
        cor_distri = torch.cat(cor_flat, 1).float()

        shapes = [(x.shape[2], x.shape[3]) for x in xs]
        anchor_points, stride_tensor = anchor_points_from_shapes(
            shapes, self.strides, self.grid_cell_offset, device=cls_scores.device)

        if self.use_dfl:
            b, a, _ = reg_distri.shape
            dist = torch.softmax(reg_distri.reshape(b, a, 4, self.reg_max + 1), dim=-1)
            proj = torch.arange(self.reg_max + 1, dtype=torch.float32,
                                device=dist.device)
            reg_dist = torch.einsum("bakr,r->bak", dist, proj)
        else:
            reg_dist = reg_distri

        pred_bboxes = dist2bbox(reg_dist, anchor_points, box_format="xywh") * stride_tensor
        pred_corners = dist2cor(cor_distri, anchor_points) * stride_tensor
        obj = torch.ones_like(pred_bboxes[..., :1])
        return torch.cat([pred_bboxes, obj, pred_corners, cls_scores], -1)
