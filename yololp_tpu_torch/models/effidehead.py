"""LP Efficient Decoupled Head in NCHW: the eval decode and the train output
(mirrors yololp_tpu/models/effidehead.py).

Per level: a 1x1 stem, a 3x3 cls conv feeding ONE fused 1x1 classification
pred with npro+nalp+6*nads channels ('cls_pred{i}'), and a 3x3 reg conv
feeding one fused box+corner pred ('reg_pred{i}'). Pred kernels start at
zero with the prior-prob cls bias and a reg bias of 1.0.

The eval output is the 290-column tensor
[bbox_xywh(4), obj(=1), corners(8), pro(31), alp(24), ads(6*37)] per anchor.
In training mode the head returns `HeadTrainOutput` instead. Maps are
permuted to NHWC before flattening, so anchors run H-then-W as in the JAX
head and ops/anchors.py; the sigmoid and the decode run in fp32. The
stride-64 level of a 4-level head is the span `model.head.p6`, and each
decode adds B x A to the counter `decode.anchors` (utils/profiler.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Sequence

import torch
from torch import nn

from yololp_tpu_torch.layers.blocks import ConvBNAct, conv_act
from yololp_tpu_torch.ops.anchors import anchor_points_from_shapes
from yololp_tpu_torch.ops.cuda_bias_act import NONE
from yololp_tpu_torch.ops.geometry import dist2bbox, dist2cor
from yololp_tpu_torch.utils import profiler
from yololp_tpu_torch.utils.profiler import annotate

PRIOR_PROB = 1e-2


class HeadTrainOutput(NamedTuple):
    """The head's train output (the JAX package's HeadTrainOutput). `feats`
    are the per-level stem outputs, NCHW here (the JAX ones are NHWC)."""

    feats: List[torch.Tensor]  # per level (B, C, H, W)
    pro: torch.Tensor          # (B, A, npro) sigmoided, fp32
    alp: torch.Tensor          # (B, A, nalp) sigmoided, fp32
    ads: torch.Tensor          # (B, A, 6, nads) sigmoided, fp32
    reg: torch.Tensor          # (B, A, 4 * (reg_max + 1)) raw, fp32
    cor: torch.Tensor          # (B, A, 8) raw corner offsets, fp32


class Detect(nn.Module):
    """Anchor-free LP detection head over 3 FPN levels (strides 8-32) or 4
    (8-64, the P6 models): the eval decode, or in training mode the
    HeadTrainOutput."""

    def __init__(self, in_channels: Sequence[int], npro: int = 31, nalp: int = 24,
                 nads: int = 37, num_layers: int = 3, use_dfl: bool = True,
                 reg_max: int = 16, deploy: bool = False,
                 grid_cell_offset: float = 0.5):
        super().__init__()
        if num_layers not in (3, 4) or len(in_channels) != num_layers:
            raise ValueError(f"a head of {num_layers} levels on {len(in_channels)} maps")
        self.npro, self.nalp, self.nads = npro, nalp, nads
        self.ncls = npro + nalp + 6 * nads
        self.use_dfl, self.reg_max = use_dfl, reg_max
        self.nreg = 4 * (reg_max + 1)
        self.strides = (8, 16, 32) if num_layers == 3 else (8, 16, 32, 64)
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

    def pred_maps(self, xs):
        """Per level, the stem's output and the pred maps (cls, reg+cor), NCHW
        at the level's resolution: the head's every op that mixes rows."""
        feats, maps = [], []
        for i, x in enumerate(xs):
            # level 3 is the P6 heads' stride-64 level
            with annotate("model.head.p6", x.device) if i == 3 else contextlib.nullcontext():
                stem = getattr(self, f"stem{i}")(x)
                maps.append((conv_act(getattr(self, f"cls_pred{i}"),
                                      getattr(self, f"cls_conv{i}")(stem), NONE),
                             conv_act(getattr(self, f"reg_pred{i}"),
                                      getattr(self, f"reg_conv{i}")(stem), NONE)))
            feats.append(stem)
        return feats, maps

    def forward(self, xs):
        dev = xs[0].device
        with annotate("model.head", dev):
            feats, maps = self.pred_maps(xs)
        with annotate("model.decode", dev):
            return self.decode(maps, feats)

    def decode(self, maps, feats=None):
        """Flatten `pred_maps`'s maps H then W, level after level, and decode
        them; in training mode, the HeadTrainOutput with `feats`. The anchors
        come from the maps' shapes, so the maps must be whole: a band of rows
        never decodes its own (parallel/spatial.py gathers them first)."""
        cls_flat, reg_flat, cor_flat = [], [], []
        for cls_out, regcor in maps:
            b = cls_out.shape[0]
            cls_flat.append(cls_out.permute(0, 2, 3, 1).reshape(b, -1, self.ncls))
            regcor = regcor.permute(0, 2, 3, 1).reshape(b, -1, self.nreg + 8)
            reg_flat.append(regcor[..., :self.nreg])
            cor_flat.append(regcor[..., self.nreg:])

        wide = torch.promote_types(cls_flat[0].dtype, torch.float32)  # fp32; float64 stays
        cls_scores = torch.sigmoid(torch.cat(cls_flat, 1).to(wide))
        if profiler.recording():
            profiler.count("decode.anchors", cls_scores.shape[0] * cls_scores.shape[1])
        reg_distri = torch.cat(reg_flat, 1).to(wide)
        cor_distri = torch.cat(cor_flat, 1).to(wide)
        if self.training:
            b, a = cls_scores.shape[:2]
            npa = self.npro + self.nalp
            return HeadTrainOutput(feats, cls_scores[..., :self.npro],
                                   cls_scores[..., self.npro:npa],
                                   cls_scores[..., npa:].reshape(b, a, 6, self.nads),
                                   reg_distri, cor_distri)

        shapes = [(c.shape[2], c.shape[3]) for c, _ in maps]
        anchor_points, stride_tensor = anchor_points_from_shapes(
            shapes, self.strides, self.grid_cell_offset, device=cls_scores.device)

        if self.use_dfl:
            b, a, _ = reg_distri.shape
            dist = torch.softmax(reg_distri.reshape(b, a, 4, self.reg_max + 1), dim=-1)
            proj = torch.arange(self.reg_max + 1, dtype=dist.dtype, device=dist.device)
            reg_dist = torch.einsum("bakr,r->bak", dist, proj)
        else:
            reg_dist = reg_distri

        pred_bboxes = dist2bbox(reg_dist, anchor_points, box_format="xywh") * stride_tensor
        pred_corners = dist2cor(cor_distri, anchor_points) * stride_tensor
        obj = torch.ones_like(pred_bboxes[..., :1])
        return torch.cat([pred_bboxes, obj, pred_corners, cls_scores], -1)
