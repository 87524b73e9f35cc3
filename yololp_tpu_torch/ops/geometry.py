"""Box / corner coordinate codecs, pairwise IoU and the IoU loss family
(mirrors yololp_tpu/ops/geometry.py).

Shape-polymorphic over leading batch dims. The operation order of each
formula follows the JAX functions so that fp32 results agree to the bit.
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) over the last axis."""
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)


def xyxy2xywh(b: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) over the last axis."""
    x1, y1, x2, y2 = b.split(1, dim=-1)
    return torch.cat([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              box_format: str = "xyxy") -> torch.Tensor:
    """Decode (l, t, r, b) distances around anchor points into boxes."""
    lt, rb = distance.split(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if box_format == "xyxy":
        return torch.cat([x1y1, x2y2], -1)
    if box_format == "xywh":
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], -1)
    raise ValueError(f"unknown box_format {box_format!r}")


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max) -> torch.Tensor:
    """Encode xyxy boxes as (l, t, r, b) distances clipped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.split(2, dim=-1)
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1)
    return dist.clamp(0, reg_max - 0.01)


def dist2cor(distance: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """Decode 8 signed corner offsets into the 4 plate-corner quad:
    TL = a - lt; BL = (ax - lb.x, ay + lb.y); BR = a + rb; TR = (ax + rt.x, ay - rt.y)."""
    lt, lb, rb, rt = distance.split(2, dim=-1)
    ax, ay = anchor_points.split(1, dim=-1)
    x2, y2 = lb.split(1, dim=-1)
    x4, y4 = rt.split(1, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = torch.cat([ax - x2, ay + y2], -1)
    x3y3 = anchor_points + rb
    x4y4 = torch.cat([ax + x4, ay - y4], -1)
    return torch.cat([x1y1, x2y2, x3y3, x4y4], -1)


def cor2dist(anchor_points: torch.Tensor, corner: torch.Tensor, reg_max) -> torch.Tensor:
    """Inverse of dist2cor, clipped to [0, reg_max - 0.01]."""
    c1, c2, c3, c4 = corner.split(2, dim=-1)
    ax, ay = anchor_points.split(1, dim=-1)
    x2, y2 = c2.split(1, dim=-1)
    x4, y4 = c4.split(1, dim=-1)
    lt = anchor_points - c1
    lb = torch.cat([ax - x2, y2 - ay], -1)
    rb = c3 - anchor_points
    rt = torch.cat([x4 - ax, ay - y4], -1)
    return torch.cat([lt, lb, rb, rt], -1).clamp(0, reg_max - 0.01)


def pairwise_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """IoU between every box of box1 (..., M, 4) and box2 (..., N, 4), xyxy.

    Returns (..., M, N). Widths, heights and areas are clipped at 0, and eps
    is added to the union: overlap / (area1 + area2 - overlap + eps).
    """
    b1 = box1[..., :, None, :]
    b2 = box2[..., None, :, :]
    x1y1 = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    x2y2 = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    overlap = (x2y2 - x1y1).clamp(min=0).prod(-1)
    area1 = (b1[..., 2:4] - b1[..., 0:2]).clamp(min=0).prod(-1)
    area2 = (b2[..., 2:4] - b2[..., 0:2]).clamp(min=0).prod(-1)
    return overlap / (area1 + area2 - overlap + eps)


def pairwise_iou_mmdet(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """IoU with mmdet's bbox_overlaps numerics: plain (unclipped) areas, and
    eps applied as a floor of the union rather than added."""
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:], box2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / union.clamp(min=eps)


def iou_loss(box1: torch.Tensor, box2: torch.Tensor, iou_type: str = "giou",
             box_format: str = "xyxy", eps: float = 1e-10) -> torch.Tensor:
    """Elementwise IoU loss 1 - IoU* between aligned boxes (last dim 4), for
    iou_type iou, giou, diou, ciou or siou. ciou's trade-off weight alpha
    carries no gradient (`.detach()`, the JAX stop_gradient)."""
    if box_format == "xywh":
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.split(1, dim=-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.split(1, dim=-1)

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    iou_type = iou_type.lower()
    if iou_type == "giou":
        c_area = cw * ch + eps
        iou = iou - (c_area - union) / c_area
    elif iou_type in ("diou", "ciou"):
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) * 0.25
        if iou_type == "diou":
            iou = iou - rho2 / c2
        else:
            v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            iou = iou - (rho2 / c2 + v * alpha)
    elif iou_type == "siou":
        s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5 + eps
        s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5 + eps
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2)
        sin_alpha_1 = s_cw.abs() / sigma
        sin_alpha_2 = s_ch.abs() / sigma
        threshold = 2 ** 0.5 / 2
        sin_alpha = torch.where(sin_alpha_1 > threshold, sin_alpha_2, sin_alpha_1)
        angle_cost = torch.cos(torch.asin(sin_alpha) * 2 - math.pi / 2)
        rho_x = (s_cw / cw) ** 2
        rho_y = (s_ch / ch) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        iou = iou - 0.5 * (distance_cost + shape_cost)
    elif iou_type != "iou":
        raise ValueError(f"unknown iou_type {iou_type!r}")
    return 1.0 - iou
