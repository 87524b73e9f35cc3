"""Box / corner coordinate codecs and pairwise IoU (mirrors
yololp_tpu/ops/geometry.py:21-100).

Shape-polymorphic over leading batch dims. The operation order of each
formula follows the JAX functions so that fp32 results agree to the bit.
"""

from __future__ import annotations

import torch


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) over the last axis."""
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)


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
