"""Anchor points for the anchor-free LP head (mirrors
yololp_tpu/ops/anchors.py:17-49)."""

from __future__ import annotations

import torch


def anchor_points_from_shapes(shapes, strides, grid_cell_offset: float = 0.5,
                              device="cpu"):
    """Grid-cell centres in grid units plus the per-anchor stride.

    Per level the points run row-major, H then W, which is the order in
    which the head flattens its NHWC-permuted maps. Returns
    (anchor_points (A, 2), stride_tensor (A, 1)), float32.
    """
    points, strides_out = [], []
    for (h, w), stride in zip(shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        strides_out.append(torch.full((h * w, 1), float(stride), dtype=torch.float32,
                                      device=device))
    return torch.cat(points), torch.cat(strides_out)
