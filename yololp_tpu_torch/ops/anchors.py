"""Anchor points for the anchor-free LP head, eval and train (mirrors
yololp_tpu/ops/anchors.py)."""

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


def feat_sizes(img_size, strides):
    """Per-level (h, w) grids for an (H, W) input."""
    h, w = img_size
    return [(h // s, w // s) for s in strides]


def anchor_points_eval(img_size, strides, grid_cell_offset: float = 0.5, device="cpu"):
    """Eval-mode anchors of an (H, W) input: anchor_points_from_shapes over
    its feat_sizes."""
    return anchor_points_from_shapes(feat_sizes(img_size, strides), strides, grid_cell_offset,
                                     device=device)


def anchors_train(img_size, strides, grid_cell_size: float = 5.0,
                  grid_cell_offset: float = 0.5, device="cpu"):
    """Train-mode anchors in image pixels, built on `device`: (anchors (A, 4)
    grid-cell boxes xyxy, anchor_points (A, 2), per-level anchor counts,
    stride_tensor (A, 1)), float32, levels in order and each level row-major."""
    cell_boxes, points, n_list, strides_out = [], [], [], []
    for (h, w), stride in zip(feat_sizes(img_size, strides), strides):
        half = grid_cell_size * stride * 0.5
        sx = (torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset) * stride
        sy = (torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset) * stride
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        cell_boxes.append(torch.stack([gx - half, gy - half, gx + half, gy + half], -1).reshape(-1, 4))
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        n_list.append(h * w)
        strides_out.append(torch.full((h * w, 1), float(stride), dtype=torch.float32,
                                      device=device))
    return torch.cat(cell_boxes), torch.cat(points), n_list, torch.cat(strides_out)
