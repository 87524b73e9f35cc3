"""Visualization helpers: labeled-sample drawing + train/val image grids.

Behavioral reference: yolov6/data/show.py (box + corner quad + plate string
overlay) and the trainer's TensorBoard image pushes (engine.py:449-535:
train-batch mosaic grid, val predictions with decoded strings).

Copied from yololp_tpu/utils/visualize.py (the port imports nothing of the
JAX package); cv2 is imported inside the functions that use it.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from yololp_tpu_torch.data import vocab as V
from yololp_tpu_torch.data.glyphs import blit_text


def _put_text(img_bgr, text, xy, color=(255, 0, 0)):
    # RGB color arg kept for call-site compat; blit_text takes BGR
    return blit_text(img_bgr, text, xy, color=color[::-1], size=20)


def draw_labels(img_bgr: np.ndarray, labels: np.ndarray,
                pixel_coords: bool = False) -> np.ndarray:
    """Draw gt rows [cls(8), cxcywh, corners] (normalized unless
    pixel_coords) — show.py:22 semantics."""
    import cv2

    out = img_bgr.copy()
    h, w = out.shape[:2]
    for row in labels:
        if row[:8].min() < 0 and row[8:].sum() == 0:
            continue
        cx, cy, bw, bh = row[8:12] if pixel_coords else (
            row[8] * w, row[9] * h, row[10] * w, row[11] * h)
        x1, y1 = int(cx - bw / 2), int(cy - bh / 2)
        x2, y2 = int(cx + bw / 2), int(cy + bh / 2)
        cv2.rectangle(out, (x1, y1), (x2, y2), (255, 255, 255), 2)
        cors = row[12:20] if pixel_coords else row[12:20] * np.array(
            [w, h] * 4)
        quad = cors.reshape(4, 2).astype(int)
        for i in range(4):
            cv2.line(out, tuple(quad[i]), tuple(quad[(i + 1) % 4]),
                     (0, 255, 255), 2)
        text = V.plate_string(row[0], row[1], row[2:8])
        out = _put_text(out, text, (x1, max(y1 - 22, 0)))
    return out


def draw_detections(img_bgr: np.ndarray, dets: np.ndarray) -> np.ndarray:
    """Draw 28-col detections (xyxy, corners, confs, preds)."""
    import cv2

    out = img_bgr.copy()
    for d in dets:
        x1, y1, x2, y2 = d[:4].astype(int)
        cv2.rectangle(out, (x1, y1), (x2, y2), (255, 255, 255), 2)
        quad = d[4:12].reshape(4, 2).astype(int)
        for i in range(4):
            cv2.line(out, tuple(quad[i]), tuple(quad[(i + 1) % 4]),
                     (0, 255, 255), 2)
        conf = float(d[12:20].mean())
        ids = d[20:28].astype(int)
        out = _put_text(out, f"{V.plate_string(ids[0], ids[1], ids[2:8])} "
                             f"{conf:.2f}", (x1, max(y1 - 22, 0)))
    return out


def image_grid(images: Sequence[np.ndarray], cols: int = 4,
               cell: int = 320) -> np.ndarray:
    """Tile BGR images into a grid (the TB train-batch mosaic equivalent)."""
    import cv2

    n = len(images)
    rows = -(-n // cols)
    grid = np.full((rows * cell, cols * cell, 3), 114, np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        scaled = cv2.resize(img, (cell, cell))
        grid[r * cell:(r + 1) * cell, c * cell:(c + 1) * cell] = scaled
    return grid


def save_train_batch_vis(images_rgb: np.ndarray, labels: np.ndarray,
                         masks: np.ndarray, path: str, max_imgs: int = 8):
    """Annotate + grid a padded train batch (engine.py write_tbimg 'train')."""
    import cv2

    drawn = []
    for i in range(min(len(images_rgb), max_imgs)):
        bgr = cv2.cvtColor(images_rgb[i], cv2.COLOR_RGB2BGR)
        drawn.append(draw_labels(bgr, labels[i][masks[i] > 0]))
    grid = image_grid(drawn)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, grid)
    return grid
